"""Local bundle adjustment: batched LM with an explicit Schur complement
(port of vslam_tpu/ops/schur.py, the single-device paths).

The reference's GTSAM local BA (src/OptimizationBA.cpp:426-940) as dense
blocked linear algebra: projection residuals per observation row, a
sequential-KF odometry chain (sigma 0.01), landmark 3x3 blocks eliminated
in closed form, the reduced (6W x 6W) camera system solved by Cholesky,
landmarks back-substituted. Fixed shapes: W pose slots, L landmark slots,
O observation rows, all masked.

Differences from the JAX version, none of which changes the math:
- the observation Jacobians are the analytic 3x6 / 3x3 forms (what
  ``jax.jacfwd`` computes at schur.py:102-110), including the zero
  derivative of the +-512 px clip and of the ``max(z, 0.05)`` clamp; the
  19 odometry links keep forward-mode AD (``torch.func.jvp``);
- the Hessian blocks are summed with ``index_put_(accumulate=True)``
  under deterministic algorithms: on CUDA that is a sorted segment sum in
  row order, not atomics, so a solve is bit-reproducible on the card;
- a failed Cholesky (``info != 0``) yields a NaN step, as JAX's
  ``cho_factor`` does, and the LM rejects it instead of raising;
- ``lax.while_loop`` is a host loop that reads the done flag every
  ``_DONE_CHECK_EVERY`` iterations; the state is frozen once done, so the
  stop iteration does not depend on that interval;
- the slab loops of the chunked reduction (``n_slabs > 1``, global BA)
  are Python loops in slab order, so the reduced system is summed in one
  fixed order; the rows are sorted by landmark once per solve and each
  slab scatters only its own (a segment's rows are summed one after
  another, so rows dropped into one spare row, as JAX's mode="drop"
  does, would make one serial chain of most of the rows).

Sharded (``mesh``, a :class:`vslam_torch.parallel.mesh.Mesh`; JAX's
``axis_name`` inside ``shard_map``): one controller drives every shard.
Each shard linearizes its own slice of the observation rows on its device
and scatters full-width landmark blocks from them; the mesh's collectives
(explicit reductions in vslam_torch/parallel/mesh.py) reduce-scatter those
into per-shard landmark slabs and sum the pose blocks, the reduced system
and the error; the landmark steps are gathered. The reduced (6W)^2 solve
and the LM control run once, on the mesh's first device (replicated in
JAX, which is the same thing). The JAX package's staged
``local_ba_round1``/``round2`` are not needed: the async mapper runs both
rounds on its worker thread.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from vslam_torch.geometry import se3

CHI2_THR = 7.815  # reference include/OptimizationBA.h:44
ODOMETRY_SIGMA = 0.01  # reference src/OptimizationBA.cpp:751
_DONE_CHECK_EVERY = 1  # LM iterations between host reads of the done flag


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (W, 4, 4) cam-to-world
    fixed: torch.Tensor  # (W,) bool gauge-fixed KFs
    pose_valid: torch.Tensor  # (W,) bool
    pts: torch.Tensor  # (L, 3)
    pt_valid: torch.Tensor  # (L,) bool
    obs_kf: torch.Tensor  # (O,) int64 -> pose slot
    obs_lm: torch.Tensor  # (O,) int64 -> landmark slot
    obs_uv: torch.Tensor  # (O, 3) [u_l, v_l, u_r] ([u_r, v_r, -] when right)
    obs_stereo: torch.Tensor  # (O,) bool has a right-x row
    obs_right: torch.Tensor  # (O,) bool right-camera-only projection
    obs_w: torch.Tensor  # (O,) sqrt information
    obs_valid: torch.Tensor  # (O,) bool
    K: torch.Tensor  # (3, 3)
    baseline: torch.Tensor  # ()
    odo_rel: torch.Tensor  # (W-1, 4, 4) measured T_i^-1 T_{i+1}
    odo_valid: torch.Tensor  # (W-1,) bool


# The deterministic-algorithms flag is process-wide, and the async mapper
# solves on a worker thread while the tracker runs: the flag is switched on
# by the first thread to enter and restored by the last to leave. Meanwhile
# the other thread runs under it too, which changes no result; warn_only
# keeps an op without a deterministic version there from raising.
_DET_LOCK = threading.Lock()
_det_users = 0
_det_prev = (False, False)


@contextlib.contextmanager
def _deterministic():
    global _det_users, _det_prev
    with _DET_LOCK:
        if _det_users == 0:
            _det_prev = (
                torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
            )
            prev, warn = _det_prev
            torch.use_deterministic_algorithms(True, warn_only=warn if prev else True)
        _det_users += 1
    try:
        yield
    finally:
        with _DET_LOCK:
            _det_users -= 1
            if _det_users == 0:
                torch.use_deterministic_algorithms(_det_prev[0], warn_only=_det_prev[1])


def _scatter_add(out: torch.Tensor, index: tuple, values: torch.Tensor) -> torch.Tensor:
    """out[index] += values, duplicates summed in row order on every device."""
    with _deterministic():
        return out.index_put_(index, values, accumulate=True)


def _project_residual(T_cw, pt, uv, is_stereo, is_right, K, baseline, with_jac):
    """Batched over O rows: T_cw (O,4,4) world->camera, pt (O,3). Returns
    the (O,3) residual [du, dv, du_r] (left projection + right-x row when
    stereo, or the right-camera projection when is_right), clipped to
    +-512 px (behind-camera rows cost, see vslam_tpu/ops/schur.py:74-80),
    and with_jac: (O,3,6) d/d pose tangent of T_wc * exp(xi) and (O,3,3)
    d/d point."""
    R = T_cw[:, :3, :3]
    pc = (R @ pt[..., None])[..., 0] + T_cw[:, :3, 3]
    x, y = pc[:, 0], pc[:, 1]
    z = torch.clamp(pc[:, 2], min=0.05)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u_l = fx * x / z + cx
    u_r = fx * (x - baseline) / z + cx
    r_u = torch.where(is_right, u_r, u_l) - uv[:, 0]
    r_v = fy * y / z + cy - uv[:, 1]
    r_ur = torch.where(is_stereo, u_r - uv[:, 2], 0.0)
    raw = torch.stack([r_u, r_v, r_ur], dim=-1)
    r = torch.clamp(raw, -512.0, 512.0)
    if not with_jac:
        return r, None, None

    def rows(dpc):  # (O, 3, n) camera-point derivative -> (O, 3, n) residual rows
        dx, dy = dpc[:, 0], dpc[:, 1]
        dz = dpc[:, 2] * (pc[:, 2] > 0.05)[:, None]
        zc, zz = z[:, None], (z * z)[:, None]
        du_l = fx * dx / zc - (fx * x)[:, None] * dz / zz
        du_r = fx * dx / zc - (fx * (x - baseline))[:, None] * dz / zz
        dv = fy * dy / zc - (fy * y)[:, None] * dz / zz
        J = torch.stack(
            [
                torch.where(is_right[:, None], du_r, du_l),
                dv,
                torch.where(is_stereo[:, None], du_r, 0.0),
            ],
            dim=1,
        )
        inside = (raw > -512.0) & (raw < 512.0)  # the clip's derivative
        return J * inside[..., None]

    # T_cw' = exp(-xi) T_cw: d pc / d xi = [hat(pc) | -I]; d pc / d pt = R
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    Jp = rows(torch.cat([se3.hat(pc), -eye], dim=-1))
    Jl = rows(R)
    return r, Jp, Jl


def _obs_residual_and_jacobians(p: BAProblem, with_jac: bool = True):
    """Residuals (O,3) and Jacobians (O,3,6) / (O,3,3), pre-weighted by
    obs_w and masked by obs_valid."""
    T_cw = se3.inverse(p.poses)[p.obs_kf]
    pt = p.pts[p.obs_lm]
    r, Jp, Jl = _project_residual(
        T_cw, pt, p.obs_uv, p.obs_stereo, p.obs_right, p.K, p.baseline, with_jac
    )
    w = torch.where(p.obs_valid, p.obs_w, 0.0)[:, None]
    if not with_jac:
        return r * w, None, None
    return r * w, Jp * w[..., None], Jl * w[..., None]


def _odometry_fn(Ti, Tj, rel, di, dj):
    return se3.se3_logmap(
        se3.inverse(rel) @ se3.inverse(se3.retract(Ti, di)) @ se3.retract(Tj, dj)
    )


def _odometry_residual_and_jacobians(p: BAProblem, with_jac: bool = True):
    """Between-factor chain r = log(rel^-1 T_i^-1 T_j) / sigma: (W-1,6)
    residuals and (W-1,6,6) J_i, J_j by forward-mode AD (six tangent
    directions as one batch)."""
    Ti, Tj, rel = p.poses[:-1], p.poses[1:], p.odo_rel
    n = Ti.shape[0]
    w = torch.where(p.odo_valid, 1.0 / ODOMETRY_SIGMA, 0.0)[:, None]
    z = torch.zeros((n, 6), dtype=Ti.dtype, device=Ti.device)
    if not with_jac:
        return _odometry_fn(Ti, Tj, rel, z, z) * w, None, None
    Ti6, Tj6, rel6 = (a.expand((6,) + a.shape) for a in (Ti, Tj, rel))
    z6 = torch.zeros((6, n, 6), dtype=Ti.dtype, device=Ti.device)
    basis = torch.eye(6, dtype=Ti.dtype, device=Ti.device)[:, None, :].repeat(1, n, 1)
    r6, ti = torch.func.jvp(lambda d: _odometry_fn(Ti6, Tj6, rel6, d, z6), (z6,), (basis,))
    _, tj = torch.func.jvp(lambda d: _odometry_fn(Ti6, Tj6, rel6, z6, d), (z6,), (basis,))
    Ji = ti.permute(1, 2, 0)  # (n, out, tangent direction)
    Jj = tj.permute(1, 2, 0)
    return r6[0] * w, Ji * w[..., None], Jj * w[..., None]


def _shards(p: BAProblem, mesh) -> list:
    """(global shard index, problem) per shard of this process: its slice
    of the observation rows (vslam_tpu/ops/schur.py:138-158), every tensor
    on the shard's device. The rows must divide evenly over the mesh."""
    O = p.obs_kf.shape[0]
    if O % mesh.size:
        raise ValueError(f"mesh size {mesh.size} must divide the {O} observation rows")
    n = O // mesh.size
    out = []
    for g, dev in mesh.local:
        rows = slice(g * n, (g + 1) * n)
        q = p._replace(
            obs_kf=p.obs_kf[rows], obs_lm=p.obs_lm[rows], obs_uv=p.obs_uv[rows],
            obs_stereo=p.obs_stereo[rows], obs_right=p.obs_right[rows],
            obs_w=p.obs_w[rows], obs_valid=p.obs_valid[rows],
        )
        out.append((g, BAProblem(*(t.to(dev) for t in q))))
    return out


def ba_error(p: BAProblem, mesh=None) -> torch.Tensor:
    """Total error 0.5 * (||r_obs||^2 + ||r_odo||^2); with a `mesh`, each
    shard sums its observation rows and one psum adds them (the LM's
    accept/reject then runs on the summed error)."""
    if mesh is None:
        r, _, _ = _obs_residual_and_jacobians(p, with_jac=False)
        err = torch.sum(r * r)
    else:
        parts = []
        for _, q in _shards(p, mesh):
            r, _, _ = _obs_residual_and_jacobians(q, with_jac=False)
            parts.append(torch.sum(r * r))
        err = mesh.psum(parts)
    ro, _, _ = _odometry_residual_and_jacobians(p, with_jac=False)
    return 0.5 * (err + torch.sum(ro * ro))


def _landmark_rows(r, Jp, Jl):
    """Per-row terms of the landmark blocks: Jl^T Jl, Jp^T Jl, Jl^T r."""
    return (
        torch.einsum("oik,oil->okl", Jl, Jl),
        torch.einsum("oik,oil->okl", Jp, Jl),
        torch.einsum("oik,oi->ok", Jl, r),
    )


class _Slab(NamedTuple):
    """Landmark slots [off, off + n) of a Schur reduction and the
    observation rows that reach them."""

    off: int
    n: int
    rows: torch.Tensor | None  # (O_s,) its rows in landmark order; None: every row
    kf: torch.Tensor  # (O_s,) their pose slots
    loc: torch.Tensor  # (O_s,) their landmarks, counted from off


def _slabs(p: BAProblem, n_slabs: int) -> list:
    """The problem's landmarks in `n_slabs` equal slabs. One slab takes
    every row as it stands. Several: the valid rows are sorted by landmark
    once (stable, so each block sums its rows in the same order as one
    slab does) and cut at the slab bounds on the host, so a slab scatters
    only its own rows; invalid rows carry zero weight and are left out."""
    L = p.pts.shape[0]
    if L % n_slabs:
        raise ValueError(f"n_slabs={n_slabs} must divide the {L} landmark slots")
    if n_slabs == 1:
        return [_Slab(0, L, None, p.obs_kf, p.obs_lm)]
    Lloc = L // n_slabs
    key = torch.where(p.obs_valid, p.obs_lm, L)
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(0, L + 1, Lloc, dtype=key.dtype, device=key.device)
    cuts = torch.searchsorted(key[order], bounds).tolist()
    slabs = []
    for i in range(n_slabs):
        rows = order[cuts[i] : cuts[i + 1]]
        slabs.append(_Slab(i * Lloc, Lloc, rows, p.obs_kf[rows], p.obs_lm[rows] - i * Lloc))
    return slabs


def _slab_system(p: BAProblem, rows, slab: _Slab):
    """Landmark blocks of one slab from `rows` (:func:`_landmark_rows`):
    Hll (n,3,3), Hpl (W,n,6,3), gl (n,3)."""
    W = p.poses.shape[0]
    HllR, HplR, glR = rows if slab.rows is None else (t[slab.rows] for t in rows)
    z = dict(dtype=glR.dtype, device=glR.device)
    Hll = _scatter_add(torch.zeros((slab.n, 3, 3), **z), (slab.loc,), HllR)
    Hpl = _scatter_add(torch.zeros((W, slab.n, 6, 3), **z), (slab.kf, slab.loc), HplR)
    gl = _scatter_add(torch.zeros((slab.n, 3), **z), (slab.loc,), glR)
    return Hll, Hpl, gl


def _add_odometry(p: BAProblem, Hpp, gp, free):
    """Fold the odometry chain into the pose blocks (reference
    src/OptimizationBA.cpp:750-768). Link indices are distinct within each
    add, so plain indexed adds are exact."""
    W = p.poses.shape[0]
    ro, Ji, Jj = _odometry_residual_and_jacobians(p)
    Ji = Ji * free[:-1][:, None, None]
    Jj = Jj * free[1:][:, None, None]
    i = torch.arange(W - 1, device=Hpp.device)
    j = i + 1
    Hpp[i, i] += torch.einsum("oik,oil->okl", Ji, Ji)
    Hpp[j, j] += torch.einsum("oik,oil->okl", Jj, Jj)
    Hpp[i, j] += torch.einsum("oik,oil->okl", Ji, Jj)
    Hpp[j, i] += torch.einsum("oik,oil->okl", Jj, Ji)
    gp[i] += torch.einsum("oik,oi->ok", Ji, ro)
    gp[j] += torch.einsum("oik,oi->ok", Jj, ro)
    return Hpp, gp


def _pose_rows(p: BAProblem, r, Jp):
    """The observation rows' share of the pose blocks: the diagonal blocks
    (W, 6, 6) (an observation touches only its own pose) and gp (W, 6)."""
    W = p.poses.shape[0]
    z = dict(dtype=r.dtype, device=r.device)
    diag = _scatter_add(torch.zeros((W, 6, 6), **z), (p.obs_kf,), torch.einsum("oik,oil->okl", Jp, Jp))
    gp = _scatter_add(torch.zeros((W, 6), **z), (p.obs_kf,), torch.einsum("oik,oi->ok", Jp, r))
    return diag, gp


def _pose_system(p: BAProblem, diag, gp, free):
    """Pose blocks Hpp (W,W,6,6) and gp (W,6) from the observation rows'
    share, the odometry chain added once."""
    W = p.poses.shape[0]
    Hpp = torch.zeros((W, W, 6, 6), dtype=diag.dtype, device=diag.device)
    a = torch.arange(W, device=diag.device)
    Hpp[a, a] = diag
    return _add_odometry(p, Hpp, gp, free)


def _linearize(p: BAProblem):
    """One LM step's linearization: the pose blocks (Hpp, gp) and the
    per-row landmark terms (:func:`_landmark_rows`)."""
    free = (~p.fixed) & p.pose_valid
    r, Jp, Jl = _obs_residual_and_jacobians(p)
    Jp = Jp * free[p.obs_kf][:, None, None]
    Hpp, gp = _pose_system(p, *_pose_rows(p, r, Jp), free)
    return Hpp, gp, _landmark_rows(r, Jp, Jl)


def _assemble(p: BAProblem):
    """The blocked normal equations (Hpp, Hll, Hpl, gp, gl)."""
    Hpp, gp, rows = _linearize(p)
    Hll, Hpl, gl = _slab_system(p, rows, _slabs(p, 1)[0])
    return Hpp, Hll, Hpl, gp, gl


def _damped_inv3(Hll, lam):
    """LM-damped, observedness-guarded batched 3x3 inverse of the landmark
    blocks; returns (Hll_inv, observed)."""
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    tr = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)
    Hll_d = Hll + lam * eye3[None] * torch.clamp(tr[:, None, None] / 3.0, min=1e-6)
    observed = tr > 1e-12
    Hll_d = torch.where(observed[:, None, None], Hll_d, eye3[None])
    return _inv3(Hll_d), observed


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        dim=-1,
    ).reshape(*A.shape[:-2], 3, 3)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    return co / det[..., None, None]


def _solve_reduced(p: BAProblem, Hpp, gp, S_red, b_red, lam):
    """Solve the damped reduced camera system S dp = -b with fixed poses
    frozen. A matrix that is not positive definite gives a NaN step."""
    W = p.poses.shape[0]
    dev = Hpp.device
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=dev)
    S = Hpp - S_red.reshape(W, 6, W, 6).permute(0, 2, 1, 3)
    b = gp - b_red
    free = (~p.fixed) & p.pose_valid
    a = torch.arange(W, device=dev)
    diagW = torch.diagonal(S[a, a], dim1=-2, dim2=-1).sum(-1)
    S[a, a] += lam * eye6[None] * torch.clamp(diagW / 6.0, min=1e-6)[:, None, None]
    fm = free[:, None] & free[None, :]
    S = torch.where(fm[:, :, None, None], S, 0.0)
    S[a, a] += torch.where(~free[:, None, None], eye6, 0.0)
    b = torch.where(free[:, None], b, 0.0)
    S_dense = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    # upper factor, as jax.scipy.linalg.cho_factor (lower=False)
    U, info = torch.linalg.cholesky_ex(S_dense, upper=True)
    x = torch.cholesky_solve(-b.reshape(-1, 1), U, upper=True).reshape(W, 6)
    return torch.where(info == 0, x, float("nan"))


def _back_substitute(Hll_inv, observed, Hpl, gl, delta_p, pt_valid):
    """Landmark steps dl = Hll^-1 (-gl - Hlp dp); 0 for unobserved or
    invalid landmarks."""
    rhs = -gl - torch.einsum("alij,ai->lj", Hpl, delta_p)
    delta_l = torch.einsum("ljk,lk->lj", Hll_inv, rhs)
    return torch.where((observed & pt_valid)[:, None], delta_l, 0.0)


def _reduce_slab(Hll, Hpl, gl, lam):
    """A slab's share of the reduced camera system, S_red = sum_l Hpl_l
    Hll_l^-1 Hpl_l^T as ONE (6W, 3L) x (3L, 6W) product, and of b_red;
    with the damped inverses (Hll_inv, observed) for the
    back-substitution."""
    W, L = Hpl.shape[0], Hpl.shape[1]
    Hll_inv, observed = _damped_inv3(Hll, lam)
    M = torch.einsum("alij,ljk->alik", Hpl, Hll_inv)
    M2 = M.permute(0, 2, 1, 3).reshape(6 * W, 3 * L)
    H2 = Hpl.permute(0, 2, 1, 3).reshape(6 * W, 3 * L)
    return M2 @ H2.T, torch.einsum("alik,lk->ai", M, gl), Hll_inv, observed


def _schur_step(p: BAProblem, lam, slabs: list):
    """One damped Schur-complement step -> (delta_pose (W,6), delta_pt
    (L,3)), the landmarks eliminated slab by slab in slab order
    (vslam_tpu/ops/schur.py:390-436): peak memory holds one (W, L /
    n_slabs, 6, 3) Hpl block. The rows are linearized once; one slab keeps
    its blocks for the back-substitution, several are assembled again."""
    Hpp, gp, rows = _linearize(p)
    S_red = b_red = kept = None
    for s in slabs:
        Hll, Hpl, gl = _slab_system(p, rows, s)
        S_i, b_i, Hll_inv, observed = _reduce_slab(Hll, Hpl, gl, lam)
        S_red = S_i if S_red is None else S_red + S_i
        b_red = b_i if b_red is None else b_red + b_i
        if len(slabs) == 1:
            kept = (Hll_inv, observed, Hpl, gl)
    delta_p = _solve_reduced(p, Hpp, gp, S_red, b_red, lam)
    if kept is not None:
        return delta_p, _back_substitute(*kept, delta_p, p.pt_valid)
    delta_l = torch.empty_like(p.pts)
    for s in slabs:
        Hll, Hpl, gl = _slab_system(p, rows, s)
        cut = slice(s.off, s.off + s.n)
        delta_l[cut] = _back_substitute(*_damped_inv3(Hll, lam), Hpl, gl, delta_p, p.pt_valid[cut])
    return delta_p, delta_l


def _schur_step_sharded(p: BAProblem, lam, mesh, shards: list, shard_slabs: list):
    """One damped Schur step over a mesh, in `n_slabs` global landmark
    slabs (1: the plain sharded path, vslam_tpu/ops/schur.py:232-283,
    350-388; more: the composition run_global takes at map scale,
    :438-511). Each shard linearizes its rows and sums its share of the pose
    blocks (one psum; the odometry chain added once after it). Per slab,
    each shard scatters (W, L / n_slabs, 6, 3) partial blocks from its rows
    and a psum_scatter lands on shard g the fully summed sub-slab g of
    L / (n_slabs * mesh size) landmarks, where its share of the reduction
    runs. One psum adds the reduced systems; the (6W)^2 solve runs on the
    mesh's first device; each shard back-substitutes its sub-slabs and an
    all_gather assembles the landmark steps."""
    W, L = p.poses.shape[0], p.pts.shape[0]
    n_slabs = len(shard_slabs[0])
    Lslab = L // n_slabs
    Lsub = Lslab // mesh.size
    free = (~p.fixed) & p.pose_valid
    lin, diags, gps = [], [], []
    for _, q in shards:
        r, Jp, Jl = _obs_residual_and_jacobians(q)
        Jp = Jp * free.to(r.device)[q.obs_kf][:, None, None]
        diag, gp_q = _pose_rows(q, r, Jp)
        diags.append(diag)
        gps.append(gp_q)
        lin.append(_landmark_rows(r, Jp, Jl))
    Hpp, gp = _pose_system(p, mesh.psum(diags), mesh.psum(gps), free)
    lams = [lam.to(dev) for _, dev in mesh.local]

    def slab_blocks(i):
        """Each shard's fully summed sub-slab blocks of global slab i."""
        parts = [_slab_system(q, rows, sl[i]) for (_, q), rows, sl in zip(shards, lin, shard_slabs)]
        Hll = mesh.psum_scatter([x[0] for x in parts], 0)
        Hpl = mesh.psum_scatter([x[1] for x in parts], 1)
        gl = mesh.psum_scatter([x[2] for x in parts], 0)
        return list(zip(Hll, Hpl, gl))

    S_parts = b_parts = kept = None
    for i in range(n_slabs):
        blocks = slab_blocks(i)
        red = [_reduce_slab(Hll, Hpl, gl, lm) for (Hll, Hpl, gl), lm in zip(blocks, lams)]
        S_parts = [x[0] for x in red] if S_parts is None else [a + x[0] for a, x in zip(S_parts, red)]
        b_parts = [x[1] for x in red] if b_parts is None else [a + x[1] for a, x in zip(b_parts, red)]
        if n_slabs == 1:  # one slab keeps its blocks for the back-substitution
            kept = [(x[2], x[3], Hpl, gl) for x, (_, Hpl, gl) in zip(red, blocks)]
    delta_p = _solve_reduced(p, Hpp, gp, mesh.psum(S_parts), mesh.psum(b_parts), lam)
    delta_l = torch.empty_like(p.pts)
    for i in range(n_slabs):
        per = kept or [
            (*_damped_inv3(Hll, lm), Hpl, gl) for (Hll, Hpl, gl), lm in zip(slab_blocks(i), lams)
        ]
        parts = []
        for blk, (g, dev) in zip(per, mesh.local):
            off = i * Lslab + g * Lsub
            parts.append(_back_substitute(*blk, delta_p.to(dev), p.pt_valid[off : off + Lsub].to(dev)))
        delta_l[i * Lslab : (i + 1) * Lslab] = mesh.all_gather(parts)
    return delta_p, delta_l


def local_ba(
    p: BAProblem, iters: int = 5, lambda0: float = 1e-4, rel_tol: float = 1e-5,
    mesh=None, n_slabs: int = 1, stats: list | None = None, reads: list | None = None,
):
    """Up to `iters` LM iterations; returns (problem, final error, final
    lambda). GTSAM accept/reject with relativeErrorTol: done when an
    ACCEPTED step gains <= rel_tol * max(err, 1e-12); lambda x0.1 on
    accept, x10 on reject, clipped to [1e-9, 1e6]. A NaN trial error is a
    rejection. `n_slabs > 1`: the Schur reduction in landmark slabs
    (global BA at map scale). `mesh`: sharded over its shards
    (:func:`_schur_step_sharded`; the mesh size must divide the
    observation rows, and n_slabs x the mesh size the landmark slots),
    the accept/reject on the summed error. `stats`, when given, receives
    the iteration count; `reads`, the device-to-host reads made (the done
    flag, and the count for `stats`)."""
    err = ba_error(p, mesh)
    dev = err.device
    lam = torch.tensor(lambda0, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_iter = torch.zeros((), dtype=torch.int64, device=dev)
    if mesh is None:
        slabs = _slabs(p, n_slabs)
    else:
        L = p.pts.shape[0]
        if L % (n_slabs * mesh.size):
            raise ValueError(
                f"n_slabs={n_slabs} x mesh size {mesh.size} must divide the {L} landmark slots"
            )
        # the rows' slab layout per shard; it holds for the whole round
        shard_slabs = [_slabs(q, n_slabs) for _, q in _shards(p, mesh)]
    n_reads = 0
    for i in range(iters):
        if i and i % _DONE_CHECK_EVERY == 0:
            n_reads += 1
            if bool(done):
                break
        if mesh is None:
            dp, dl = _schur_step(p, lam, slabs)
        else:
            dp, dl = _schur_step_sharded(p, lam, mesh, _shards(p, mesh), shard_slabs)
        p_new = p._replace(poses=se3.retract(p.poses, dp), pts=p.pts + dl)
        new_err = ba_error(p_new, mesh)
        active = ~done
        improved = (new_err < err) & active  # False on NaN
        done = done | (improved & (err - new_err <= rel_tol * torch.clamp(err, min=1e-12)))
        p = p._replace(
            poses=torch.where(improved, p_new.poses, p.poses),
            pts=torch.where(improved, p_new.pts, p.pts),
        )
        lam_new = torch.clamp(torch.where(improved, lam * 0.1, lam * 10.0), 1e-9, 1e6)
        lam = torch.where(active, lam_new, lam)
        err = torch.where(improved, new_err, err)
        n_iter = n_iter + active.long()
    if stats is not None:
        stats.append(int(n_iter))
        n_reads += 1
    if reads is not None:
        reads.append(n_reads)
    return p, err, lam


def local_ba_two_rounds(
    p: BAProblem, iters1: int = 5, iters2: int = 10,
    mesh=None, n_slabs: int = 1, stats: list | None = None, reads: list | None = None,
):
    """The reference's 2-round schedule (src/OptimizationBA.cpp:543-873):
    :func:`local_ba_round1` then :func:`local_ba_round2`; `mesh` and
    `n_slabs` as for :func:`local_ba` (the sweep is per observation, so it
    needs no collective). Returns (problem, error, kill (O,) bool)."""
    kw = dict(mesh=mesh, n_slabs=n_slabs, stats=stats, reads=reads)
    return local_ba_round2(local_ba_round1(p, iters1, **kw), iters2, **kw)


def local_ba_round1(
    p: BAProblem, iters1: int = 5, *, mesh=None, n_slabs: int = 1, stats: list | None = None,
    reads: list | None = None,
) -> BAProblem:
    """Round 1 LM, then the chi-squared outlier sweep: the problem with the
    swept rows out of `obs_valid`. The first half of
    :func:`local_ba_two_rounds`; lambda starts at lambda0."""
    p1, _, _ = local_ba(p, iters=iters1, mesh=mesh, n_slabs=n_slabs, stats=stats, reads=reads)
    return p1._replace(obs_valid=p1.obs_valid & (obs_chi2(p1) < CHI2_THR))


def local_ba_round2(
    p1: BAProblem, iters2: int = 10, *, mesh=None, n_slabs: int = 1, stats: list | None = None,
    reads: list | None = None,
):
    """Round 2 LM (lambda restarts at lambda0), then the final kill mask:
    (problem, error, kill (O,) bool). The second half of
    :func:`local_ba_two_rounds`."""
    p2, err, _ = local_ba(p1, iters=iters2, mesh=mesh, n_slabs=n_slabs, stats=stats, reads=reads)
    return p2, err, p2.obs_valid & (obs_chi2(p2) >= CHI2_THR)


def obs_chi2(p: BAProblem) -> torch.Tensor:
    """Per-observation chi^2 (unwhitened pixel errors x information) for
    the outlier sweep; a behind-camera row never classifies as an inlier."""
    T_cw = se3.inverse(p.poses)[p.obs_kf]
    pt = p.pts[p.obs_lm]
    r, _, _ = _project_residual(
        T_cw, pt, p.obs_uv, p.obs_stereo, p.obs_right, p.K, p.baseline, False
    )
    chi2 = torch.sum(r * r, dim=-1) * (p.obs_w**2)
    z = torch.sum(T_cw[:, 2, :3] * pt, dim=-1) + T_cw[:, 2, 3]
    return torch.where(z <= 0.05, 1e12, chi2)
