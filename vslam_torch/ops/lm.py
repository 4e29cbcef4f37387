"""Batched Levenberg-Marquardt on manifolds and motion-only BA (port of
vslam_tpu/ops/lm.py): the SE(3) pose solve and the 15-dof visual-inertial
solve over (pose, velocity, bias).

GTSAM LevenbergMarquardtOptimizer semantics, as in the reference
(lm.py:86-95): lambda x/÷10 on reject/accept, clipped to [1e-10, 1e8];
done on a small relative decrease at low damping, or when lambda blows up.
``lax.while_loop`` becomes a Python loop over a batch of independent
problems (the tracker's two starts): a lane that is done is frozen, so
every lane stops at the iteration where the JAX loop stops. The host reads
the done flags only every ``_DONE_CHECK_EVERY`` iterations.

The Jacobians are analytic, at the zero tangent of the retraction — what
``jax.jacfwd`` computes at lm.py:73, without the forward-mode pass: the
projection rows in the pose tangent of T * exp(xi), and the 30 inertial,
bias and prior rows of the visual-inertial solve in its 15-vector tangent.

On a CUDA tensor :func:`motion_only_ba` is one launch of the hand-written
kernel ``kernels/csrc/motion_only_lm.cu`` (both LM passes, the sweeps and
the done tests on the device); on a CPU tensor it is its plain version,
:func:`motion_only_ba_ref`. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vslam_torch import kernels
from vslam_torch.geometry import se3
from vslam_torch.ops.project_match import per_problem

CHI2_3DOF = 7.815  # reference include/FeatureTracker.h:56
LAUNCHES = 0
# The kernel stages a problem's rows in one block's shared memory, 29 B a
# row: an H100 gives a block 227 KiB, about 7,900 rows.
MAX_ROWS = 7680

# Iterations between host reads of the done flags. It only spaces out the
# host syncs: a lane that is done is frozen, so it never changes the
# iteration at which a lane stops.
_DONE_CHECK_EVERY = 4


class LMResult(NamedTuple):
    state: torch.Tensor | tuple  # (B, 4, 4), or a tuple of (B, ...) leaves
    error: torch.Tensor  # (B,) final 0.5 * ||r||^2
    iterations: torch.Tensor  # (B,) int64
    lam: torch.Tensor  # (B,)


def _half_sq(r: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(r * r, dim=tuple(range(1, r.ndim)))


def _select(mask: torch.Tensor, new, old):
    """Per problem of the batch, `new` where `mask` else `old`, leaf by leaf."""
    if isinstance(new, torch.Tensor):
        return torch.where(mask.view((-1,) + (1,) * (new.ndim - 1)), new, old)
    return tuple(_select(mask, n, o) for n, o in zip(new, old))


def lm_solve(
    linearize: Callable,
    residual: Callable,
    state0,
    max_iters: int = 100,
    lambda0: float = 1e-5,
    lambda_factor: float = 10.0,
    rel_tol: float = 1e-5,
    min_diag: float = 1e-6,
    retract: Callable = se3.retract,
    stats: list | None = None,
    reads: list | None = None,
) -> LMResult:
    """Minimize 0.5 * ||r(x)||^2 for a batch of B states x with the
    retraction `retract(x, delta)` (default: poses T (B, 4, 4) with the right
    retraction T * exp(delta)). A state is a tensor or a tuple of tensors,
    each with the batch as its leading dimension.

    residual(x) -> r (B, R); linearize(x) -> (r (B, R), J (B, R, D)) with
    J = dr/d(delta) at delta = 0. Invalid rows must already be zero.
    `stats`, when given, receives the iterations the host loop dispatched;
    `reads`, the device-to-host reads of the done flags it made."""
    lead = state0 if isinstance(state0, torch.Tensor) else state0[0]
    B = lead.shape[0]
    dev = lead.device
    state = state0
    err = _half_sq(residual(state0))
    lam = torch.full((B,), lambda0, dtype=torch.float32, device=dev)
    its = torch.zeros((B,), dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_iter = n_reads = 0
    for k in range(max_iters):
        if k and k % _DONE_CHECK_EVERY == 0:
            n_reads += 1
            if bool(done.all()):
                break
        n_iter += 1
        active = ~done
        r, J = linearize(state)
        Jt = J.transpose(-1, -2)
        H = Jt @ J
        g = (Jt @ r[..., None])[..., 0]
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=min_diag)
        A = H + lam[:, None, None] * torch.diag_embed(diag)
        delta = torch.linalg.solve_ex(A, -g)[0]  # no host sync on error check
        new_state = retract(state, delta)
        new_err = _half_sq(residual(new_state))
        improved = new_err < err
        upd = active & improved
        state = _select(upd, new_state, state)
        lam_new = torch.where(improved, lam / lambda_factor, lam * lambda_factor)
        lam_new = torch.clamp(lam_new, 1e-10, 1e8)
        rel = torch.abs(err - new_err) / torch.clamp(err, min=1e-12)
        # converged on relative decrease only at low damping; or stalled
        # (see vslam_tpu/ops/lm.py:89-95)
        done_new = (improved & (rel < rel_tol) & (lam_new < 1e-1)) | (lam_new > 1e6)
        err = torch.where(upd, new_err, err)
        lam = torch.where(active, lam_new, lam)
        its = its + active.long()
        done = done | (active & done_new)
    if stats is not None:
        stats.append(n_iter)
    if reads is not None:
        reads.append(n_reads)
    return LMResult(state=state, error=err, iterations=its, lam=lam)


# ---------------------------------------------------------------------------
# Motion-only bundle adjustment (pose from frozen landmarks)
# ---------------------------------------------------------------------------


def _project(T_wc, pts_w, K, baseline):
    """Left-camera coordinates of pts_w under each pose (B, 4, 4): shared
    points (M, 3) or one set per problem (B, M, 3)."""
    T_cw = se3.inverse(T_wc)
    pts = pts_w if pts_w.ndim == 3 else pts_w[None]
    return se3.transform_points(T_cw, pts)  # (B, M, 3)


def _residuals(pc, obs, weights, is_stereo, is_right, valid, K, baseline, with_jac):
    """K (3, 3) and a scalar baseline shared by the batch, or (B, 3, 3)
    and (B,) per problem."""
    fx, fy = per_problem(K[..., 0, 0]), per_problem(K[..., 1, 1])
    cx, cy = per_problem(K[..., 0, 2]), per_problem(K[..., 1, 2])
    baseline = per_problem(baseline)
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=0.05)
    u_l = fx * x / z + cx
    v_l = fy * y / z + cy
    u_r = fx * (x - baseline) / z + cx

    u_pred = torch.where(is_right, u_r, u_l)
    r_u = u_pred - obs[..., 0]
    r_v = v_l - obs[..., 1]
    r_ur = torch.where(is_stereo, u_r - obs[..., 2], 0.0)
    # behind-camera rows COST (clamped z -> huge residual, clipped to 512 px)
    # instead of vanishing; see vslam_tpu/ops/lm.py:141-149
    w = torch.where(valid, weights, 0.0)
    raw = torch.stack([r_u, r_v, r_ur], dim=-1)
    res = torch.clamp(raw, -512.0, 512.0) * w[..., None]
    if not with_jac:
        return res, None

    # d pc / d xi at xi = 0 for T * exp(xi): [hat(pc) | -I]
    dpc = torch.cat(
        [se3.hat(pc), -torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))],
        dim=-1,
    )  # (B, M, 3, 6)
    dx, dy = dpc[..., 0, :], dpc[..., 1, :]
    dz = dpc[..., 2, :] * (pc[..., 2] > 0.05)[..., None]
    zz = (z * z)[..., None]
    zc = z[..., None]
    fx2, fy2 = per_problem(K[..., 0, 0], 2), per_problem(K[..., 1, 1], 2)  # against (B, M, 6)
    du_l = fx2 * dx / zc - (fx * x)[..., None] * dz / zz
    dv_l = fy2 * dy / zc - (fy * y)[..., None] * dz / zz
    du_r = fx2 * dx / zc - (fx * (x - baseline))[..., None] * dz / zz
    J = torch.stack(
        [
            torch.where(is_right[..., None], du_r, du_l),
            dv_l,
            torch.where(is_stereo[..., None], du_r, 0.0),
        ],
        dim=-2,
    )  # (B, M, 3, 6)
    inside = ((raw > -512.0) & (raw < 512.0)).to(J.dtype)
    J = J * (inside * w[..., None])[..., None]
    return res, J


def stereo_residuals(
    T_wc: torch.Tensor,  # (B, 4, 4) camera-to-world (left)
    pts_w: torch.Tensor,  # (M, 3) frozen landmark positions
    obs: torch.Tensor,  # (M, 3) [u_left, v_left, u_right]
    weights: torch.Tensor,  # (M,) sqrt information
    is_stereo: torch.Tensor,  # (M,) or (B, M) bool: has a valid right-x
    is_right: torch.Tensor,  # (M,) bool: observation in the RIGHT camera only
    valid: torch.Tensor,  # (M,) or (B, M) bool
    K: torch.Tensor,
    baseline,
) -> torch.Tensor:
    """(B, M, 3) weighted residuals: the reference factor mix
    (src/FeatureTracker.cpp:216-298) — close points [u_l, v, u_r], far left
    points [u_l, v, 0], right-camera points [u_r, v, 0]."""
    pc = _project(T_wc, pts_w, K, baseline)
    return _residuals(pc, obs, weights, is_stereo, is_right, valid, K, baseline, False)[0]


def reproj_chi2(
    T_wc, pts_w, obs, inv_sigma2, is_stereo, is_right, valid, K, baseline
) -> torch.Tensor:
    """(B, M) per-observation chi^2 (reference check2dError / findOutliersR,
    src/FeatureTracker.cpp:147-164, 582-649); behind-camera rows never
    classify as inliers."""
    ones = torch.ones_like(inv_sigma2)
    pc = _project(T_wc, pts_w, K, baseline)
    res = _residuals(pc, obs, ones, is_stereo, is_right, valid, K, baseline, False)[0]
    e2 = torch.sum(res * res, dim=-1)
    e2 = torch.where(pc[..., 2] <= 0.05, 1e12, e2)
    return e2 * inv_sigma2


def motion_only_ba_ref(
    T_init: torch.Tensor,  # (B, 4, 4) one problem per initial pose
    pts_w: torch.Tensor,
    obs: torch.Tensor,
    inv_sigma2: torch.Tensor,
    is_stereo: torch.Tensor,
    is_right: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    baseline,
    max_iters: int = 100,
    stats: list | None = None,
    reads: list | None = None,
):
    """Pose-only LM with frozen landmarks (reference estimatePoseGTSAM,
    no-IMU branch), solved from each of the B initial poses at once. The
    landmarks, observations, flags, `K` and `baseline` are shared by the B
    problems, or carry the leading B (one problem set per sequence of a
    batch: (B, M, ...), K (B, 3, 3), baseline (B,)).

    Two passes (vslam_tpu/ops/lm.py:motion_only_ba): a Huber-reweighted
    solve, a chi-squared sweep with stereo->mono demotion, then a plain
    least-squares re-solve on the gated set.

    Returns (T_opt (B,4,4), chi2 (B,M), inliers (B,M), is_stereo_out (B,M),
    LMResult of the second pass). `stats` and `reads` as for
    :func:`lm_solve`, one entry per pass.

    This is the plain version: :func:`motion_only_ba` runs it on the CPU,
    and the card's kernel is held against it."""
    B = T_init.shape[0]
    weights = torch.sqrt(inv_sigma2)
    chi2_gate = torch.tensor(CHI2_3DOF, dtype=torch.float32)
    huber_delta = float(torch.sqrt(chi2_gate))  # f32 sqrt, as jnp.sqrt
    valid_b = valid.expand(B, -1)
    st_b = is_stereo.expand(B, -1)

    def classify(T, st):
        chi2_3 = reproj_chi2(T, pts_w, obs, inv_sigma2, st, is_right, valid, K, baseline)
        chi2_2 = reproj_chi2(
            T, pts_w, obs, inv_sigma2, torch.zeros_like(st), is_right, valid, K, baseline
        )
        demote = st & (chi2_3 >= CHI2_3DOF) & (chi2_2 < CHI2_3DOF)
        keep = valid & ((chi2_3 < CHI2_3DOF) | demote)
        return keep, st & ~demote

    def solve(T0, mask, st, robust):
        def lin(T, with_jac):
            pc = _project(T, pts_w, K, baseline)
            r, J = _residuals(pc, obs, weights, st, is_right, mask, K, baseline, with_jac)
            if robust:
                # IRLS Huber weight, frozen at the linearization point (the
                # reference's stop_gradient); eps keeps padded zero rows finite
                n = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-18)
                w_h = torch.sqrt(torch.clamp(huber_delta / n, max=1.0))
                r = r * w_h[..., None]
                if with_jac:
                    J = J * w_h[..., None, None]
            r = r.reshape(B, -1)
            return (r, J.reshape(B, -1, 6)) if with_jac else r

        return lm_solve(
            lambda T: lin(T, True), lambda T: lin(T, False), T0, max_iters=max_iters,
            stats=stats, reads=reads,
        )

    res1 = solve(T_init, valid_b, st_b, robust=True)
    keep, st1 = classify(res1.state, st_b)
    # guard: if the sweep kills nearly everything, keep the original set
    enough = torch.sum(keep, dim=-1) >= torch.clamp(torch.sum(valid_b, dim=-1) // 4, min=6)
    keep = torch.where(enough[:, None], keep, valid_b)
    st1 = torch.where(enough[:, None], st1, st_b)
    result = solve(res1.state, keep, st1, robust=False)
    T_opt = result.state
    inliers, st_out = classify(T_opt, st1)
    chi2 = reproj_chi2(T_opt, pts_w, obs, inv_sigma2, st_out, is_right, valid, K, baseline)
    return T_opt, chi2, inliers, st_out, result


class KernelLayout(NamedTuple):
    """How the motion-only LM kernel reads a call's operands."""

    B: int
    M: int
    rows: tuple  # (tensor, batch stride in elements) of pts, obs, inv_sigma2, stereo, right, valid
    K: tuple  # (tensor, batch stride)
    baseline: tuple  # (tensor or None, batch stride, value of a host baseline)


def _batch_stride(name: str, x, B: int, M: int, tail: tuple, dtype, device) -> int:
    """The batch stride of a per-row operand, shared by the batch (M, *tail)
    or one per problem (B, M, *tail) (any batch stride, 0 included, but
    contiguous within a problem); raises on what the kernel does not take."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"motion_only_ba: {name} must be a tensor; got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"motion_only_ba: {name} must be {dtype}; got {x.dtype}")
    if x.device != device:
        raise ValueError(f"motion_only_ba: {name} on {x.device}, the poses on {device}")
    shape = (M, *tail)
    if tuple(x.shape) == shape:
        if not x.is_contiguous():
            raise ValueError(f"motion_only_ba: {name} {shape} must be contiguous")
        return 0
    if tuple(x.shape) == (B, *shape):
        if B and not x[0].is_contiguous():
            raise ValueError(f"motion_only_ba: each problem's {name} {shape} must be contiguous")
        return x.stride(0) if B > 1 else 0
    raise ValueError(f"motion_only_ba: {name} must be {shape} or {(B, *shape)}; got {tuple(x.shape)}")


def kernel_layout(
    T_init, pts_w, obs, inv_sigma2, is_stereo, is_right, valid, K, baseline
) -> KernelLayout:
    """Check a call's operands against what the kernel takes (float32 poses,
    points, observations and weights, bool flags, each per-row operand
    shared by the batch or carrying the leading B, contiguous within a
    problem, at most MAX_ROWS rows; K a float32 (3, 3) or (B, 3, 3) on the
    poses' device; a number, 0-d tensor or (B,) baseline) and return how it
    reads them. Raises TypeError or ValueError; launches nothing."""
    if not isinstance(T_init, torch.Tensor) or T_init.dtype != torch.float32:
        raise TypeError("motion_only_ba: T_init must be a float32 tensor")
    if T_init.ndim != 3 or tuple(T_init.shape[1:]) != (4, 4) or not T_init.is_contiguous():
        raise ValueError(f"motion_only_ba: T_init must be a contiguous (B, 4, 4); got {tuple(T_init.shape)}")
    B, dev = T_init.shape[0], T_init.device
    if not isinstance(pts_w, torch.Tensor) or pts_w.ndim not in (2, 3):
        raise ValueError("motion_only_ba: pts_w must be a (M, 3) or (B, M, 3) tensor")
    M = pts_w.shape[-2]
    if M > MAX_ROWS:
        raise ValueError(f"motion_only_ba: {M} rows; the kernel stages at most {MAX_ROWS} in shared memory")
    f32, b8 = torch.float32, torch.bool
    rows = tuple(
        (x, _batch_stride(name, x, B, M, tail, dtype, dev))
        for name, x, tail, dtype in (
            ("pts_w", pts_w, (3,), f32), ("obs", obs, (3,), f32), ("inv_sigma2", inv_sigma2, (), f32),
            ("is_stereo", is_stereo, (), b8), ("is_right", is_right, (), b8), ("valid", valid, (), b8),
        )
    )
    K_lay = (K, _batch_stride("K", K, B, 3, (3,), f32, dev))
    if isinstance(baseline, torch.Tensor) and baseline.ndim:
        if baseline.dtype != f32 or baseline.device != dev or tuple(baseline.shape) != (B,):
            raise ValueError(
                f"motion_only_ba: a per-problem baseline must be a float32 ({B},) on {dev}; got "
                f"{baseline.dtype} {tuple(baseline.shape)} on {baseline.device}"
            )
        bl_lay = (baseline, baseline.stride(0) if B > 1 else 0, 0.0)
    elif isinstance(baseline, torch.Tensor) and baseline.device == dev:
        if baseline.dtype != f32:
            raise TypeError(f"motion_only_ba: baseline must be float32; got {baseline.dtype}")
        bl_lay = (baseline, 0, 0.0)
    else:
        bl_lay = (None, 0, float(baseline))
    return KernelLayout(B, M, rows, K_lay, bl_lay)


def motion_only_ba(
    T_init: torch.Tensor,
    pts_w: torch.Tensor,
    obs: torch.Tensor,
    inv_sigma2: torch.Tensor,
    is_stereo: torch.Tensor,
    is_right: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    baseline,
    max_iters: int = 100,
    stats: list | None = None,
    reads: list | None = None,
):
    """:func:`motion_only_ba_ref`'s pose solve. On a CUDA tensor it is one
    launch of ``kernels/csrc/motion_only_lm.cu`` (the operands as
    :func:`kernel_layout` takes them, else it raises): both LM passes, the
    chi-squared sweeps and every done test run on the device, with no host
    read. `stats` then receives, per pass, the (B,) iterations each problem
    ran, as a device tensor; `reads`, 0 per pass. On a CPU tensor it is
    :func:`motion_only_ba_ref`."""
    global LAUNCHES
    dev = T_init.device
    if dev.type == "cpu":
        return motion_only_ba_ref(
            T_init, pts_w, obs, inv_sigma2, is_stereo, is_right, valid, K, baseline,
            max_iters=max_iters, stats=stats, reads=reads,
        )
    if dev.type != "cuda":
        raise ValueError(f"motion_only_ba: unsupported device {dev}")
    lay = kernel_layout(T_init, pts_w, obs, inv_sigma2, is_stereo, is_right, valid, K, baseline)
    B, M = lay.B, lay.M
    f32 = torch.float32
    T_out = torch.empty((B, 4, 4), dtype=f32, device=dev)
    chi2 = torch.empty((B, M), dtype=f32, device=dev)
    inliers = torch.empty((B, M), dtype=torch.bool, device=dev)
    st_out = torch.empty((B, M), dtype=torch.bool, device=dev)
    err = torch.empty((B,), dtype=f32, device=dev)
    lam = torch.empty((B,), dtype=f32, device=dev)
    iters = torch.empty((B, 2), dtype=torch.int64, device=dev)
    if B:
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        (K_t, K_s), (bl_t, bl_s, bl_v) = lay.K, lay.baseline
        args = (
            T_init.data_ptr(), *(a for x, stride in lay.rows for a in (x.data_ptr(), stride)),
            K_t.data_ptr(), K_s, ptr(bl_t), bl_s, bl_v, B, M, int(max_iters),
            T_out.data_ptr(), chi2.data_ptr(), inliers.data_ptr(), st_out.data_ptr(),
            err.data_ptr(), lam.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        lib = kernels.library()
        if dev.index == torch.cuda.current_device():
            rc = lib.motion_only_lm_f32(*args)
        else:
            with torch.cuda.device(dev):
                rc = lib.motion_only_lm_f32(*args)
        kernels.check(rc, "motion_only_lm_f32")
        LAUNCHES += 1
    if stats is not None:
        stats.extend([iters[:, 0], iters[:, 1]])
    if reads is not None:
        reads.extend([0, 0])
    return T_out, chi2, inliers, st_out, LMResult(state=T_out, error=err, iterations=iters[:, 1], lam=lam)


# ---------------------------------------------------------------------------
# IMU-fused motion-only bundle adjustment (15-dof: pose + velocity + bias)
# ---------------------------------------------------------------------------


def motion_only_ba_imu(
    T_init: torch.Tensor,  # (4, 4) predicted cam-to-world (left camera)
    v_init: torch.Tensor,  # (3,) predicted world velocity (body)
    bias_prev: torch.Tensor,  # (6,) [ba, bg] of the previous frame (frozen)
    T_prev_wb: torch.Tensor,  # (4, 4) previous BODY pose (frozen anchor x0)
    v_prev: torch.Tensor,  # (3,) previous world velocity (frozen v0)
    pre,  # imu.PreintState over the inter-frame samples
    gravity_w: torch.Tensor,  # (3,)
    imu_params,  # imu.ImuParams
    T_bc: torch.Tensor,  # (4, 4) body-to-cam extrinsic (reference T_bc1)
    pts_w: torch.Tensor,
    obs: torch.Tensor,
    inv_sigma2: torch.Tensor,
    is_stereo: torch.Tensor,
    is_right: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    baseline,
    max_iters: int = 100,
    bias_sigma: float = 1e-3,
    stats: list | None = None,
    reads: list | None = None,
):
    """Visual-inertial pose solve (reference estimatePoseGTSAM, IMU branch,
    src/FeatureTracker.cpp:301-387; vslam_tpu/ops/lm.py:275-379): x0/v0/b0
    frozen, the CombinedImuFactor(x0, v0, x1, v1, b0, b1), the bias
    between-factor (sigma 1e-3), priors on x1/v1 at the propagated state,
    plus the projection/stereo factors of :func:`motion_only_ba`.

    The state is (T_wc, v_w, bias), 6 + 3 + 6 = 15 dof. The visual rows take
    the analytic projection Jacobian (pose columns only) with the pass-1
    Huber weight frozen at the linearization point; the 30 inertial, bias
    and prior rows take the analytic Jacobian of
    :func:`imu.combined_residual_and_jacobian` and the SE(3) right Jacobian
    of the pose prior, carried from the body perturbation to the camera's
    by Ad(T_bc). Returns (T_opt (4, 4), v_opt (3,), bias_opt (6,), chi2
    (M,), inliers (M,), is_stereo_out (M,), LMResult of the second pass).
    `stats` and `reads` as for :func:`lm_solve`, one entry per pass.

    Batched: every argument with a leading S (the preintegration's fields
    too; ImuParams fields floats or (S,) tensors) solves S independent
    problems at once (one per sequence of a batch); the outputs then carry
    the leading S."""
    if T_init.ndim == 2:
        one = lambda x: x[None] if isinstance(x, torch.Tensor) and x.ndim else x
        out = motion_only_ba_imu(
            *(one(x) for x in (T_init, v_init, bias_prev, T_prev_wb, v_prev)),
            type(pre)(*(x[None] for x in pre)), gravity_w[None], imu_params, T_bc[None],
            *(one(x) for x in (pts_w, obs, inv_sigma2, is_stereo, is_right, valid, K)),
            one(baseline), max_iters=max_iters, bias_sigma=bias_sigma, stats=stats, reads=reads,
        )
        return (*(x[0] for x in out[:6]), out[6])
    from vslam_torch.ops import imu as imu_mod

    S = T_init.shape[0]
    dev = T_init.device
    weights = torch.sqrt(inv_sigma2)
    huber_delta = float(torch.sqrt(torch.tensor(CHI2_3DOF, dtype=torch.float32)))
    T_cb = se3.inverse(T_bc)
    # T_wc Exp(xi) T_cb = T_wb Exp(Ad(T_bc) xi): camera tangent -> body tangent
    cam_to_body = se3.adjoint(T_bc)
    L = imu_mod.cov_factor(pre)  # the covariance is constant over the solve
    # propagated (predicted) state for the x1/v1 priors (sigma 1)
    T_pred_wb_inv = se3.inverse(T_init @ T_cb)
    eye3 = torch.eye(3, device=dev)

    def classify(T, st):
        chi2_3 = reproj_chi2(T, pts_w, obs, inv_sigma2, st, is_right, valid, K, baseline)
        chi2_2 = reproj_chi2(
            T, pts_w, obs, inv_sigma2, torch.zeros_like(st), is_right, valid, K, baseline
        )
        demote = st & (chi2_3 >= CHI2_3DOF) & (chi2_2 < CHI2_3DOF)
        keep = valid & ((chi2_3 < CHI2_3DOF) | demote)
        return keep, st & ~demote

    def retract(state, d):
        T, v, b = state
        return (se3.retract(T, d[:, :6]), v + d[:, 6:9], b + d[:, 9:15])

    def inertial_rows(T_wc, v_w, b, with_jac):
        """(S, 30) [CombinedImuFactor 15 | bias between 6 | pose prior 6 |
        velocity prior 3] and, with_jac, their (S, 30, 15) Jacobian."""
        T_wb = T_wc @ T_cb
        args = (T_prev_wb, v_prev, bias_prev, T_wb, v_w, b, pre, bias_prev, gravity_w, imu_params)
        if with_jac:
            r_imu, J_imu = imu_mod.combined_residual_and_jacobian(*args, L=L)
        else:
            r_imu = imu_mod.combined_residual(*args, L=L)
        r_bias = (b - bias_prev) / bias_sigma
        r_prior_p = se3.se3_logmap(T_pred_wb_inv @ T_wb)
        r_prior_v = v_w - v_init
        r = torch.cat([r_imu, r_bias, r_prior_p, r_prior_v], dim=-1)
        if not with_jac:
            return r
        J = torch.zeros((S, 30, 15), device=dev)
        J[:, :15] = J_imu
        J[:, 15:21, 9:15] = torch.eye(6, device=dev) / bias_sigma
        J[:, 21:27, :6] = se3.se3_right_jacobian_inv(r_prior_p)
        J[:, 27:30, 6:9] = eye3
        J[:, :, :6] = J[:, :, :6] @ cam_to_body
        return r, J

    def solve(state0, mask, st, robust):
        def lin(state, with_jac):
            T, v, b = state
            pc = _project(T, pts_w, K, baseline)
            r, J = _residuals(pc, obs, weights, st, is_right, mask, K, baseline, with_jac)
            if robust:
                # IRLS Huber on the visual rows, frozen per linearization
                n = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-18)
                w_h = torch.sqrt(torch.clamp(huber_delta / n, max=1.0))
                r = r * w_h[..., None]
                if with_jac:
                    J = J * w_h[..., None, None]
            if not with_jac:
                return torch.cat([r.reshape(S, -1), inertial_rows(T, v, b, False)], dim=1)
            r_in, J_in = inertial_rows(T, v, b, True)
            J = J.reshape(S, -1, 6)
            J_vis = torch.cat([J, J.new_zeros(J.shape[:2] + (9,))], dim=-1)
            return torch.cat([r.reshape(S, -1), r_in], dim=1), torch.cat([J_vis, J_in], dim=1)

        return lm_solve(
            lambda s: lin(s, True), lambda s: lin(s, False), state0,
            max_iters=max_iters, retract=retract, stats=stats, reads=reads,
        )

    res1 = solve((T_init, v_init, bias_prev), valid, is_stereo, robust=True)
    keep, st1 = classify(res1.state[0], is_stereo)
    enough = torch.sum(keep, dim=-1) >= torch.clamp(torch.sum(valid, dim=-1) // 4, min=6)
    keep = torch.where(enough[:, None], keep, valid)
    st1 = torch.where(enough[:, None], st1, is_stereo)
    result = solve(res1.state, keep, st1, robust=False)
    T_opt, v_opt, b_opt = result.state
    inliers, st_out = classify(T_opt, st1)
    chi2 = reproj_chi2(T_opt, pts_w, obs, inv_sigma2, st_out, is_right, valid, K, baseline)
    return T_opt, v_opt, b_opt, chi2, inliers, st_out, result
