"""Pose-graph optimization for loop closure (port of
vslam_tpu/models/pose_graph.py).

Keyframe poses, a chain of odometry edges (relative poses taken from the
current estimates, like the reference's BetweenFactor chain,
src/OptimizationBA.cpp:750-768) and a few loop edges (relative poses
measured by a verified revisit); minimize

    sum_e || log( Z_e^-1 * T_i^-1 * T_j ) ||^2 * w_e^2

over all poses with pose 0 fixed, by damped Gauss-Newton with the JAX
version's accept/reject rules, lambda clip and stop test. Three solvers:

- :func:`optimize`: any edge list, one dense (6P x 6P) solve per
  iteration (the closer uses it up to 128 keyframes);
- :func:`optimize_chain`: the chain plus loop edges in O(P) per
  iteration, T + U^T U solved by Woodbury around a block-tridiagonal
  solve of the chain part T;
- :func:`optimize_sim3_chain`: the same over Sim(3) (7-dof states with a
  log-scale) for monocular closures.

Differences from the JAX version, none of which changes the math:
- the edge Jacobians are analytic, batched over the edges (JAX takes
  ``jax.jacfwd`` per edge): with the right retraction T exp(d),
  dr/d(d_j) = Jr^-1(r) and dr/d(d_i) = -Jr^-1(r) Ad(T_j^-1 T_i), where
  Jr^-1 is the series I + ad/2 + ad^2/12 - ad^4/720 + ad^6/30240 -
  ad^8/1209600 in the algebra's bracket matrix ad_r (se(3) 6x6, sim(3)
  7x7; next term ~|r|^10 / 4.8e7, below float32 for |r| < 1 rad);
- the block-tridiagonal solve is a block cyclic reduction: log2(P) rounds
  of batched dxd solves and matmuls over half the blocks each, instead of
  the two ``lax.scan``s of block-Thomas (2P dependent solves). It solves
  the same system in another sum order;
- duplicate-index sums (the dense Hessian's blocks, the loop rows'
  gradient) are ``index_put_(accumulate=True)`` under deterministic
  algorithms: a fixed order on every device;
- the solves are ``torch.linalg.solve_ex``: a singular system gives a
  non-finite step that the accept test rejects, as JAX's solve does,
  with no host sync to check it;
- ``lax.while_loop`` is a host loop that reads the done flag every
  ``_DONE_CHECK_EVERY`` iterations; an iteration past done changes
  nothing (``improved`` is false there), so the result does not depend
  on that interval.

The reference has no pose graph (its loop-closure fields are vestigial,
include/Map.h:122-127).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vslam_torch.geometry import se3, sim3
from vslam_torch.ops import schur

_DONE_CHECK_EVERY = 4  # GN iterations between host reads of the done flag


class _Group(NamedTuple):
    dim: int
    log: Callable
    inv: Callable
    retract: Callable
    Ad: Callable  # group adjoint (..., 4, 4) -> (..., d, d)
    ad: Callable  # algebra bracket matrix (..., d) -> (..., d, d)


def _se3_ad(xi: torch.Tensor) -> torch.Tensor:
    """ad_xi of se(3) for xi = [omega, v]: [[omega^, 0], [v^, omega^]]."""
    Wo, Wv = se3.hat(xi[..., :3]), se3.hat(xi[..., 3:])
    return torch.cat(
        [torch.cat([Wo, torch.zeros_like(Wo)], dim=-1), torch.cat([Wv, Wo], dim=-1)], dim=-2
    )


SE3 = _Group(6, se3.se3_logmap, se3.inverse, se3.retract, se3.adjoint, _se3_ad)
SIM3 = _Group(7, sim3.logmap, sim3.inverse, sim3.retract, sim3.adjoint, sim3.ad)


def _right_jacobian_inv(adm: torch.Tensor) -> torch.Tensor:
    """Jr^-1 = ad / (1 - exp(-ad)) as its Bernoulli series in the bracket
    matrix: (..., d, d) -> (..., d, d)."""
    a2 = adm @ adm
    a4 = a2 @ a2
    a6 = a4 @ a2
    eye = torch.eye(adm.shape[-1], dtype=adm.dtype, device=adm.device)
    return eye + 0.5 * adm + a2 / 12.0 - a4 / 720.0 + a6 / 30240.0 - (a4 @ a4) / 1209600.0


def _edge_residuals(g: _Group, Ti, Tj, Z, w) -> torch.Tensor:
    """(E, d) weighted log-residuals log(Z^-1 Ti^-1 Tj) * w."""
    return g.log(g.inv(Z) @ g.inv(Ti) @ Tj) * w[:, None]


def _edge_jacobians(g: _Group, Ti, Tj, Z, w):
    """Weighted residuals (E, d) and their Jacobians (E, d, d) in the
    right-retraction tangents of Ti and Tj."""
    r = g.log(g.inv(Z) @ g.inv(Ti) @ Tj)
    Jinv = _right_jacobian_inv(g.ad(r))
    ww = w[:, None, None]
    Jj = Jinv * ww
    Ji = -(Jinv @ g.Ad(g.inv(Tj) @ Ti)) * ww
    return r * w[:, None], Ji, Jj


def _gn_loop(states, error, step, retract, iters: int, lambda0: float, stats: list | None):
    """Damped Gauss-Newton with JAX's accept/reject rules: a step is taken
    when the error drops (a NaN trial error is a rejection); lambda x0.3 on
    accept, x10 on reject, clipped to [1e-9, 1e5]; done when an accepted
    step gains <= 1e-9 * max(err, 1e-12). Returns (states, error); `stats`,
    when given, receives the number of iterations JAX's loop would run."""
    err = error(states)
    dev = err.device
    lam = torch.tensor(lambda0, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_iter = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(iters):
        if it and it % _DONE_CHECK_EVERY == 0 and bool(done):
            break
        delta = step(states, lam)
        new = retract(states, delta)
        err_new = error(new)
        active = ~done
        improved = (err_new < err) & active
        states = torch.where(improved, new, states)
        lam_new = torch.clamp(torch.where(improved, lam * 0.3, lam * 10.0), 1e-9, 1e5)
        lam = torch.where(active, lam_new, lam)
        done = done | (improved & (err - err_new <= 1e-9 * torch.clamp(err, min=1e-12)))
        err = torch.where(improved, err_new, err)
        n_iter = n_iter + active.long()
    if stats is not None:
        stats.append(int(n_iter))
    return states, err


def optimize(
    poses: torch.Tensor,  # (P, 4, 4) cam-to-world
    pose_valid: torch.Tensor,  # (P,) bool
    edges_i: torch.Tensor,  # (E,) int
    edges_j: torch.Tensor,  # (E,) int
    edges_rel: torch.Tensor,  # (E, 4, 4) measured T_i^-1 T_j
    edges_w: torch.Tensor,  # (E,) sqrt-information (0 = padding)
    iters: int = 20,
    lambda0: float = 1e-6,
    stats: list | None = None,
):
    """Damped Gauss-Newton over the pose graph, one dense solve per
    iteration; pose 0 stays fixed (world gauge). Returns (optimized poses,
    final error); `stats` receives the iteration count."""
    P = poses.shape[0]
    dev = poses.device
    ei, ej = edges_i.long(), edges_j.long()
    free = pose_valid & (torch.arange(P, device=dev) > 0)
    eye6 = torch.eye(6, dtype=poses.dtype, device=dev)
    eyeP = torch.eye(P, dtype=torch.bool, device=dev)

    def error(ps):
        r = _edge_residuals(SE3, ps[ei], ps[ej], edges_rel, edges_w)
        return 0.5 * torch.sum(r * r)

    def step(ps, lam):
        r, Ji, Jj = _edge_jacobians(SE3, ps[ei], ps[ej], edges_rel, edges_w)
        Ji = Ji * free[ei][:, None, None]
        Jj = Jj * free[ej][:, None, None]
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
        H = torch.zeros((P, P, 6, 6), dtype=poses.dtype, device=dev)
        schur._scatter_add(
            H,
            (torch.cat([ei, ej, ei, ej]), torch.cat([ei, ej, ej, ei])),
            torch.cat([JiT @ Ji, JjT @ Jj, JiT @ Jj, JjT @ Ji]),
        )
        g = torch.zeros((P, 6), dtype=poses.dtype, device=dev)
        schur._scatter_add(
            g, (torch.cat([ei, ej]),), torch.cat([(JiT @ r[..., None])[..., 0], (JjT @ r[..., None])[..., 0]])
        )
        diag = torch.diagonal(H[torch.arange(P, device=dev), torch.arange(P, device=dev)], dim1=-2, dim2=-1)
        damp = lam * torch.clamp(diag.sum(-1) / 6.0, min=1e-8)  # (P,)
        H = H + torch.where(eyeP[:, :, None, None], damp[:, None, None, None] * eye6, 0.0)
        fm = free[:, None] & free[None, :]
        H = torch.where(fm[:, :, None, None], H, 0.0)
        H = H + torch.where((eyeP & ~torch.diag(free))[:, :, None, None], eye6, 0.0)
        g = torch.where(free[:, None], g, 0.0)
        Hd = H.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        return -torch.linalg.solve_ex(Hd, g.reshape(-1))[0].reshape(P, 6)

    return _gn_loop(poses, error, step, SE3.retract, iters, lambda0, stats)


def _block_cyclic_reduction(D: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the block-tridiagonal system T x = rhs by block cyclic
    reduction. D: (P, d, d) diagonal blocks; B: (P-1, d, d) super-diagonal
    blocks (T[i, i+1] = B[i], T[i+1, i] = B[i]^T); rhs: (P, d, R), R
    right-hand sides at once. Returns (P, d, R).

    Each round eliminates the odd unknowns: with G_j = D_j^-1 [A_j, C_j,
    b_j] for odd j (A: the sub-diagonal, C: the super-diagonal), the even
    rows keep a block-tridiagonal system in half as many unknowns; the odd
    ones come back from G on the way up. P is padded to a power of two
    with identity blocks."""
    P, d, R = D.shape[0], D.shape[1], rhs.shape[2]
    n = 1
    while n < P:
        n *= 2
    pad = n - P
    zero = D.new_zeros((1, d, d))
    A = torch.cat([zero, B.transpose(1, 2), D.new_zeros((pad, d, d))])
    C = torch.cat([B, zero, D.new_zeros((pad, d, d))])
    D = torch.cat([D, torch.eye(d, dtype=D.dtype, device=D.device).expand(pad, d, d)])
    b = torch.cat([rhs, rhs.new_zeros((pad, d, R))])
    rounds = []
    while D.shape[0] > 1:
        G = torch.linalg.solve_ex(D[1::2], torch.cat([A[1::2], C[1::2], b[1::2]], dim=-1))[0]
        # the even row 2m couples to the odd rows 2m-1 (G shifted down by
        # one, zero for m = 0) and 2m+1
        Gl = torch.cat([G.new_zeros((1,) + G.shape[1:]), G[:-1]])
        Lft = A[0::2] @ Gl
        Rgt = C[0::2] @ G
        D = D[0::2] - Lft[..., d : 2 * d] - Rgt[..., :d]
        A = -Lft[..., :d]
        C = -Rgt[..., d : 2 * d]
        b = b[0::2] - Lft[..., 2 * d :] - Rgt[..., 2 * d :]
        rounds.append(G)
    x = torch.linalg.solve_ex(D, b)[0]
    for G in reversed(rounds):
        # x_{2m+1} = Gb_m - GA_m x_{2m} - GC_m x_{2m+2} (x_n = 0)
        x_next = torch.cat([x[1:], x.new_zeros((1, d, R))])
        xo = G[..., 2 * d :] - G[..., : 2 * d] @ torch.cat([x, x_next], dim=1)
        x = torch.stack([x, xo], dim=1).reshape(-1, d, R)
    return x[:P]


def _chain_solver(g: _Group, P: int, free, chain_rel, chain_w, loop_i, loop_j, loop_rel, loop_w):
    """(error, step) of a chain + loops graph over group `g`: the chain's
    block-tridiagonal part T, the loop rows kept whole in the low-rank
    term U (T + U^T U is the Hessian), Levenberg damping on the total
    diagonal, and the step by Woodbury around one block solve of T with
    1 + d L right-hand sides."""
    d = g.dim
    dev = chain_rel.device
    li, lj = loop_i.long(), loop_j.long()
    L = li.shape[0]
    eye = torch.eye(d, dtype=chain_rel.dtype, device=dev)
    fi, fj = free[:-1], free[1:]
    link = (fi & fj)[:, None, None]
    onehot_i = (li[:, None] == torch.arange(P, device=dev)[None]).to(chain_rel.dtype)
    onehot_j = (lj[:, None] == torch.arange(P, device=dev)[None]).to(chain_rel.dtype)

    def error(ps):
        rc = _edge_residuals(g, ps[:-1], ps[1:], chain_rel, chain_w)
        rl = _edge_residuals(g, ps[li], ps[lj], loop_rel, loop_w)
        return 0.5 * (torch.sum(rc * rc) + torch.sum(rl * rl))

    def step(ps, lam):
        rc, Jci, Jcj = _edge_jacobians(g, ps[:-1], ps[1:], chain_rel, chain_w)
        Jci = Jci * fi[:, None, None]
        Jcj = Jcj * fj[:, None, None]
        JciT, JcjT = Jci.transpose(1, 2), Jcj.transpose(1, 2)
        # the chain's rows touch (i, i+1): no index repeats within a term
        D = torch.nn.functional.pad(JciT @ Jci, (0, 0, 0, 0, 0, 1)) + torch.nn.functional.pad(
            JcjT @ Jcj, (0, 0, 0, 0, 1, 0)
        )
        B = JciT @ Jcj  # (P-1, d, d) = T[i, i+1]
        gc_i = (JciT @ rc[..., None])[..., 0]
        gc_j = (JcjT @ rc[..., None])[..., 0]
        grad = torch.nn.functional.pad(gc_i, (0, 0, 0, 1)) + torch.nn.functional.pad(gc_j, (0, 0, 1, 0))

        rl, Jli, Jlj = _edge_jacobians(g, ps[li], ps[lj], loop_rel, loop_w)
        Jli = Jli * free[li][:, None, None]
        Jlj = Jlj * free[lj][:, None, None]
        lij = (torch.cat([li, lj]),)
        schur._scatter_add(
            grad, lij,
            torch.cat([(Jli.transpose(1, 2) @ rl[..., None])[..., 0], (Jlj.transpose(1, 2) @ rl[..., None])[..., 0]]),
        )
        # damping on the total diagonal (chain + loop rows), as the dense
        # path's Levenberg scaling
        diag_loop = torch.zeros((P,), dtype=D.dtype, device=dev)
        schur._scatter_add(diag_loop, lij, torch.cat([(Jli * Jli).sum((1, 2)), (Jlj * Jlj).sum((1, 2))]))
        trace = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) + diag_loop
        D = D + (lam * torch.clamp(trace / d, min=1e-8))[:, None, None] * eye
        D = torch.where(free[:, None, None], D, eye)  # clamped poses: identity rows
        B = torch.where(link, B, 0.0)

        # Woodbury: U (d L, d P) has two nonzero dxd blocks per loop edge
        U4 = onehot_i[:, :, None, None] * Jli[:, None] + onehot_j[:, :, None, None] * Jlj[:, None]
        UT = U4.permute(1, 3, 0, 2).reshape(P, d, d * L)
        sol = _block_cyclic_reduction(D, B, torch.cat([grad[:, :, None], UT], dim=2))
        x_g, X_U = sol[:, :, 0], sol[:, :, 1:].reshape(P * d, d * L)
        U_flat = U4.permute(0, 2, 1, 3).reshape(d * L, d * P)
        S = torch.eye(d * L, dtype=D.dtype, device=dev) + U_flat @ X_U
        corr = X_U @ torch.linalg.solve_ex(S, U_flat @ x_g.reshape(-1))[0]
        delta = -(x_g.reshape(-1) - corr).reshape(P, d)
        return torch.where(free[:, None], delta, 0.0)

    return error, step


def optimize_chain(
    poses: torch.Tensor,  # (P, 4, 4) cam-to-world, slots 0..n-1 live
    pose_valid: torch.Tensor,  # (P,) bool
    chain_rel: torch.Tensor,  # (P-1, 4, 4) measured T_i^-1 T_{i+1}
    chain_w: torch.Tensor,  # (P-1,) sqrt-information (0 = padding)
    loop_i: torch.Tensor,  # (L,) int
    loop_j: torch.Tensor,  # (L,) int
    loop_rel: torch.Tensor,  # (L, 4, 4)
    loop_w: torch.Tensor,  # (L,) sqrt-information (0 = padding)
    iters: int = 25,
    lambda0: float = 1e-6,
    stats: list | None = None,
):
    """Damped Gauss-Newton over a chain + loops pose graph in O(P) per
    iteration (see the module docstring); pose 0 fixed. Returns (optimized
    poses, final error), the contract of :func:`optimize`."""
    P = poses.shape[0]
    free = pose_valid & (torch.arange(P, device=poses.device) > 0)
    error, step = _chain_solver(SE3, P, free, chain_rel, chain_w, loop_i, loop_j, loop_rel, loop_w)
    return _gn_loop(poses, error, step, SE3.retract, iters, lambda0, stats)


def optimize_sim3_chain(
    poses: torch.Tensor,  # (P, 4, 4) cam-to-world SE(3), slots 0..n-1 live
    pose_valid: torch.Tensor,  # (P,) bool
    chain_rel: torch.Tensor,  # (P-1, 4, 4) measured Sim(3) (scale 1 from the estimates)
    chain_w: torch.Tensor,  # (P-1,) sqrt-information (0 = padding)
    loop_i: torch.Tensor,  # (L,) int
    loop_j: torch.Tensor,  # (L,) int
    loop_rel: torch.Tensor,  # (L, 4, 4) measured Sim(3) relative transforms
    loop_w: torch.Tensor,  # (L,) sqrt-information (0 = padding)
    iters: int = 25,
    lambda0: float = 1e-6,
    stats: list | None = None,
):
    """Damped Gauss-Newton over a Sim(3) chain + loops graph, states
    started at scale 1 from the SE(3) poses, pose 0 fixed. Returns
    (optimized Sim(3) states (P, 4, 4), final error): the corrected
    camera poses are ``sim3.to_se3(S)``, the landmarks take the full delta
    ``S' @ inverse(S)``."""
    P = poses.shape[0]
    free = pose_valid & (torch.arange(P, device=poses.device) > 0)
    error, step = _chain_solver(SIM3, P, free, chain_rel, chain_w, loop_i, loop_j, loop_rel, loop_w)
    return _gn_loop(sim3.from_se3(poses), error, step, SIM3.retract, iters, lambda0, stats)
