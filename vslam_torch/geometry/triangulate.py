"""Batched multi-view triangulation (DLT) + reprojection validation (port
of vslam_tpu/geometry/triangulate.py).

For C candidates x V views: the DLT system from the masked observations,
the smallest eigenvector of the 4x4 normal matrix A^T A per candidate, a
3-step Gauss-Newton polish, and the reference's checkReprojError gate
(src/OptimizationBA.cpp:14-88). Views are world->pixel matrices P = K [R|t];
a stereo observation contributes the right camera as an extra view.
"""

from __future__ import annotations

import torch

from vslam_torch.geometry import se3


def projection_matrices(
    T_wc: torch.Tensor, K: torch.Tensor, baseline_shift: torch.Tensor | None = None
) -> torch.Tensor:
    """(V, 3, 4) world->pixel matrices from (V, 4, 4) cam-to-world poses.
    baseline_shift: optional (V,) x-offsets (+baseline for the right camera
    of a rectified rig)."""
    Rt = se3.inverse(T_wc)[..., :3, :4]
    if baseline_shift is not None:
        Rt = Rt.clone()
        Rt[..., 0, 3] -= baseline_shift
    return torch.einsum("ij,vjk->vik", K, Rt)


def _per_candidate(P: torch.Tensor, C: int) -> torch.Tensor:
    return P.expand((C,) + P.shape) if P.ndim == 3 else P


def triangulate_dlt(
    P: torch.Tensor,  # (V, 3, 4) or (C, V, 3, 4)
    uv: torch.Tensor,  # (C, V, 2)
    view_mask: torch.Tensor,  # (C, V) bool
) -> torch.Tensor:
    """(C, 3) triangulated world points (garbage where < 2 views observe:
    filter with :func:`validate_triangulation`)."""
    P = _per_candidate(P, uv.shape[0])
    u, v = uv[..., 0:1], uv[..., 1:2]
    r0, r1, r2 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    A = torch.cat([u * r2 - r0, v * r2 - r1], dim=1)  # (C, 2V, 4)
    m = torch.cat([view_mask, view_mask], dim=1)[..., None]
    norm = torch.linalg.norm(A, dim=-1, keepdim=True)
    A = torch.where(m, A / torch.clamp(norm, min=1e-9), 0.0)
    AtA = torch.einsum("cri,crj->cij", A, A)
    # ascending eigenvalues in both libraries; the eigenvector's sign
    # cancels in X[:3] / X[3]
    X = torch.linalg.eigh(AtA)[1][..., 0]
    w = X[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
    return X[..., :3] / safe_w[..., None]


def refine_triangulation(
    pts_w: torch.Tensor,  # (C, 3)
    P: torch.Tensor,  # (V, 3, 4) or (C, V, 3, 4)
    uv: torch.Tensor,  # (C, V, 2)
    view_mask: torch.Tensor,  # (C, V)
    iters: int = 3,
) -> torch.Tensor:
    """Batched Gauss-Newton polish of the points on reprojection error
    (the refinement inside gtsam::triangulatePoint3). A singular 3x3
    system gives a non-finite step, which is dropped, as in the JAX
    version: ``solve_ex`` does not raise."""
    P = _per_candidate(P, uv.shape[0])
    A, a = P[..., :3], P[..., 3]
    eye = torch.eye(3, dtype=pts_w.dtype, device=pts_w.device)
    X = pts_w
    for _ in range(iters):
        p = torch.einsum("cvij,cj->cvi", A, X) + a
        z = p[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        uvhat = p[..., :2] / safe_z[..., None]
        r = uvhat - uv
        J = (A[..., :2, :] - uvhat[..., None] * A[..., 2:3, :]) / safe_z[..., None, None]
        Jm = torch.where(view_mask[..., None, None], J, 0.0)
        rm = torch.where(view_mask[..., None], r, 0.0)
        H = torch.einsum("cvri,cvrj->cij", Jm, Jm) + 1e-6 * eye
        b = torch.einsum("cvri,cvr->ci", Jm, rm)
        dX = torch.linalg.solve_ex(H, -b[..., None])[0][..., 0]
        X = X + torch.where(torch.isfinite(dX), dX, 0.0)
    return X


def validate_triangulation(
    pts_w: torch.Tensor,  # (C, 3)
    P: torch.Tensor,  # (V, 3, 4) or (C, V, 3, 4)
    uv: torch.Tensor,  # (C, V, 2)
    view_mask: torch.Tensor,  # (C, V)
    inv_sigma2: torch.Tensor,  # (C, V)
    chi2_thr: float = 7.815,
    min_views: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every observing view reprojects within chi2 at positive depth, and
    at least `min_views` views observe. Returns (ok (C,), chi2 (C, V))."""
    P = _per_candidate(P, uv.shape[0])
    Xh = torch.cat([pts_w, torch.ones_like(pts_w[..., :1])], dim=-1)
    proj = torch.einsum("cvij,cj->cvi", P, Xh)
    z = proj[..., 2]
    uvp = proj[..., :2] / torch.clamp(torch.abs(z[..., None]), min=1e-9)
    err = uvp - uv
    chi2 = torch.sum(err * err, dim=-1) * inv_sigma2
    good_view = view_mask & (z > 0.0) & (chi2 < chi2_thr)
    all_pass = torch.all(~view_mask | good_view, dim=-1)
    ok = all_pass & (torch.sum(view_mask, dim=-1) >= min_views)
    return ok, chi2
