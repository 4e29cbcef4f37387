"""Projection-guided landmark-to-keypoint matching (port of
vslam_tpu/ops/project_match.py; reference FeatureMatcher::matchByProjection*,
src/FeatureMatcher.cpp:66-526).

The full (M landmarks x N keys) Hamming matrix is one matmul; the spatial,
octave and radius gates are elementwise masks on it. Contracts: radius
scaled by the predicted octave, octave within +-1, descriptor threshold,
best/second-best ratio test, one-to-one claiming.
"""

from __future__ import annotations

import torch

from vslam_torch.geometry import se3
from vslam_torch.ops import hamming


def match_by_projection(
    mp_pred: torch.Tensor,  # (..., M, 2) predicted pixel positions
    mp_oct: torch.Tensor,  # (..., M) predicted octave
    mp_desc: torch.Tensor,  # (..., M, 256) int8 +-1
    mp_valid: torch.Tensor,  # (..., M) bool
    k_xy: torch.Tensor,  # (..., N, 2) keypoint positions (level-0 coords)
    k_oct: torch.Tensor,  # (..., N)
    k_desc: torch.Tensor,  # (..., N, 256)
    k_valid: torch.Tensor,  # (..., N)
    radius: float,  # search radius in px (octave-scaled)
    scale_factors: torch.Tensor,  # (n_levels,)
    desc_thr: float,  # e.g. 100.0
    ratio: float,  # e.g. 0.8
):
    """Returns (match_idx (..., M) into keys or -1, dist (..., M) f32).
    Leading dimensions index independent problems (one per sequence of a
    batch); the radius and thresholds are shared."""
    d = hamming.hamming_matrix(mp_desc, k_desc, mp_valid, k_valid)  # (..., M, N)

    r = radius * scale_factors[torch.clamp(mp_oct, 0, scale_factors.shape[0] - 1)]
    diff = mp_pred[..., :, None, :] - k_xy[..., None, :, :]
    dist2 = torch.sum(diff * diff, dim=-1)
    spatial_ok = dist2 <= (r * r)[..., None]
    oct_ok = torch.abs(k_oct[..., None, :] - mp_oct[..., :, None]) <= 1
    d = torch.where(spatial_ok & oct_ok, d, hamming.INVALID)

    best = torch.argmin(d, dim=-1)
    best_d = torch.gather(d, -1, best[..., None])[..., 0]
    # second best for the ratio test
    d2 = d.scatter(-1, best[..., None], hamming.INVALID)
    second_d = torch.amin(d2, dim=-1)
    ok = (best_d <= desc_thr) & (best_d < ratio * second_d) & mp_valid

    # one-to-one: each key keeps the lowest-distance landmark claimant
    N = k_xy.shape[-2]
    claim = torch.where(ok, best_d, hamming.INVALID)
    min_per_key = torch.full(
        best.shape[:-1] + (N,), hamming.INVALID, device=d.device
    ).scatter_reduce(-1, best, claim, reduce="amin", include_self=True)
    ok = ok & (claim <= torch.gather(min_per_key, -1, best) + 1e-6)
    return torch.where(ok, best, -1), torch.where(ok, best_d, hamming.INVALID)


def per_problem(x, nd: int = 1):
    """A per-problem scalar (a (B,) tensor) with `nd` trailing unit
    dimensions, to broadcast against (B, ...) operands; a 0-d tensor or a
    Python number (one problem, or one value for all) as it is."""
    if isinstance(x, torch.Tensor) and x.ndim:
        return x.reshape(x.shape + (1,) * nd)
    return x


def predict_and_cull(
    T_wc: torch.Tensor,  # (..., 4, 4) predicted camera pose (left, cam-to-world)
    pts_w: torch.Tensor,  # (..., M, 3)
    mp_valid: torch.Tensor,  # (..., M)
    K: torch.Tensor,  # (..., 3, 3)
    baseline,  # scalar or (B,)
    width: int,
    height: int,
    max_dist: torch.Tensor,  # (..., M) per-landmark max scale distance
    min_dist: torch.Tensor,  # (..., M) min scale distance
    n_levels: int = 8,
    log_scale: float = 0.1823215568,  # ln(1.2)
):
    """Project landmarks into the predicted frame; cull out-of-frame or
    out-of-scale-band points and predict the pyramid octave (reference
    removeOutOfFrameMPs + worldToFrame + MapPoint::predictScale). Returns a
    dict with pred_l, pred_r (..., M, 2), in_l/in_r (..., M) bool,
    pred_oct (..., M), depth (..., M). A leading batch dimension on the
    pose, points and intrinsics solves one problem per batch entry."""
    T_cw = se3.inverse(T_wc)
    pc = se3.transform_points(T_cw, pts_w)
    z = pc[..., 2]
    fx, fy = per_problem(K[..., 0, 0]), per_problem(K[..., 1, 1])
    cx, cy = per_problem(K[..., 0, 2]), per_problem(K[..., 1, 2])
    baseline = per_problem(baseline)
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u_l = fx * pc[..., 0] / zs + cx
    v_l = fy * pc[..., 1] / zs + cy
    u_r = fx * (pc[..., 0] - baseline) / zs + cx

    dist = torch.linalg.norm(pc, dim=-1)
    in_front = z > 0.0
    in_bounds_l = (u_l >= 0) & (u_l < width) & (v_l >= 0) & (v_l < height)
    in_bounds_r = (u_r >= 0) & (u_r < width) & (v_l >= 0) & (v_l < height)
    band_ok = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    in_l = mp_valid & in_front & in_bounds_l & band_ok
    in_r = mp_valid & in_front & in_bounds_r & band_ok

    # predictScale: octave = ceil(log(maxDist / dist) / log(scale))
    ratio = torch.clamp(max_dist, min=1e-6) / torch.clamp(dist, min=1e-6)
    oct_f = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6)) / log_scale)
    pred_oct = torch.clamp(oct_f, 0, n_levels - 1).long()

    return {
        "pred_l": torch.stack([u_l, v_l], dim=-1),
        "pred_r": torch.stack([u_r, v_l], dim=-1),
        "in_l": in_l,
        "in_r": in_r,
        "pred_oct": pred_oct,
        "depth": z,
    }
