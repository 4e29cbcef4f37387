"""Batched stereo matching with sub-pixel disparity refinement (port of
vslam_tpu/ops/stereo_match.py; reference FeatureMatcher::findStereoMatchesORB2R,
src/FeatureMatcher.cpp:528-708).

The SAD windows are a plain gather here (the JAX package selects columns
with a one-hot einsum because a gather scalarizes on a TPU); the values are
the same. ``.at[best].min`` becomes ``scatter_reduce("amin")`` on an
INVALID-filled tensor.
"""

from __future__ import annotations

import torch

from vslam_torch.ops import hamming
from vslam_torch.ops.project_match import per_problem

DESC_THR = 75.0
SAD_RADIUS = 5
SAD_SLIDE = 5


def _gather_patch_rows(img, xc, yc, half_h, half_w):
    """(B, N, 2*half_h+1, 2*half_w+1) windows of (B, H, W) images at
    integer (B, N) centers: the row block is shifted (not clamped) to stay
    inside the image, each column index is clamped — the JAX version's
    semantics."""
    B, H, W = img.shape
    Ph = 2 * half_h + 1
    y0 = torch.clamp(yc - half_h, 0, H - Ph)
    rows = y0[..., None] + torch.arange(Ph, device=img.device)  # (B, N, Ph)
    dx = torch.arange(-half_w, half_w + 1, device=img.device)
    cols = torch.clamp(xc[..., None] + dx, 0, W - 1)  # (B, N, Pw)
    b = torch.arange(B, device=img.device)[:, None, None, None]
    return img[b, rows[..., :, None], cols[..., None, :]]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every problem b: (B, M, ...) by (B, N) -> (B, N, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def match_stereo(
    left_img: torch.Tensor,
    right_img: torch.Tensor,
    kl_xy: torch.Tensor,  # (N, 2) f32 level-0 coords
    kl_oct: torch.Tensor,  # (N,)
    kl_desc: torch.Tensor,  # (N, 256) int8 +-1
    kl_valid: torch.Tensor,  # (N,) bool
    kr_xy: torch.Tensor,
    kr_oct: torch.Tensor,
    kr_desc: torch.Tensor,
    kr_valid: torch.Tensor,
    fx: torch.Tensor,
    baseline: torch.Tensor,
    scale_factors: torch.Tensor,  # (n_levels,) scale^l
    close_factor: float = 40.0,
):
    """Returns a dict with per-left-key stereo results: ``idx_r`` (N,)
    matched right index or -1, ``disparity``, ``depth``, ``matched``,
    ``close``, ``est_right_x`` and ``desc_dist``.

    Batched: (B, H, W) images, (B, N, ...) keys and (B,) `fx` and
    `baseline` match B independent pairs at once (one per sequence of a
    batch); every output then has the leading B."""
    if left_img.ndim == 2:
        args = (left_img, right_img, kl_xy, kl_oct, kl_desc, kl_valid, kr_xy, kr_oct,
                kr_desc, kr_valid)
        out = match_stereo(*(a[None] for a in args), fx, baseline, scale_factors, close_factor)
        return {k: v[0] for k, v in out.items()}
    N = kl_xy.shape[1]
    M = kr_xy.shape[1]
    n_lv = scale_factors.shape[0]
    fx1, bl1 = per_problem(fx), per_problem(baseline)  # against (B, N)
    d = hamming.hamming_matrix(kl_desc, kr_desc, kl_valid, kr_valid)  # (B, N, M)

    row_tol = 2.0 * scale_factors[torch.clamp(kr_oct, 0, n_lv - 1)]
    dy = torch.abs(kl_xy[..., :, 1:2] - kr_xy[..., None, :, 1])
    row_ok = dy <= row_tol[..., None, :]
    oct_ok = torch.abs(kl_oct[..., :, None] - kr_oct[..., None, :]) <= 1
    disp = kl_xy[..., :, 0:1] - kr_xy[..., None, :, 0]
    max_disp = per_problem(fx, 2) * per_problem(baseline, 2) / 0.3  # depth >= 0.3 m
    disp_ok = (disp > 0.0) & (disp <= max_disp)
    d = torch.where(row_ok & oct_ok & disp_ok, d, hamming.INVALID)

    best = torch.argmin(d, dim=-1)  # first index on ties, as jnp.argmin
    best_d = torch.gather(d, -1, best[..., None])[..., 0]
    matched = best_d <= DESC_THR

    # one-to-one: a right key keeps only the left claimant with least distance
    claim_d = torch.where(matched, best_d, hamming.INVALID)
    min_per_right = torch.full(
        best.shape[:-1] + (M,), hamming.INVALID, device=d.device
    ).scatter_reduce(-1, best, claim_d, reduce="amin", include_self=True)
    matched = matched & (claim_d <= torch.gather(min_per_right, -1, best) + 1e-6)

    # ---- SAD refinement + parabolic sub-pixel (reference 606-643) ----
    xl = torch.round(kl_xy[..., 0]).long()
    yl = torch.round(kl_xy[..., 1]).long()
    kr_best = _take(kr_xy, best)
    xr = torch.round(kr_best[..., 0]).long()
    yr = torch.round(kr_best[..., 1]).long()
    lp = _gather_patch_rows(left_img, xl, yl, SAD_RADIUS, SAD_RADIUS)  # (B,N,11,11)
    rp = _gather_patch_rows(right_img, xr, yr, SAD_RADIUS, SAD_RADIUS + SAD_SLIDE)
    lc = lp[..., SAD_RADIUS, SAD_RADIUS][..., None, None]
    lpn = lp - lc
    sads = []
    for s in range(2 * SAD_SLIDE + 1):
        win = rp[..., :, s : s + 2 * SAD_RADIUS + 1]
        cc = win[..., SAD_RADIUS, SAD_RADIUS][..., None, None]
        sads.append(torch.sum(torch.abs(lpn - (win - cc)), dim=(-2, -1)))
    sad = torch.stack(sads, dim=-1)  # (B, N, 11) offsets -5..+5
    best_off = torch.argmin(sad, dim=-1)
    best_sad = torch.gather(sad, -1, best_off[..., None])[..., 0]
    off_c = torch.clamp(best_off, 1, 2 * SAD_SLIDE - 1)
    s_m = torch.gather(sad, -1, (off_c - 1)[..., None])[..., 0]
    s_0 = torch.gather(sad, -1, off_c[..., None])[..., 0]
    s_p = torch.gather(sad, -1, (off_c + 1)[..., None])[..., 0]
    denom = s_m - 2.0 * s_0 + s_p
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (s_m - s_p) / denom, 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    sub = off_c.to(torch.float32) + delta - SAD_SLIDE
    est_right_x = kr_best[..., 0] + sub
    disparity = kl_xy[..., 0] - est_right_x
    interior = (best_off >= 1) & (best_off <= 2 * SAD_SLIDE - 1)
    matched = matched & (disparity > 0.05) & interior

    depth = torch.where(matched, fx1 * bl1 / torch.clamp(disparity, min=1e-6), 0.0)

    # ---- statistical prunes (reference 679-705), per pair ----
    n_match = torch.clamp(torch.sum(matched, dim=-1, keepdim=True), min=1)
    inf = float("inf")
    sort_depth = torch.sort(torch.where(matched, depth, inf), dim=-1).values
    k1 = torch.clamp((n_match * 1) // 100, 0, N - 1)
    depth_cut = torch.gather(sort_depth, -1, k1)
    sort_sad = torch.sort(torch.where(matched, best_sad, inf), dim=-1).values
    med_sad = torch.gather(sort_sad, -1, torch.clamp(n_match // 2, 0, N - 1))
    sad_ok = best_sad <= 1.5 * 1.4 * med_sad + 1e-6
    matched = matched & (depth >= depth_cut) & sad_ok

    close = matched & (depth < close_factor * bl1) & (depth > 0)
    return {
        "idx_r": torch.where(matched, best, -1),
        "disparity": torch.where(matched, disparity, 0.0),
        "depth": torch.where(matched, depth, 0.0),
        "matched": matched,
        "close": close,
        "est_right_x": torch.where(matched, est_right_x, 0.0),
        "desc_dist": best_d,
    }
