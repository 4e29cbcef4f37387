"""FAST-9/16 corner detection + 3x3 NMS + grid ANMS (port of
vslam_tpu/ops/fast.py), batched over a leading image dimension.

Selection semantics are the reference's exactly, including ties:
``jax.lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` makes no such promise, so every top-k here is a stable
descending sort (uint8-derived FAST margins tie often).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (the 16 FAST offsets, clockwise from 12h).
_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)  # (dx, dy)

ARC_LEN = 9  # FAST 9-16 variant (OpenCV default used by the reference)


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis; equal values keep ascending index order
    (the ``jax.lax.top_k`` contract)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _shifted_ring(img: torch.Tensor) -> torch.Tensor:
    """(16, B, H, W) ring neighbors via a replicate-padded image."""
    _, H, W = img.shape
    p = 3
    padded = F.pad(img[:, None], (p, p, p, p), mode="replicate")[:, 0]
    views = [
        padded[:, p + int(dy) : p + int(dy) + H, p + int(dx) : p + int(dx) + W]
        for dx, dy in _CIRCLE
    ]
    return torch.stack(views, dim=0)


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(B, H, W) per-pixel FAST-9/16 corner score (0 where not a corner):
    the largest margin m such that some contiguous arc of >= 9 ring pixels
    is all brighter than p+m (or all darker than p-m)."""
    ring = _shifted_ring(img)
    d_bright = ring - img[None]
    d_dark = -d_bright

    def arc_margin(d: torch.Tensor) -> torch.Tensor:
        dd = torch.cat([d, d[: ARC_LEN - 1]], dim=0)  # (24, B, H, W)
        m = None
        for k in range(16):
            w = torch.amin(dd[k : k + ARC_LEN], dim=0)
            m = w if m is None else torch.maximum(m, w)
        return m

    margin = torch.maximum(arc_margin(d_bright), arc_margin(d_dark))
    score = torch.where(margin > threshold, margin, 0.0)
    _, H, W = img.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inside = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(inside, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only 3x3 local maxima (strict against earlier neighbors, so a
    tie keeps the lexicographically first pixel)."""
    _, H, W = score.shape
    p = F.pad(score, (1, 1, 1, 1), mode="constant", value=-1.0)
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = p[:, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            if (dy, dx) < (0, 0):
                keep = keep & (score > n)
            else:
                keep = keep & (score >= n)
    return torch.where(keep, score, 0.0)


def select_keypoints(
    score: torch.Tensor,
    cell: int = 36,
    max_keypoints: int = 512,
    edge_margin: int = 19,
    per_cell: int = 4,
):
    """Grid ANMS over (B, H, W) scores: per-cell top-`per_cell`, then a
    global top-k ranked strong tier > coverage rank > response (see
    vslam_tpu/ops/fast.py:select_keypoints for why).

    Returns (xy (B, K, 2) int64, response (B, K) f32, valid (B, K) bool),
    K = max_keypoints, sorted by descending selection priority."""
    B, H, W = score.shape
    dev = score.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inside = (
        (ys >= edge_margin)
        & (ys < H - edge_margin)
        & (xs >= edge_margin)
        & (xs < W - edge_margin)
    )
    score = torch.where(inside, score, 0.0)

    gh = -(-H // cell)
    gw = -(-W // cell)
    padded = F.pad(score, (0, gw * cell - W, 0, gh * cell - H))
    cells = padded.reshape(B, gh, cell, gw, cell).permute(0, 1, 3, 2, 4).reshape(
        B, gh * gw, cell * cell
    )
    cs, ci = _topk_stable(cells, per_cell)  # (B, ncell, per_cell)
    cy = ci // cell
    cx = ci % cell
    g = torch.arange(gh * gw, device=dev)[:, None]
    py = (g // gw) * cell + cy
    px = (g % gw) * cell + cx

    rank = torch.arange(per_cell, device=dev, dtype=torch.float32)
    RANK_BONUS = float(1 << 14)  # > any boosted response (~1280)
    STRONG_BONUS = float(1 << 20)  # > max rank bonus (3 << 14)
    strong = (cs > 1024.0).to(cs.dtype)  # detect()'s boost marker
    sel = torch.where(
        cs > 0.0,
        cs + (per_cell - 1 - rank) * RANK_BONUS + strong * STRONG_BONUS,
        0.0,
    )
    flat_sel = sel.reshape(B, -1)
    flat_s = cs.reshape(B, -1)
    flat_y = py.reshape(B, -1)
    flat_x = px.reshape(B, -1)
    k = min(max_keypoints, flat_s.shape[1])
    _, top_i = _topk_stable(flat_sel, k)
    top_s = torch.gather(flat_s, 1, top_i)  # raw (boosted) response
    out_y = torch.gather(flat_y, 1, top_i)
    out_x = torch.gather(flat_x, 1, top_i)
    valid = top_s > 0.0
    if k < max_keypoints:
        pad = max_keypoints - k
        top_s = F.pad(top_s, (0, pad))
        out_y = F.pad(out_y, (0, pad))
        out_x = F.pad(out_x, (0, pad))
        valid = F.pad(valid, (0, pad))
    xy = torch.stack([out_x, out_y], dim=-1)
    return xy, top_s, valid


def detect(
    img: torch.Tensor,
    threshold_hi: float = 20.0,
    threshold_lo: float = 7.0,
    cell: int = 36,
    max_keypoints: int = 512,
    edge_margin: int = 19,
    per_cell: int = 4,
):
    """Per-level detection on (B, H, W): dual-threshold score (strong
    corners carry a +1024 boost through selection) + NMS + grid ANMS."""
    s_lo = fast_score(img, threshold_lo)
    s = nms3x3(s_lo)
    boosted = torch.where(s > threshold_hi, s + 1024.0, s)
    xy, resp, valid = select_keypoints(
        boosted,
        cell=cell,
        max_keypoints=max_keypoints,
        edge_margin=edge_margin,
        per_cell=per_cell,
    )
    resp = torch.where(resp > 1024.0, resp - 1024.0, resp)
    return xy, resp, valid
