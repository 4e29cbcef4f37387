"""Multi-level ORB extraction: pyramid -> FAST -> ANMS -> patch windows ->
orientation -> BRIEF (port of vslam_tpu/ops/extract.py).

The 31x31 patches of every level come from one call of
:func:`patches.extract_windows_levels`, the hand-written CUDA kernel on a
GPU tensor (one launch per batch, all levels).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from vslam_torch.ops import fast, orb, patches, pyramid


class Keys(NamedTuple):
    """Fixed-size keypoint SoA (the TrackedKeys analog)."""

    xy: torch.Tensor  # (..., N, 2) f32 level-0 pixel coords
    octave: torch.Tensor  # (..., N) int64
    response: torch.Tensor  # (..., N) f32
    valid: torch.Tensor  # (..., N) bool
    desc: torch.Tensor  # (..., N, 256) int8 +-1
    packed: torch.Tensor  # (..., N, 8) int64 words of 32 bits
    angle: torch.Tensor  # (..., N) f32 radians

    def select(self, i: int) -> "Keys":
        """The keys of image `i` of a batched extraction."""
        return Keys(*(a[i] for a in self))


def level_quotas(total: int, n_levels: int, scale: float) -> list[int]:
    """Geometric per-level quotas summing to `total` (reference
    src/FeatureExtractor.cpp:648-659)."""
    inv = 1.0 / scale
    first = total * (1.0 - inv) / (1.0 - inv**n_levels)
    quotas = [int(round(first * inv**l)) for l in range(n_levels - 1)]
    quotas.append(max(total - sum(quotas), 0))
    return quotas


class WindowInputs(NamedTuple):
    """What :func:`extract_batch` hands the window kernel, and the keys it
    describes: the blurred levels that own slots, their slot counts, the
    (B, N) int32 top-left corners, and per slot its level coordinates,
    response, validity, octave and scale^octave."""

    blurred: list
    counts: list
    x0: torch.Tensor
    y0: torch.Tensor
    xy_lvl: torch.Tensor  # (B, N, 2) int64 level coordinates
    response: torch.Tensor
    valid: torch.Tensor
    octave: torch.Tensor  # (N,) int64
    sf: torch.Tensor  # (N,) f32


def window_inputs(
    imgs: torch.Tensor,
    n_levels: int = 8,
    scale: float = 1.2,
    total: int = 2048,
    cell: int = 35,
    edge_margin: int = 19,
    fast_hi: float = 20.0,
    fast_lo: float = 7.0,
) -> WindowInputs:
    """The stages of :func:`extract_batch` before the patch windows: the
    pyramid, the blur of each level and FAST + ANMS per level quota."""
    B, H, W = imgs.shape
    dev = imgs.device
    shapes = pyramid.level_shapes(H, W, n_levels, scale)
    quotas = level_quotas(total, n_levels, scale)

    P = orb.PATCH
    half = P // 2

    cur = imgs
    xs, resps, valids, blurred, counts = [], [], [], [], []
    slot_level: list[int] = []
    for l in range(n_levels):
        h, w = shapes[l]
        if l > 0:
            cur = pyramid.resize_bilinear_batch(cur, h, w)
        quota = quotas[l]
        if quota <= 0:
            continue
        blurred.append(pyramid.gaussian_blur_batch(cur))
        margin = min(edge_margin, min(h, w) // 4)
        # ANMS cell adapted to the level quota (vslam_tpu/ops/extract.py:84-90)
        cell_l = max(8, min(cell, int((h * w / max(quota, 1)) ** 0.5)))
        xy, resp, valid = fast.detect(
            cur,
            threshold_hi=fast_hi,
            threshold_lo=fast_lo,
            cell=min(cell_l, max(h, w)),
            max_keypoints=quota,
            edge_margin=margin,
        )
        xs.append(xy)
        resps.append(resp)
        valids.append(valid)
        slot_level += [l] * quota
        counts.append(quota)

    xy_lvl = torch.cat(xs, dim=1)  # (B, N, 2) level coords
    lvl, sf, lim = _slot_tables(tuple(slot_level), scale, tuple(shapes), P, dev)
    # top-left corners of every slot, clipped into its level, as the JAX
    # extractor clips them per level (vslam_tpu/ops/extract.py:114-115)
    corner = torch.minimum((xy_lvl - half).clamp_(min=0), lim).to(torch.int32)
    x0, y0 = corner.permute(2, 0, 1).contiguous()  # (B, N) each
    return WindowInputs(blurred, counts, x0, y0, xy_lvl, torch.cat(resps, dim=1),
                        torch.cat(valids, dim=1), lvl, sf)


def extract_batch(
    imgs: torch.Tensor,
    n_levels: int = 8,
    scale: float = 1.2,
    total: int = 2048,
    cell: int = 35,
    edge_margin: int = 19,
    fast_hi: float = 20.0,
    fast_lo: float = 7.0,
) -> Keys:
    """Batched extraction over (B, H, W) float32 images (e.g. a stereo pair).
    All Keys fields carry a leading batch dim."""
    w = window_inputs(imgs, n_levels, scale, total, cell, edge_margin, fast_hi, fast_lo)
    P = orb.PATCH
    patch_all = patches.extract_windows_levels(w.blurred, w.counts, w.x0, w.y0, P, P)

    angle = orb.orientation_from_patches(patch_all)
    packed, signed = orb.brief_from_patches(patch_all, angle)

    B, N = w.x0.shape
    return Keys(
        xy=w.xy_lvl.to(torch.float32) * w.sf[None, :, None],
        octave=w.octave[None].expand(B, N),
        response=w.response,
        valid=w.valid,
        desc=signed,
        packed=packed,
        angle=angle,
    )


def extract(
    img: torch.Tensor,
    n_levels: int = 8,
    scale: float = 1.2,
    total: int = 2048,
    cell: int = 35,
    edge_margin: int = 19,
    fast_hi: float = 20.0,
    fast_lo: float = 7.0,
) -> Keys:
    """Single-image extraction on an (H, W) float32 image: :func:`extract_batch`
    with B=1 (one window-kernel launch on a GPU tensor), every field's row 0."""
    return extract_batch(
        img[None], n_levels=n_levels, scale=scale, total=total, cell=cell,
        edge_margin=edge_margin, fast_hi=fast_hi, fast_lo=fast_lo,
    ).select(0)


def scale_factors(n_levels: int = 8, scale: float = 1.2) -> np.ndarray:
    return np.array([scale**l for l in range(n_levels)], np.float32)


# Constant tables live on the device once (a host tensor per call would be
# a host->device copy, which synchronizes the stream).
@functools.lru_cache(maxsize=None)
def _slot_tables(slot_level: tuple, scale: float, shapes: tuple, P: int, device: torch.device):
    """Per key slot, on `device`: octave (int64), scale^octave (f32) and the
    largest top-left corner of a PxP window in its level, (w_l - P, h_l - P)
    (int64)."""
    lvl = np.array(slot_level, np.int64)
    sf = np.array([scale**l for l in slot_level], np.float32)
    lim = np.array([(shapes[l][1] - P, shapes[l][0] - P) for l in slot_level], np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (lvl, sf, lim))


@functools.lru_cache(maxsize=None)
def _scale_factors_dev(n_levels: int, scale: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(scale_factors(n_levels, scale)).to(device)


def inv_sigma2(octave: torch.Tensor, n_levels: int = 8, scale: float = 1.2) -> torch.Tensor:
    """Per-octave information weight 1/sigma^2 with sigma = scale^octave
    (reference src/FeatureTracker.cpp:239-240)."""
    sf = _scale_factors_dev(n_levels, scale, octave.device)
    s = sf[torch.clamp(octave, 0, n_levels - 1)]
    return 1.0 / (s * s)
