"""ORB-style oriented BRIEF from pre-extracted 31x31 patches (port of
vslam_tpu/ops/orb.py).

The BRIEF pattern is the reference's own seeded numpy pattern, so the bits
agree with vslam_tpu. Sampling is the gather form
(``brief_from_patches_gather``, orb.py:161-172); the TPU's one-hot MXU
einsum (orb.py:129-158) exists only because a gather scalarizes on a TPU.
Rounding is half-to-even in both libraries (``torch.round`` /
``jnp.round``).

The image-space forms (:func:`gather_patches`, :func:`orientations`,
:func:`brief_descriptors`) read a level image at keypoints and clamp every
sampled pixel into it; the extractor's windows
(``ops/patches.extract_windows_levels``) clamp a window's top-left corner
instead, so the two agree only for keys at least 15 px inside the image.

Packed descriptors are (..., 8) int64 words holding 32 bits each (the JAX
package uses uint32; torch has no general uint32 arithmetic).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PATCH = 31
HALF = PATCH // 2  # 15
N_BITS = 256


@functools.lru_cache(maxsize=None)
def _umax_table() -> np.ndarray:
    """Circular-patch row extents for radius 15 (intensity centroid mask)."""
    umax = np.zeros(HALF + 2, dtype=np.int32)
    vmax = int(np.floor(HALF * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF * HALF - v * v)))
    v0 = 0
    for v in range(HALF, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@functools.lru_cache(maxsize=None)
def _centroid_weights(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask * dx, mask * dy) over the 31x31 patch, float32, on `device`
    (built once per device: no host copy per call)."""
    umax = _umax_table()
    dy, dx = np.mgrid[-HALF : HALF + 1, -HALF : HALF + 1]
    mask = (np.abs(dx) <= umax[np.clip(np.abs(dy), 0, HALF)]).astype(np.float32)
    wx, wy = mask * dx.astype(np.float32), mask * dy.astype(np.float32)
    return torch.from_numpy(wx).to(device), torch.from_numpy(wy).to(device)


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int32 sample-pair offsets (x1, y1, x2, y2); the same numpy
    construction as vslam_tpu/ops/orb.py:brief_pattern."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(N_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    lim = 13.0
    scale = np.minimum(1.0, lim / np.maximum(norm, 1e-6))
    pts = np.round(pts * scale).astype(np.int32)
    return pts.reshape(N_BITS, 4)


@functools.lru_cache(maxsize=None)
def _pattern_f32(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(brief_pattern().astype(np.float32)).to(device)


def gather_patches(img: torch.Tensor, xy: torch.Tensor, size: int = PATCH) -> torch.Tensor:
    """(N, size, size) patches of the (H, W) image centred at integer
    keypoints xy (N, 2); every pixel is clamped into the image."""
    H, W = img.shape
    d = torch.arange(-(size // 2), size // 2 + 1, device=img.device)
    ys = (xy[:, 1, None].long() + d).clamp(0, H - 1)  # (N, size)
    xs = (xy[:, 0, None].long() + d).clamp(0, W - 1)
    return img[ys[:, :, None], xs[:, None, :]]


def orientations(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (radians) per keypoint over the circular
    31-px patch of the image (reference src/FeatureExtractor.cpp:315-340)."""
    return orientation_from_patches(gather_patches(img, xy))


def orientation_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10) over the circular patch,
    from (..., 31, 31) patches."""
    wx, wy = _centroid_weights(patches.device)
    m10 = torch.sum(patches * wx, dim=(-2, -1))
    m01 = torch.sum(patches * wy, dim=(-2, -1))
    return torch.atan2(m01, m10)


def _pack_bits(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 256) {0,1} int64 -> (packed (..., 8) int64, signed (..., 256) int8)."""
    words = bits.reshape(*bits.shape[:-1], 8, 32)
    shifts = torch.arange(32, device=bits.device)
    packed = torch.sum(words << shifts, dim=-1)
    signed = (bits * 2 - 1).to(torch.int8)
    return packed, signed


def _rotated_offsets(angle: torch.Tensor):
    """Both pattern points rotated by each keypoint's angle and rounded to
    whole pixels, relative to the keypoint. Returns four (..., N, 256) int64."""
    pat = _pattern_f32(angle.device)
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

    def rot(px, py):
        return torch.round(px * ca - py * sa).long(), torch.round(px * sa + py * ca).long()

    return (*rot(x1, y1), *rot(x2, y2))


def _rotated_pattern(angle: torch.Tensor):
    """Rounded in-patch sample coords of both pattern points rotated by each
    keypoint's angle. Returns four (..., N, 256) int64."""
    return tuple(r.add(HALF).clamp(0, PATCH - 1) for r in _rotated_offsets(angle))


def brief_from_patches(
    patches: torch.Tensor, angle: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotated BRIEF sampled inside (..., N, 31, 31) patches by a gather.
    Returns (packed (..., N, 8) int64, signed (..., N, 256) int8)."""
    r1x, r1y, r2x, r2y = _rotated_pattern(angle)
    flat = patches.reshape(*patches.shape[:-2], PATCH * PATCH)
    i1 = torch.gather(flat, -1, r1y * PATCH + r1x)
    i2 = torch.gather(flat, -1, r2y * PATCH + r2x)
    return _pack_bits((i1 < i2).long())


def brief_from_patches_gather(
    patches: torch.Tensor, angle: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle for :func:`brief_from_patches` (the same bits), indexing each
    patch by (row, column) rather than gathering its flattened pixels."""
    r1x, r1y, r2x, r2y = _rotated_pattern(angle)
    lead = torch.meshgrid(*(torch.arange(n, device=patches.device) for n in angle.shape), indexing="ij")
    lead = tuple(i[..., None] for i in lead)  # broadcast over the 256 pairs
    i1 = patches[(*lead, r1y, r1x)]
    i2 = patches[(*lead, r2y, r2x)]
    return _pack_bits((i1 < i2).long())


def brief_descriptors(
    blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotated-BRIEF bits read straight from the blurred (H, W) level image:
    offsets rotated by the keypoint angle, rounded to whole pixels, each
    sample clamped into the image; bit = I(p + o1) < I(p + o2) (reference
    src/FeatureExtractor.cpp:268-313). xy: (N, 2) integer level coords;
    angle: (N,) radians. Returns (packed (N, 8) int64, signed (N, 256) int8)."""
    H, W = blurred.shape
    r1x, r1y, r2x, r2y = _rotated_offsets(angle)
    x, y = xy[:, 0:1].long(), xy[:, 1:2].long()
    i1 = blurred[(y + r1y).clamp(0, H - 1), (x + r1x).clamp(0, W - 1)]
    i2 = blurred[(y + r2y).clamp(0, H - 1), (x + r2x).clamp(0, W - 1)]
    return _pack_bits((i1 < i2).long())
