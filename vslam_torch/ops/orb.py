"""ORB-style oriented BRIEF from pre-extracted 31x31 patches (port of
vslam_tpu/ops/orb.py).

The BRIEF pattern is the reference's own seeded numpy pattern, so the bits
agree with vslam_tpu. Sampling is the gather form
(``brief_from_patches_gather``, orb.py:161-172); the TPU's one-hot MXU
einsum (orb.py:129-158) exists only because a gather scalarizes on a TPU.
Rounding is half-to-even in both libraries (``torch.round`` /
``jnp.round``).

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


def _rotated_pattern(angle: torch.Tensor):
    """Rounded in-patch sample coords of both pattern points rotated by each
    keypoint's angle. Returns four (..., N, 256) int64."""
    pat = _pattern_f32(angle.device)
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

    def rot(px, py):
        rx = torch.round(px * ca - py * sa).long()
        ry = torch.round(px * sa + py * ca).long()
        return rx.add(HALF).clamp(0, PATCH - 1), ry.add(HALF).clamp(0, PATCH - 1)

    r1x, r1y = rot(x1, y1)
    r2x, r2y = rot(x2, y2)
    return r1x, r1y, r2x, r2y


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
