"""Hamming distance matrices (port of vslam_tpu/ops/hamming.py).

With descriptors as +-1 vectors, dot(a, b) = 256 - 2 * hamming(a, b), so
one (N, 256) x (256, M) float32 matmul gives every distance at once. The
products and sums are small integers, exact in float32 (TF32 is off, see
vslam_torch/__init__.py). :func:`packed_hamming` is the popcount oracle.

Packed words are int64 holding 32 bits each (see ops/orb.py).
"""

from __future__ import annotations

import numpy as np
import torch

N_BITS = 256
INVALID = 1e9  # distance assigned to masked-out pairs


def hamming_matrix(
    a_signed: torch.Tensor,
    b_signed: torch.Tensor,
    a_valid: torch.Tensor | None = None,
    b_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N, 256) x (M, 256) +-1 descriptors -> (N, M) float32 Hamming
    distances; invalid rows/cols get INVALID."""
    dot = a_signed.to(torch.float32) @ b_signed.to(torch.float32).T
    d = (N_BITS - dot) * 0.5
    if a_valid is not None:
        d = torch.where(a_valid[:, None], d, INVALID)
    if b_valid is not None:
        d = torch.where(b_valid[None, :], d, INVALID)
    return d


def unpack_signed(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) packed words -> (..., 256) int8 +-1. Bit b of word w is
    descriptor bit w*32+b (ops/orb._pack_bits)."""
    shifts = torch.arange(32, device=packed.device)
    bits = (packed.long()[..., :, None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], N_BITS)
    return (bits * 2 - 1).to(torch.int8)


def unpack_signed_np(packed: np.ndarray) -> np.ndarray:
    """Host-side numpy twin of :func:`unpack_signed`: (..., 8) packed words
    (int64 or uint32 holding 32 bits each) -> (..., 256) int8 +-1."""
    p = np.asarray(packed).astype(np.int64)
    bits = (p[..., :, None] >> np.arange(32, dtype=np.int64)) & 1
    bits = bits.reshape(*p.shape[:-1], N_BITS)
    return (bits * 2 - 1).astype(np.int8)


def pack_signed(signed: torch.Tensor) -> torch.Tensor:
    """(..., 256) +-1 (or 0/1) descriptors -> (..., 8) int64 packed words
    (inverse of :func:`unpack_signed`)."""
    bits = (signed > 0).long()
    words = bits.reshape(*bits.shape[:-1], 8, 32)
    shifts = torch.arange(32, device=signed.device)
    return torch.sum(words << shifts, dim=-1)


def packed_hamming(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """Reference-semantics popcount distance for (N, 8) x (M, 8) packed
    descriptors -> (N, M) int64 (SWAR popcount on 32-bit words)."""
    x = a_packed.long()[:, None, :] ^ b_packed.long()[None, :, :]
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return torch.sum(x, dim=-1)
