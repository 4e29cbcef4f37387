"""Batched patch-window extraction at runtime corners (port of
vslam_tpu/ops/patches.py, the repo's one Pallas kernel).

:func:`extract_windows_levels` cuts the windows of every pyramid level of a
batch in one launch of the hand-written CUDA kernel
(``kernels/csrc/extract_windows.cu``); :func:`extract_windows` is the same
kernel on one level. For a CPU tensor both use their plain PyTorch versions
(:func:`extract_windows_levels_ref`, :func:`extract_windows_ref`). There is
no other path: a CUDA tensor reaches the kernel or raises.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from vslam_torch import kernels

LAUNCHES = 0
MAX_LEVELS = 16  # kMaxLevels of the kernel's level table


def extract_windows_ref(
    img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, P: int, Pw: int
) -> torch.Tensor:
    """Plain advanced-index gather (the twin of the JAX CPU path,
    vslam_tpu/ops/patches.py:111-119). Corners are clamped into the image
    exactly as the kernel clamps them."""
    B, h, w = img.shape
    x0, y0 = x0.long().clamp(0, w - Pw), y0.long().clamp(0, h - P)
    ys = y0[..., None] + torch.arange(P, device=img.device)  # (B, q, P)
    xs = x0[..., None] + torch.arange(Pw, device=img.device)  # (B, q, Pw)
    b = torch.arange(B, device=img.device)[:, None, None, None]
    return img[b, ys[..., :, None], xs[..., None, :]]


def extract_windows_levels_ref(
    levels: Sequence[torch.Tensor],
    counts: Sequence[int],
    x0: torch.Tensor,
    y0: torch.Tensor,
    P: int,
    Pw: int,
) -> torch.Tensor:
    """Plain version of :func:`extract_windows_levels`: the per-level gather
    over the level table, in slot order."""
    parts, first = [], 0
    for img, q in zip(levels, counts):
        if q:
            sl = slice(first, first + q)
            parts.append(extract_windows_ref(img, x0[:, sl], y0[:, sl], P, Pw))
        first += q
    if not parts:
        return x0.new_empty((*x0.shape, P, Pw), dtype=torch.float32)
    return torch.cat(parts, dim=1)


def _check(levels, counts, x0, y0, P, Pw):
    if x0.ndim != 2 or x0.shape != y0.shape or len(levels) != len(counts):
        raise ValueError(
            f"extract_windows: x0/y0 (B, N) and one count per level; got "
            f"{tuple(x0.shape)}, {tuple(y0.shape)}, {len(levels)} levels, {len(counts)} counts"
        )
    if sum(counts) != x0.shape[1] or min(counts, default=0) < 0:
        raise ValueError(f"extract_windows: counts {list(counts)} do not cover {x0.shape[1]} slots")
    for img, q in zip(levels, counts):
        if not q:
            continue
        if img.ndim != 3 or img.shape[0] != x0.shape[0]:
            raise ValueError(
                f"extract_windows: level images (B, h, w) with B = {x0.shape[0]}; got {tuple(img.shape)}"
            )
        if img.shape[1] < P or img.shape[2] < Pw:
            raise ValueError(f"extract_windows: {P}x{Pw} window larger than {tuple(img.shape[1:])}")
        if img.device != x0.device:
            raise ValueError("extract_windows: level images and corners on different devices")
    if y0.device != x0.device:
        raise ValueError("extract_windows: x0 and y0 on different devices")


def extract_windows_levels(
    levels: Sequence[torch.Tensor],
    counts: Sequence[int],
    x0: torch.Tensor,
    y0: torch.Tensor,
    P: int,
    Pw: int,
) -> torch.Tensor:
    """(B, N, P, Pw) windows of every level in one launch: slot s of level l
    (the slots of a level are contiguous, levels in order, ``counts[l]``
    each) is ``levels[l][b, y0:y0+P, x0:x0+Pw]`` at its corner.

    levels: (B, h_l, w_l) float32 images. x0/y0: (B, N) int32 TOP-LEFT
    corners, N = sum(counts); each is clamped into its level image."""
    global LAUNCHES
    _check(levels, counts, x0, y0, P, Pw)
    dev = x0.device
    if dev.type == "cpu":
        return extract_windows_levels_ref(levels, counts, x0, y0, P, Pw)
    if dev.type != "cuda":
        raise ValueError(f"extract_windows: unsupported device {dev}")
    if x0.dtype != torch.int32 or y0.dtype != torch.int32:
        raise TypeError(f"extract_windows: want int32 corners; got {x0.dtype}, {y0.dtype}")
    if not (x0.is_contiguous() and y0.is_contiguous()):
        raise ValueError("extract_windows: corners must be contiguous")
    table, first = [], 0
    for img, q in zip(levels, counts):
        if q:
            if img.dtype != torch.float32:
                raise TypeError(f"extract_windows: want f32 level images; got {img.dtype}")
            if not img.is_contiguous():
                raise ValueError("extract_windows: level images must be contiguous")
            table += [img.data_ptr(), img.shape[1], img.shape[2], first]
        first += q
    if len(table) > 4 * MAX_LEVELS:
        raise ValueError(f"extract_windows: more than {MAX_LEVELS} levels own slots")
    B, N = x0.shape
    out = torch.empty((B, N, P, Pw), dtype=torch.float32, device=dev)
    if B * N == 0:
        return out
    lib = kernels.library()
    args = (
        (ctypes.c_int64 * len(table))(*table), len(table) // 4,
        x0.data_ptr(), y0.data_ptr(), out.data_ptr(), B, N, P, Pw,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if dev.index == torch.cuda.current_device():
        rc = lib.extract_windows_levels_f32(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.extract_windows_levels_f32(*args)
    kernels.check(rc, "extract_windows_levels_f32")
    LAUNCHES += 1
    return out


def extract_windows(
    img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, P: int, Pw: int
) -> torch.Tensor:
    """(B, q, P, Pw) windows img[b, y0:y0+P, x0:x0+Pw]: the kernel of
    :func:`extract_windows_levels` on a one-level table.

    img: (B, h, w) float32. x0/y0: (B, q) int32 TOP-LEFT corners, clamped
    into [0, w-Pw] / [0, h-P]."""
    return extract_windows_levels([img], [x0.shape[-1]], x0, y0, P, Pw)
