"""Batched patch-window extraction at runtime corners (port of
vslam_tpu/ops/patches.py, the repo's one Pallas kernel).

:func:`extract_windows` launches the hand-written CUDA kernel
(``kernels/csrc/extract_windows.cu``) for a CUDA tensor and uses the plain
PyTorch gather :func:`extract_windows_ref` for a CPU tensor. There is no
other path: a CUDA tensor reaches the kernel or raises.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import torch

from vslam_torch import kernels

LAUNCHES = 0


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


def _check(img, x0, y0, P, Pw):
    if img.ndim != 3 or x0.ndim != 2 or x0.shape != y0.shape or x0.shape[0] != img.shape[0]:
        raise ValueError(
            f"extract_windows: img (B,h,w), x0/y0 (B,q); got {tuple(img.shape)}, "
            f"{tuple(x0.shape)}, {tuple(y0.shape)}"
        )
    if img.shape[1] < P or img.shape[2] < Pw:
        raise ValueError(f"extract_windows: {P}x{Pw} window larger than {tuple(img.shape[1:])}")


def extract_windows(
    img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, P: int, Pw: int
) -> torch.Tensor:
    """(B, q, P, Pw) windows img[b, y0:y0+P, x0:x0+Pw].

    img: (B, h, w) float32. x0/y0: (B, q) int32 TOP-LEFT corners, already
    clipped to [0, w-Pw] / [0, h-P]."""
    global LAUNCHES
    _check(img, x0, y0, P, Pw)
    if img.device.type == "cpu":
        return extract_windows_ref(img, x0, y0, P, Pw)
    if img.device.type != "cuda":
        raise ValueError(f"extract_windows: unsupported device {img.device}")
    if img.dtype != torch.float32 or x0.dtype != torch.int32 or y0.dtype != torch.int32:
        raise TypeError(
            f"extract_windows: want f32 img, int32 corners; got {img.dtype}, {x0.dtype}, {y0.dtype}"
        )
    if x0.device != img.device or y0.device != img.device:
        raise ValueError("extract_windows: img and corners on different devices")
    if not (img.is_contiguous() and x0.is_contiguous() and y0.is_contiguous()):
        raise ValueError("extract_windows: inputs must be contiguous")
    B, h, w = img.shape
    q = x0.shape[1]
    out = torch.empty((B, q, P, Pw), dtype=torch.float32, device=img.device)
    if B * q == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.extract_windows_f32(
            img.data_ptr(), x0.data_ptr(), y0.data_ptr(), out.data_ptr(),
            B, q, h, w, P, Pw, stream,
        )
    kernels.check(rc, "extract_windows_f32")
    LAUNCHES += 1
    return out
