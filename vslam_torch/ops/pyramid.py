"""Image pyramid + separable Gaussian blur (port of vslam_tpu/ops/pyramid.py).

The half-pixel bilinear resize is the reference's explicit formula, not
``F.interpolate`` (whose edge clipping differs), and the blur is the same
separable tap loop in the same tap order with reflect-101 borders (no
conv2d). Both are elementwise programs, so each level is bit-identical to
the JAX version. The batched forms take (B, H, W) float32 images; the
single-image forms (:func:`resize_bilinear`, :func:`build_pyramid`,
:func:`gaussian_blur`) are their B=1 calls on (H, W).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static per-level (H_l, W_l), matching cvRound(dim / scale^l)."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale**lvl)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W) -> (out_h, out_w) bilinear with half-pixel centers."""
    return resize_bilinear_batch(img[None], out_h, out_w)[0]


def resize_bilinear_batch(imgs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W) -> (B, out_h, out_w) bilinear with half-pixel centers
    (cv::resize INTER_LINEAR)."""
    _, H, W = imgs.shape
    dev = imgs.device
    sy = H / out_h
    sx = W / out_w
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=H - 1)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    r0 = imgs[:, y0i]
    r1 = imgs[:, y1i]
    a = r0[:, :, x0i]
    b = r0[:, :, x1i]
    c = r1[:, :, x0i]
    d = r1[:, :, x1i]
    top = a * (1 - wx)[None, None, :] + b * wx[None, None, :]
    bot = c * (1 - wx)[None, None, :] + d * wx[None, None, :]
    return top * (1 - wy)[None, :, None] + bot * wy[None, :, None]


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale: float = 1.2) -> list[torch.Tensor]:
    """List of n_levels (H_l, W_l) images; level 0 is the input, each level
    resampled from the previous one (as the reference does)."""
    H, W = img.shape
    levels = [img]
    for h, w in level_shapes(H, W, n_levels, scale)[1:]:
        levels.append(resize_bilinear(levels[-1], h, w))
    return levels


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> tuple:
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    k /= k.sum()
    return tuple(float(v) for v in k.astype(np.float32))


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """(H, W) separable Gaussian, reflect-101 borders (cv::GaussianBlur
    BORDER_REFLECT_101, applied before BRIEF sampling)."""
    return gaussian_blur_batch(img[None], ksize, sigma)[0]


def gaussian_blur_batch(imgs: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """(B, H, W) separable Gaussian, reflect-101 borders."""
    k = _gaussian_kernel_1d(ksize, sigma)
    half = ksize // 2
    B, H, W = imgs.shape
    # F.pad "reflect" excludes the edge pixel: reflect-101, like jnp "reflect"
    padded = F.pad(imgs[:, None], (half, half, half, half), mode="reflect")[:, 0]
    rows = torch.zeros((B, H + 2 * half, W), dtype=imgs.dtype, device=imgs.device)
    for i in range(ksize):
        rows = rows + k[i] * padded[:, :, i : i + W]
    out = torch.zeros((B, H, W), dtype=imgs.dtype, device=imgs.device)
    for i in range(ksize):
        out = out + k[i] * rows[:, i : i + H, :]
    return out
