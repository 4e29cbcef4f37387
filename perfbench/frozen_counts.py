"""Frozen copies of the port's profiler and byte arithmetic, so that later
changes to the program cannot move the yardstick.

From commit 2160959f63e564fa020adbc072b172400944d475:
``count_events`` (with ``_LAUNCH_CALLS`` and ``_SYNC_CALLS``) from
``vslam_torch/utils/metrics.py``, and ``gather_index`` and
``window_bytes`` from ``vslam_torch/kernels/timing.py``, unchanged.
"""

from __future__ import annotations

import torch

_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def count_events(events, wall_ms: float, top: int = 0) -> dict:
    """Kernel launches, stream syncs and memcpy calls from the runtime-API
    events of a recorded ``torch.profiler`` event list (``key_averages()``:
    each event has ``key``, ``count``, ``device_type`` and
    ``self_device_time_total`` in us); the device busy time is the sum of
    the CUDA events' own times. `top`: the kernels with the most device
    time."""
    counts: dict = {}
    for e in events:
        counts[e.key] = counts.get(e.key, 0) + e.count
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in dev)
    out = {"kernel_launches": sum(counts.get(k, 0) for k in _LAUNCH_CALLS),
           "stream_syncs": sum(counts.get(k, 0) for k in _SYNC_CALLS),
           "memcpy_calls": counts.get("cudaMemcpyAsync", 0),
           "device_busy_ms": busy_us / 1e3, "profiled_wall_ms": wall_ms}
    if top:
        dev.sort(key=lambda e: -getattr(e, "self_device_time_total", 0))
        out["top_kernels"] = [{"name": e.key[:80], "count": e.count,
                               "ms": getattr(e, "self_device_time_total", 0) / 1e3} for e in dev[:top]]
    return out


def gather_index(levels, counts, x0, y0, P: int) -> list:
    """Per level with slots, the advanced index (b, ys, xs) of its PxP
    windows, corners clamped as the kernel clamps them: ``levels[l][ix]``
    is one PyTorch call that cuts the level's windows."""
    idx, first = [], 0
    ar = torch.arange(P, device=x0.device)
    for img, q in zip(levels, counts):
        if q:
            B, h, w = img.shape
            xs = x0[:, first:first + q].long().clamp(0, w - P)[..., None] + ar
            ys = y0[:, first:first + q].long().clamp(0, h - P)[..., None] + ar
            b = torch.arange(B, device=x0.device)[:, None, None, None]
            idx.append((img, (b, ys[..., :, None], xs[..., None, :])))
        first += q
    return idx


def window_bytes(idx, x0, P: int) -> tuple[int, int]:
    """(bytes, distinct pixels) the window stage must move for these
    inputs: the (B, N, P, P) f32 output written once, each distinct level
    pixel a window covers read once, the int32 corners read once."""
    covered = 0
    for img, ix in idx:
        mask = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        mask[ix] = True
        covered += int(mask.sum())
    B, N = x0.shape
    return 4 * (B * N * P * P + covered + 2 * B * N), covered
