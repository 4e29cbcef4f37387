"""Stage timer, counters, a profiler trace and JSON event lines (port of
vslam_tpu/utils/metrics.py).

The tracker records per-stage wall time and named counts here.
:func:`trace` is the counterpart of the JAX module's ``jax.profiler``
trace: a ``torch.profiler`` timeline written as a Chrome / Perfetto JSON.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time

import torch


class StageTimer:
    """Accumulate wall times per named stage; cheap enough for per-frame use."""

    def __init__(self, window: int = 200):
        self._samples: dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window)
        )
        self._totals: dict[str, float] = collections.defaultdict(float)
        self._counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, dt: float):
        self._samples[name].append(dt)
        self._totals[name] += dt
        self._counts[name] += 1

    def samples(self, name: str) -> list[float]:
        """The stage's latest wall times in seconds, oldest first."""
        return list(self._samples.get(name, ()))

    def summary(self) -> dict:
        out = {}
        for name, buf in self._samples.items():
            xs = sorted(buf)
            n = len(xs)
            if not n:
                continue
            out[name] = {
                "count": self._counts[name],
                "total_s": round(self._totals[name], 4),
                "mean_ms": round(1e3 * sum(xs) / n, 3),
                "p50_ms": round(1e3 * xs[n // 2], 3),
                "p90_ms": round(1e3 * xs[min(n - 1, int(0.9 * n))], 3),
            }
        return out


class Counters:
    def __init__(self):
        self._c: dict[str, int] = collections.defaultdict(int)
        self._t0 = time.perf_counter()

    def inc(self, name: str, by: int = 1):
        self._c[name] += by

    def get(self, name: str) -> int:
        return self._c[name]

    def rates(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {f"{k}_per_s": round(v / dt, 3) for k, v in self._c.items()}

    def summary(self) -> dict:
        return dict(self._c) | self.rates()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` (host ops, and the CUDA
    kernels and copies whenever the process has a CUDA device) and write
    the timeline to ``log_dir/trace_<pid>_<ms>.json`` (chrome://tracing or
    ui.perfetto.dev) when the block ends, also when it raises. Yields that
    path. Recording changes nothing that is computed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield path
    finally:
        prof.export_chrome_trace(path)


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


def profile_counts(fn, top: int = 0, by_card: bool = False) -> dict:
    """:func:`count_events` of one call of fn() under ``torch.profiler``
    (host ops and CUDA kernels); fn must end with a synchronize, whose own
    sync is counted. ``profiled_wall_ms`` is the call's wall time with the
    profiler on. `by_card`: also ``device_busy_ms_by_card``, each card's
    own device time (keyed by its index)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = count_events(prof.key_averages(), wall_ms, top)
    if by_card:
        busy: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy[e.device_index] = busy.get(e.device_index, 0.0) + getattr(e, "self_device_time_total", 0) / 1e3
        out["device_busy_ms_by_card"] = dict(sorted(busy.items()))
    return out


def log_event(event: str, stream=None, **fields):
    """One JSON line per event: structured logging the reference never had."""
    rec = {"t": round(time.time(), 3), "event": event} | fields
    print(json.dumps(rec), file=stream or sys.stdout, flush=True)
