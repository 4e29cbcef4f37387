"""The traced run's record: a ``torch.profiler`` trace of the whole window
(the CUDA runtime calls and every operation on the card), reduced to
what the per-layer readers take.

The hand-written kernel's bytes come from the frozen ``window_bytes`` over
the arguments of each call, which a wrapper around
``vslam_torch.ops.patches.extract_windows_levels`` keeps during the traced
window (the level shapes, the counts and a copy of the corners) and which
are counted once the window has closed.
"""

from __future__ import annotations

import collections
import time
import types

import numpy as np
import torch

from perfbench import frozen_counts

KERNEL = "extract_windows"


class _Agg:
    """One name's total, in the shape ``count_events`` reads."""

    __slots__ = ("key", "count", "device_type", "self_device_time_total")

    def __init__(self, key, device_type):
        self.key, self.count, self.device_type, self.self_device_time_total = key, 0, device_type, 0.0


class WindowTrace:
    """Context manager around the window: profiles it and keeps the
    kernel's call arguments. :meth:`record` reduces both."""

    def __init__(self):
        self.calls: list = []
        self._prof = None
        self._orig = None

    def __enter__(self):
        from vslam_torch.ops import patches

        self._patches = patches
        self._orig = orig = patches.extract_windows_levels
        calls = self.calls

        def wrapped(levels, counts, x0, y0, P, Pw):
            calls.append(([tuple(t.shape) for t in levels], list(counts), x0.clone(), y0.clone(), P))
            return orig(levels, counts, x0, y0, P, Pw)

        patches.extract_windows_levels = wrapped
        # CUDA activity alone: the card's operations and the CUDA runtime
        # calls (launches, syncs, copies); leaving out the host's aten ops
        # halves the events the window records and this reduces
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = (time.perf_counter_ns() - self.t0_ns) / 1e9
        self._prof.__exit__(*exc)
        self._patches.extract_windows_levels = self._orig
        return False

    def record(self) -> dict:
        return reduce_events(self._prof.profiler.kineto_results.events(), self.window_s, self.calls)


def reduce_events(events, window_s: float, calls: list) -> dict:
    """Busy seconds (the union of the card's operations), the frozen
    ``count_events`` counts, the device operations that took most time,
    the longest idle gaps by the host op that was running, and the hand
    kernel's seconds and bytes."""
    cuda = torch.autograd.DeviceType.CUDA
    agg: dict = {}
    dev_iv, host_iv, host_names, dev_time = [], [], [], collections.Counter()
    k_s, k_n = 0.0, 0
    for e in events:
        name = e.name()
        dt = e.device_type()
        a = agg.get((name, dt))
        if a is None:
            a = agg[(name, dt)] = _Agg(name, dt)
        a.count += 1
        s, d = e.start_ns(), e.duration_ns()
        if dt == cuda:
            a.self_device_time_total += d / 1e3
            dev_iv.append((s, s + d))
            dev_time[name] += d / 1e9
            if KERNEL in name:
                k_s += d / 1e9
                k_n += 1
        else:
            host_iv.append((s, s + d))
            host_names.append(name)
    counts = frozen_counts.count_events(list(agg.values()), window_s * 1e3)
    busy_s, gaps = _busy_and_gaps(dev_iv)
    nbytes = sum(_call_bytes(c) for c in calls)
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "counts": counts,
        "device_ops": [[n, s] for n, s in dev_time.most_common(10)],
        "idle_gaps": _label_gaps(gaps, host_iv, host_names),
        KERNEL: {"kernel_s": k_s, "kernels": k_n, "calls": len(calls), "bytes": nbytes},
    }


def _busy_and_gaps(iv: list) -> tuple[float, list]:
    """Union length (s) of device intervals, and the ten longest gaps
    between them, longest first, as (start_ns, end_ns)."""
    if not iv:
        return 0.0, []
    a = np.asarray(iv, np.int64)
    a = a[np.argsort(a[:, 0], kind="stable")]
    reach = np.maximum.accumulate(a[:, 1])  # the latest end so far
    open_ = a[1:, 0] > reach[:-1]
    g_start, g_end = reach[:-1][open_], a[1:, 0][open_]
    busy = int(reach[-1] - a[0, 0]) - int(np.sum(g_end - g_start))
    top = np.argsort(g_start - g_end, kind="stable")[:10]
    return busy / 1e9, [(int(g_start[i]), int(g_end[i])) for i in top]


def _label_gaps(gaps: list, host_iv: list, host_names: list) -> list:
    """[name, seconds] per gap: the innermost CUDA runtime call that spans
    the gap's middle, or "python" where none does (the host between
    calls: the program's Python and PyTorch's dispatch)."""
    if not gaps:
        return []
    h = np.asarray(host_iv, np.int64).reshape(-1, 2)
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        hit = np.flatnonzero((h[:, 0] <= mid) & (h[:, 1] >= mid))
        name = host_names[hit[np.argmin(h[hit, 1] - h[hit, 0])]] if len(hit) else "python"
        out.append([name, (e - s) / 1e9])
    return out


def _call_bytes(call) -> int:
    shapes, counts, x0, y0, P = call
    levels = [types.SimpleNamespace(shape=s, device=x0.device) for s in shapes]
    idx = frozen_counts.gather_index(levels, counts, x0, y0, P)
    return frozen_counts.window_bytes(idx, x0, P)[0]
