"""Stage timer, counters, a span log and a profiler trace (port of
vslam_tpu/utils/metrics.py).

The tracker, the local mapper and the facade record per-stage wall time
and named counts here. The span log (:func:`span_log`, off by default)
keeps one :class:`Span` per closed stage, on ``time.perf_counter_ns``'s
clock, with its parent and the frame it serves, until :func:`take_spans`
hands them out. While a ``torch.profiler`` runs, every stage is also a
``record_function`` range, so a trace shows the program's stages.
:func:`trace` is the counterpart of the JAX module's ``jax.profiler``
trace: a ``torch.profiler`` timeline written as a Chrome / Perfetto JSON.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler


class Span(NamedTuple):
    """One closed stage of the span log. `id` counts the spans in the order
    they opened since the log was switched on; `parent` is the id of the
    span that was open around it on the same thread (-1: none); `frame` is
    the index of the frame the span serves, counted from 0 by each
    tracker (-1: none, as on the async mapper's worker thread)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    frame: int
    id: int


_log: list | None = None  # the closed spans while the log is on
_lock = threading.Lock()  # the log's switch, appends and takes
_ids = itertools.count()
_open = threading.local()  # per thread: the stack of open (id, frame)


def span_log(on: bool):
    """Switch the process-wide span log on (empty) or off (dropped)."""
    global _log, _ids
    with _lock:
        _ids = itertools.count()
        _log = [] if on else None


def take_spans() -> list[Span]:
    """The spans closed since the log was switched on or last taken, in
    the order they opened; the log stays as it was switched."""
    global _log
    with _lock:
        if _log is None:
            return []
        out, _log = _log, []
    return sorted(out, key=lambda s: s.id)


def _enter(name: str, frame: int | None):
    """Open a span: push it on this thread's stack when the log is on,
    enter a ``record_function`` range when a profiler runs."""
    entry = None
    if _log is not None:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent, up_frame = stack[-1] if stack else (-1, -1)
        entry = (next(_ids), up_frame if frame is None else frame, parent)
        stack.append(entry[:2])
    rf = None
    if _profiler._is_profiler_enabled:
        rf = _profiler.record_function(name)
        rf.__enter__()
    return entry, rf, time.perf_counter_ns()


def _exit(name: str, state) -> float:
    """Close a span opened by :func:`_enter`; returns its seconds."""
    entry, rf, t0 = state
    t1 = time.perf_counter_ns()
    if rf is not None:
        rf.__exit__(None, None, None)
    if entry is not None:
        _open.stack.pop()
        sid, frame, parent = entry
        with _lock:
            if _log is not None:
                _log.append(Span(name, t0, t1, parent, frame, sid))
    return (t1 - t0) / 1e9


@contextlib.contextmanager
def span(name: str, frame: int | None = None):
    """The block as the span `name` of the log (and a profiler range),
    timed by no stage timer."""
    if _log is None and not _profiler._is_profiler_enabled:
        yield
        return
    state = _enter(name, frame)
    try:
        yield
    finally:
        _exit(name, state)


class StageTimer:
    """Accumulate wall times per named stage; cheap enough for per-frame use.
    One thread writes a timer: the async mapper's worker hands its seconds
    to the caller's thread (``LocalMapper._join``)."""

    def __init__(self, window: int = 200):
        self._samples: dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window)
        )
        self._totals: dict[str, float] = collections.defaultdict(float)
        self._counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, frame: int | None = None):
        """Time the block as stage `name`. While the span log is on, the
        block is also a :class:`Span` serving `frame` (default: the frame
        of the span around it); while a profiler runs, a
        ``record_function`` range."""
        if _log is None and not _profiler._is_profiler_enabled:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.record(name, time.perf_counter() - t0)
            return
        state = _enter(name, frame)
        try:
            yield
        finally:
            self.record(name, _exit(name, state))

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


def maybe_stage(timer: StageTimer | None, name: str):
    """``timer.stage(name)``, or a null context without a timer."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


class Counters:
    """Named counts; ``inc`` may be called from several threads (the async
    mapper's worker counts its host reads)."""

    def __init__(self):
        self._c: dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def inc(self, name: str, by: int = 1):
        with self._lock:
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
