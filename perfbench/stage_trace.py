"""The program's stages on the card's timeline: a cell's traced run, as
``perfbench/run.py --trace 1`` makes it, with vslam_torch's span log on,
and the trace split among the spans.

    python3 perfbench/stage_trace.py --workload <cell> --seed <n> --seconds <s>

(or ``python3 -m perfbench.stage_trace ...``) from the root of a checkout
on a machine with the card. The run is ``run.run_cell``'s, its
``WindowTrace`` a :class:`StageTrace`; the last line on standard output
is one JSON object: whether the drives were correct, the run's per-layer
metrics and ``info``, the tracker's and the mapper's counters over the
window, the six per-layer numbers of the spans (:func:`layer_numbers`), the
checks that the split closes, and the split (:func:`reduce_spans`).

The two clocks. The spans are on ``time.perf_counter_ns``; the trace is
on the profiler's. At the window's start and at its end
:class:`StageTrace` brackets ``torch.cuda.synchronize()`` with
``perf_counter_ns``, ``N_MARKS`` times; the trace holds each
``cudaDeviceSynchronize`` call. The tightest bracket at each end is the
marker: it gives the offset between the clocks within its bracket. A
span's times map onto the trace by the line through the two markers'
offsets, which takes up the drift between the clocks over the window.
"""

from __future__ import annotations

import os
import sys

for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import argparse  # noqa: E402
import collections  # noqa: E402
import heapq  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import time  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import frozen_counts, tracing  # noqa: E402

MARKER = "cudaDeviceSynchronize"
N_MARKS = 5  # bracketed syncs at each end of the window; the tightest counts
OUTSIDE = "outside"  # the window's time under no span
KERNEL = tracing.KERNEL


def _span_log():
    """The program's span log (``vslam_torch.utils.metrics``), or None for
    a program without one."""
    from vslam_torch.utils import metrics

    return metrics if hasattr(metrics, "span_log") else None


class StageTrace(tracing.WindowTrace):
    """``WindowTrace`` with the span log on and the clock markers at each
    end of the window. :meth:`stages` splits the trace."""

    def __init__(self):
        super().__init__()
        self.log = _span_log()
        self.marks: list = []
        self.spans: list = []

    def _mark(self):
        for _ in range(N_MARKS):
            a = time.perf_counter_ns()
            torch.cuda.synchronize()
            self.marks.append((a, time.perf_counter_ns()))

    def __enter__(self):
        super().__enter__()
        if self.log is not None:
            self.log.span_log(True)
        self._mark()
        return self

    def __exit__(self, *exc):
        self._mark()
        if self.log is not None:
            self.spans = self.log.take_spans()
            self.log.span_log(False)
        return super().__exit__(*exc)

    def stages(self) -> dict:
        spans = [(s.name, s.start_ns, s.end_ns) for s in self.spans]
        return reduce_spans(self._prof.profiler.kineto_results.events(), spans, self.marks,
                            (self.t0_ns, self.t0_ns + round(self.window_s * 1e9)))


def clock_line(marks: list, events: list) -> tuple:
    """The map from ``perf_counter_ns`` to the trace's clock through two
    markers: `marks` the two (before, after) perf brackets, `events` the
    two marker calls' (start, end) on the trace's clock. Returns (map,
    clock_bound_us: the wider bracket, drift_us: the second offset less
    the first)."""
    offs, mids = [], []
    for (a, b), (s, e) in zip(marks, events):
        # the call lies inside the bracket: the offset o has a + o <= s and
        # e <= b + o; take the middle of that range
        offs.append(((s - a) + (e - b)) / 2)
        mids.append((a + b) / 2)
    (o0, o1), (m0, m1) = offs, mids
    slope = (o1 - o0) / (m1 - m0) if m1 != m0 else 0.0

    def to_trace(p):
        p = np.asarray(p, np.int64)
        return p + np.rint(o0 + slope * (p - m0)).astype(np.int64)

    bound = max(b - a for a, b in marks) / 1e3
    return to_trace, bound, (o1 - o0) / 1e3


def leaf_segments(spans: list, w0: int, w1: int) -> tuple[np.ndarray, np.ndarray]:
    """The window [w0, w1) cut at every span boundary: the segments'
    starts (and w1 last) and, for each segment, the index of the innermost
    span over it (the open span that started last) or -1. `spans` are
    (start, end) pairs on one clock."""
    pts = {w0, w1}
    for s, e in spans:
        pts.update(min(max(x, w0), w1) for x in (s, e))
    bounds = np.array(sorted(pts), np.int64)
    owner = np.full(len(bounds) - 1, -1, np.int64)
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    heap: list = []  # open spans: (-start, -index, end)
    j = 0
    for k in range(len(bounds) - 1):
        t = bounds[k]
        while j < len(order) and spans[order[j]][0] <= t:
            i = order[j]
            heapq.heappush(heap, (-spans[i][0], -i, spans[i][1]))
            j += 1
        while heap and heap[0][2] <= t:
            heapq.heappop(heap)
        if heap:  # the top is open; spans closed under it are popped when on top
            owner[k] = -heap[0][1]
    return bounds, owner


def idle_intervals(busy: list, w0: int, w1: int) -> tuple[np.ndarray, np.ndarray]:
    """The card's idle intervals in [w0, w1): the window less the union
    of the (start, end) intervals in `busy`; sorted starts and ends."""
    if not busy:
        return np.array([w0], np.int64), np.array([w1], np.int64)
    a = np.asarray(busy, np.int64)
    a = a[np.argsort(a[:, 0], kind="stable")]
    reach = np.maximum.accumulate(a[:, 1])
    open_ = np.concatenate([[True], a[1:, 0] > reach[:-1]])
    starts = a[open_, 0]
    ends = np.append(reach[np.flatnonzero(open_)[1:] - 1], reach[-1])
    gs = np.concatenate([[w0], ends])
    ge = np.concatenate([starts, [w1]])
    gs, ge = np.clip(gs, w0, w1), np.clip(ge, w0, w1)
    keep = ge > gs
    return gs[keep], ge[keep]


def cumulative(gs: np.ndarray, ge: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Idle nanoseconds in [-inf, t) for sorted, disjoint intervals."""
    t = np.asarray(t, np.int64)
    if not len(gs):
        return np.zeros(t.shape, np.int64)
    done = np.concatenate([[0], np.cumsum(ge - gs)])
    k = np.searchsorted(gs, t, side="right")  # intervals starting at or before t
    last = np.clip(k - 1, 0, None)
    part = np.where(k > 0, np.minimum(t, ge[last]) - gs[last], 0)
    return done[last] * (k > 0) + part


def split_idle(gs, ge, bounds, owner, names) -> dict:
    """Idle seconds by the innermost span over it (`names[owner]`)."""
    per_seg = np.diff(cumulative(gs, ge, bounds))
    out: dict = collections.defaultdict(float)
    for o, v in zip(owner.tolist(), per_seg.tolist()):
        if v:
            out[names[o] if o >= 0 else OUTSIDE] += v / 1e9
    return dict(out)


def owner_of(times, bounds, owner, names) -> list:
    """The innermost span's name at each time (OUTSIDE off the spans or the
    window)."""
    k = np.searchsorted(bounds, np.asarray(times, np.int64), side="right") - 1
    inside = (k >= 0) & (k < len(owner))
    o = np.where(inside, owner[np.clip(k, 0, len(owner) - 1)], -1)
    return [names[i] if i >= 0 else OUTSIDE for i in o.tolist()]


def within(times: np.ndarray, spans: list, names: list) -> dict:
    """By span name, the times (sorted) inside any of its spans."""
    out: dict = collections.defaultdict(int)
    for (s, e), n in zip(spans, names):
        out[n] += int(np.searchsorted(times, e, side="right") - np.searchsorted(times, s, side="left"))
    return dict(out)


def reduce_spans(events, spans: list, marks: list, window_perf: tuple) -> dict:
    """Split a window's trace among the program's spans. `events` the
    profiler's raw events, `spans` (name, start_ns, end_ns) on
    ``perf_counter_ns``, `marks` the marker brackets (as many at the
    window's end as at its start), `window_perf` the window's (start, end)
    on ``perf_counter_ns``. The trace's first device syncs are the start
    markers; the last is ``WindowTrace``'s closing sync, and the ones
    before it are the end markers.

    By the innermost span around it: the card's idle time (every gap, the
    window's lead and tail included; ``idle_by_span``, seconds), each CUDA
    runtime launch, sync and copy call (``launches_by_span``,
    ``syncs_by_span``, ``memcpys_by_span``), and each device operation's
    seconds by the span that launched it, linked by correlation id
    (``device_s_by_span``; ``unlinked`` where none). By span name, inside
    any of its spans (nested ones included): ``launches_in_span``,
    ``syncs_in_span``, ``idle_in_span``. The partitions each sum to their
    totals in the window; ``spans`` holds each name's count and seconds."""
    cuda = torch.autograd.DeviceType.CUDA
    launch_names, sync_names = set(frozen_counts._LAUNCH_CALLS), set(frozen_counts._SYNC_CALLS)
    markers, busy, dev = [], [], []  # dev: (correlation, seconds, name)
    calls = {"launch": [], "sync": [], "memcpy": []}
    corr_time: dict = {}
    for e in events:
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            busy.append((s, s + d))
            c = e.correlation_id() or e.linked_correlation_id()
            dev.append((c, d / 1e9, name))
            continue
        c = e.correlation_id()
        if c:
            corr_time[c] = s
        kind = ("launch" if name in launch_names else "sync" if name in sync_names
                else "memcpy" if name == "cudaMemcpyAsync" else None)
        if kind is not None:
            calls[kind].append(s)
        if name == MARKER:
            markers.append((s, s + d))
    n = len(marks) // 2
    markers.sort()
    starts, ends = markers[:n], markers[-n - 1 : -1]
    i = min(range(n), key=lambda k: marks[k][1] - marks[k][0])
    j = min(range(n), key=lambda k: marks[n + k][1] - marks[n + k][0])
    to_trace, bound_us, drift_us = clock_line([marks[i], marks[n + j]], [starts[i], ends[j]])
    w0, w1 = (int(x) for x in to_trace(list(window_perf)))
    names = [n for n, _, _ in spans]
    iv = [(int(a), int(b)) for a, b in zip(to_trace([s for _, s, _ in spans]),
                                           to_trace([e for _, _, e in spans]))] if spans else []
    bounds, owner = leaf_segments(iv, w0, w1)
    gs, ge = idle_intervals(busy, w0, w1)

    out = {"clock_bound_us": bound_us, "marker_drift_us": drift_us,
           "window_s": (w1 - w0) / 1e9, "idle_s": float(np.sum(ge - gs)) / 1e9,
           "idle_by_span": split_idle(gs, ge, bounds, owner, names)}
    for kind, key in (("launch", "launches"), ("sync", "syncs"), ("memcpy", "memcpys")):
        out[f"{key}_by_span"] = dict(collections.Counter(owner_of(calls[kind], bounds, owner, names)))
    dev_s: dict = collections.defaultdict(float)
    kernel_spans: dict = collections.Counter()
    linked = [c for c, _, _ in dev]
    at = owner_of([corr_time.get(c, w0 - 1) for c in linked], bounds, owner, names)
    for (c, sec, name), where in zip(dev, at):
        where = where if c in corr_time else "unlinked"
        dev_s[where] += sec
        if KERNEL in name:
            kernel_spans[where] += 1
    out["device_s_by_span"] = dict(dev_s)
    out[f"{KERNEL}_by_span"] = dict(kernel_spans)
    launches = np.sort(np.asarray(calls["launch"], np.int64))
    syncs = np.sort(np.asarray(calls["sync"], np.int64))
    out["launches_in_span"] = within(launches, iv, names)
    out["syncs_in_span"] = within(syncs, iv, names)
    idle_in: dict = collections.defaultdict(float)
    if iv:
        a = np.asarray(iv, np.int64)
        inc = cumulative(gs, ge, np.clip(a[:, 1], w0, w1)) - cumulative(gs, ge, np.clip(a[:, 0], w0, w1))
        for n, v in zip(names, inc.tolist()):
            idle_in[n] += v / 1e9
    out["idle_in_span"] = dict(idle_in)
    totals: dict = {}
    for n, s, e in spans:
        t = totals.setdefault(n, {"count": 0, "total_s": 0.0})
        t["count"] += 1
        t["total_s"] += (e - s) / 1e9
    out["spans"] = totals
    return out


def layer_numbers(st: dict, counters: dict, frames: int) -> dict:
    """The per-layer numbers of the spans and counters of a window: the
    frontend's, the pose solve's and the local BA's ms, LM iterations a
    tracked frame, launches a frame in the pose solve and a solve in the
    BA. None where the window has no such span or counter."""
    sp, inside = st.get("spans", {}), st.get("launches_in_span", {})

    def per(name):
        s = sp.get(name)
        return 1e3 * s["total_s"] / s["count"] if s and s["count"] else None

    tracked = sp.get("track", {}).get("count", 0)
    fe = [sp[n]["total_s"] for n in ("track.extract", "track.stereo") if n in sp]
    n_ba = sp.get("ba", {}).get("count", 0)
    lm_iters = counters.get("tracker", {}).get("lm_iters")
    return {
        "frontend_ms": 1e3 * sum(fe) / tracked if fe and tracked else None,
        "pose_solve_ms": per("track.pose_solve"),
        "lm_iters_per_frame": lm_iters / tracked if lm_iters is not None and tracked else None,
        "pose_solve_launches_per_frame": (inside["track.pose_solve"] / frames
                                          if "track.pose_solve" in inside and frames else None),
        "ba_solve_ms": per("ba.solve"),
        "ba_launches_per_solve": inside["ba"] / n_ba if "ba" in inside and n_ba else None,
    }


def main(argv=None) -> int:
    from perfbench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_trace: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    traces, counters = [], []  # the window's trace; its facades' counters
    make, window_trace = run.make_system, tracing.WindowTrace

    def make_system(seq, device):
        sys_ = make(seq, device)
        if traces:  # built in the window, not in the warm-up
            counters.append((sys_.tracker.counters, sys_.mapper.counters))
        return sys_

    def stage_trace():
        traces.append(StageTrace())
        return traces[-1]

    run.make_system, tracing.WindowTrace = make_system, stage_trace
    try:
        result = run.run_cell(a.workload, a.seed, a.seconds, True)
    finally:
        run.make_system, tracing.WindowTrace = make, window_trace
    info, dev = result["info"], result["device"]
    st = traces[0].stages()
    counts: dict = {"tracker": collections.Counter(), "mapper": collections.Counter()}
    for pair in counters:
        for who, c in zip(counts, pair):
            counts[who].update({k: v for k, v in c.summary().items() if not k.endswith("_per_s")})
    counts = {k: dict(v) for k, v in counts.items()}
    idle = dev["window_s"] - dev["busy_s"]
    k = st[f"{KERNEL}_by_span"]
    checks = {  # the partitions against the window's totals
        "launches_split": sum(st["launches_by_span"].values()),
        "launches_traced": info["trace_counts"]["kernel_launches"],
        "idle_split_over_window_idle": sum(st["idle_by_span"].values()) / idle,
        "outside_share_of_idle": st["idle_by_span"].get(OUTSIDE, 0.0) / idle,
        f"{KERNEL}_in_track_extract": k.get("track.extract", 0) / max(sum(k.values()), 1),
    }
    out = {"workload": a.workload, "seed": a.seed, "correct": result["correct"], "device": dev,
           "metrics": result["metrics"], "info": info, "fps": info["frames"] / info["window_s"],
           "layer": layer_numbers(st, counts, info["frames"]), "checks": checks, "counters": counts, **st}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
