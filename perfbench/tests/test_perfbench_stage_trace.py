"""CPU tests of perfbench/stage_trace.py on synthetic event lists: the
two-marker clock line, nested spans, an idle gap that crosses a span's
edge, time under no span, and each partition summing to its total.

    python -m pytest -q perfbench/tests/test_perfbench_stage_trace.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import stage_trace

OFF = 10**12  # the trace's clock less perf_counter_ns at the first marker
DRIFT = 40  # ns the trace's clock gains over the window


class E:
    """A raw profiler event as reduce_spans reads it."""

    def __init__(self, name, device, start, dur, corr=0):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        return cuda if self._v[1] == "cuda" else cpu

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0


# perf_counter_ns: the markers' brackets, the window (which ends after
# WindowTrace's closing sync), and the spans
MARKS = [(1_000, 1_100), (101_000, 101_100)]
WINDOW = (900, 101_300)
SPANS = [("frame", 2_000, 90_000), ("track", 3_000, 80_000),
         ("track.extract", 4_000, 20_000), ("track.lm", 30_000, 60_000)]
# the trace's clock: each marker call inside its bracket (offset OFF, then
# OFF + DRIFT), then the closing sync; a kernel under track.extract, one
# launched in track.lm that runs past its end, a sync in track.lm and a
# copy under frame alone
EVENTS = [
    E("cudaDeviceSynchronize", "cpu", OFF + 1_020, 60),
    E("cudaLaunchKernel", "cpu", OFF + 4_500, 300, corr=1),
    E("extract_windows_kernel", "cuda", OFF + 5_000, 10_000, corr=1),
    E("cudaLaunchKernel", "cpu", OFF + 31_000, 300, corr=2),
    E("gemm_kernel", "cuda", OFF + 35_000, 35_000, corr=2),
    E("cudaStreamSynchronize", "cpu", OFF + 50_000, 100),
    E("cudaMemcpyAsync", "cpu", OFF + 85_000, 100, corr=3),
    E("cudaDeviceSynchronize", "cpu", OFF + DRIFT + 101_020, 60),
    E("cudaDeviceSynchronize", "cpu", OFF + DRIFT + 101_150, 60),
]


@pytest.fixture(scope="module")
def st():
    return stage_trace.reduce_spans(EVENTS, SPANS, MARKS, WINDOW)


def test_the_clock_line_through_two_markers():
    to_trace, bound_us, drift_us = stage_trace.clock_line(
        MARKS, [(OFF + 1_020, OFF + 1_080), (OFF + DRIFT + 101_020, OFF + DRIFT + 101_080)])
    assert bound_us == pytest.approx(0.1) and drift_us == pytest.approx(DRIFT / 1e3)
    # each marker's middle maps to its call's middle; between them the
    # offset moves along the line
    assert to_trace([1_050])[0] == OFF + 1_050
    assert to_trace([101_050])[0] == OFF + DRIFT + 101_050
    assert to_trace([51_050])[0] == OFF + DRIFT // 2 + 51_050


def test_gaps_split_among_the_innermost_spans(st):
    assert st["clock_bound_us"] == pytest.approx(0.1)
    assert st["marker_drift_us"] == pytest.approx(DRIFT / 1e3)
    idle = st["idle_by_span"]
    us = {k: v * 1e6 for k, v in idle.items()}
    # the lead: outside 0.9-2, frame 2-3, track 3-4, extract 4-5 us; the
    # gap from 15 to 35 us crosses extract's end and lm's start; the tail
    # runs past track's and frame's ends into time under no span
    assert us["track.extract"] == pytest.approx(1.0 + 5.0, abs=0.1)
    assert us["track.lm"] == pytest.approx(5.0, abs=0.1)
    assert us["track"] == pytest.approx(1.0 + 10.0 + 10.0, abs=0.1)
    assert us["frame"] == pytest.approx(1.0 + 10.0, abs=0.1)
    assert us["outside"] == pytest.approx(1.1 + 11.3, abs=0.1)
    busy = 10_000 + 35_000
    assert st["idle_s"] == pytest.approx(st["window_s"] - busy / 1e9, abs=1e-12)
    assert sum(idle.values()) == pytest.approx(st["idle_s"], abs=1e-12)


def test_calls_and_device_time_go_to_the_span_around_their_launch(st):
    assert st["launches_by_span"] == {"track.extract": 1, "track.lm": 1}
    # the markers and the closing sync lie under no span; the stream sync
    # in the LM
    assert st["syncs_by_span"] == {"outside": 3, "track.lm": 1}
    assert st["memcpys_by_span"] == {"frame": 1}
    # the gemm runs past track.lm's end, its time is the LM's all the same
    assert st["device_s_by_span"] == pytest.approx({"track.extract": 10e-6, "track.lm": 35e-6})
    assert st["extract_windows_by_span"] == {"track.extract": 1}
    n_launch = sum(e.name() == "cudaLaunchKernel" for e in EVENTS)
    assert sum(st["launches_by_span"].values()) == n_launch


def test_inclusive_counts_take_nested_spans_in(st):
    assert st["launches_in_span"] == {"frame": 2, "track": 2, "track.extract": 1, "track.lm": 1}
    assert st["syncs_in_span"] == {"frame": 1, "track": 1, "track.extract": 0, "track.lm": 1}
    inside = {k: v * 1e6 for k, v in st["idle_in_span"].items()}
    assert inside["frame"] == pytest.approx(1 + 1 + 1 + 20 + 10 + 10, abs=0.1)
    assert inside["track.lm"] == pytest.approx(5.0, abs=0.1)
    assert st["spans"]["track"] == {"count": 1, "total_s": pytest.approx(77e-6)}


def test_the_innermost_span_is_the_open_one_that_started_last():
    # two threads' spans overlap without nesting; touching spans hand over
    spans = [(0, 100), (10, 50), (40, 80), (80, 90)]
    bounds, owner = stage_trace.leaf_segments(spans, 0, 120)
    assert bounds.tolist() == [0, 10, 40, 50, 80, 90, 100, 120]
    assert owner.tolist() == [0, 1, 2, 2, 3, 0, -1]


def test_cumulative_idle_against_a_direct_sum():
    rng = np.random.default_rng(5)
    busy = [(int(s), int(s + d)) for s, d in zip(rng.integers(0, 10_000, 40), rng.integers(1, 600, 40))]
    gs, ge = stage_trace.idle_intervals(busy, 500, 9_000)
    covered = np.zeros(10_000, bool)
    for s, e in busy:
        covered[s:e] = True
    idle = ~covered
    idle[:500] = idle[9_000:] = False
    assert int(np.sum(ge - gs)) == int(idle.sum())
    t = rng.integers(0, 10_000, 50)
    assert stage_trace.cumulative(gs, ge, t).tolist() == [int(idle[:x].sum()) for x in t]
    assert stage_trace.cumulative(gs[:0], ge[:0], t).tolist() == [0] * len(t)


def test_layer_numbers_read_the_spans_and_counters(st):
    frames = 1
    got = stage_trace.layer_numbers(st, {"tracker": {"lm_iters": 30}}, frames)
    assert got["frontend_ms"] == pytest.approx(16e-3)  # extract alone: no stereo span
    assert got["pose_solve_ms"] is None and got["ba_solve_ms"] is None
    assert got["lm_iters_per_frame"] == 30
    assert got["pose_solve_launches_per_frame"] is None and got["ba_launches_per_solve"] is None
    # a program without spans or counters reads nothing
    assert set(stage_trace.layer_numbers({}, {}, frames).values()) == {None}


def test_the_tightest_of_several_markers_sets_the_clock():
    # two syncs at each end; the first at each end is slow to return; the
    # program's own sync at the window's end and WindowTrace's closing
    # sync are no markers
    marks = [(200, 900), (1_000, 1_100), (100_000, 100_800), (101_000, 101_100)]
    events = [
        E("cudaDeviceSynchronize", "cpu", OFF + 300, 60),
        E("cudaDeviceSynchronize", "cpu", OFF + 1_020, 60),
        E("cudaLaunchKernel", "cpu", OFF + 4_500, 300, corr=1),
        E("k", "cuda", OFF + 5_000, 1_000, corr=1),
        E("cudaDeviceSynchronize", "cpu", OFF + DRIFT + 95_000, 60),
        E("cudaDeviceSynchronize", "cpu", OFF + DRIFT + 100_300, 60),
        E("cudaDeviceSynchronize", "cpu", OFF + DRIFT + 101_020, 60),
        E("cudaDeviceSynchronize", "cpu", OFF + DRIFT + 101_150, 60),
    ]
    st = stage_trace.reduce_spans(events, [("frame", 2_000, 90_000)], marks, (100, 101_300))
    assert st["clock_bound_us"] == pytest.approx(0.1)
    assert st["marker_drift_us"] == pytest.approx(DRIFT / 1e3)
    assert st["launches_by_span"] == {"frame": 1}
    assert st["syncs_by_span"] == {"outside": 6}
