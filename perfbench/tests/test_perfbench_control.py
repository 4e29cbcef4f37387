"""The control and the planted faults, at a size a test run can hold: a
run of the cell on the CPU (the look for a card skipped, the cell's rig
at half its size, a short stretch of its traffic) with the timed path
broken underneath must come out not correct by the cell's own limits,
and the same run unbroken must not.

    python -m pytest -q perfbench/tests/test_perfbench_control.py

Each cell's control is ``rig_centre`` (every solved pose moved to the
stereo rig's centre, an answer altered where it is produced). A step that
returns its state unchanged is the pose solve returning the motion
model's prediction (``pose_solve_skipped``) or the local BA returning its
window as it found it (``local_ba_skipped``). There is no batch and no
exchange between chips in these cells.
"""

from __future__ import annotations

import time

import pytest

from perfbench import control, run, sequence
from perfbench.tests.test_perfbench_harness import BENCH, small_overrides

SEED = 2**31 + 523

# (cell, variant, frames of the sequence): one drive through enough
# frames for a few local BAs and for the variant's error to build past
# the cell's limits, and few enough that the half-size rig still tracks
# soundly (KITTI's drifts past ~20)
CASES = [
    ("kitti00.drive", "rig_centre", 18),
    ("kitti00.drive", "pose_solve_skipped", 18),
    ("kitti00.drive", "local_ba_skipped", 18),
]


class _FrameClock:
    """run.py's clock, advanced one second a reading: the window reads it
    three times a frame, so a window of 3 n seconds tracks n frames
    however loaded the machine is."""

    CLOCK_BOOTTIME = time.CLOCK_BOOTTIME
    clock_gettime = staticmethod(time.clock_gettime)

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 1.0
        return self.t


def _run(monkeypatch, workload: str, frames: int) -> dict:
    cell = run.cell_of(BENCH, workload)
    over = small_overrides(cell["config"], frames=frames, landmarks=600 if "kitti" in cell["config"] else None)
    monkeypatch.setattr(run, "time", _FrameClock())
    r = run.run_cell(workload, SEED, 3.0 * frames, False, device="cpu", overrides=over, processes=2)
    info = r.pop("info")
    assert info["frames"] == frames and info["drives"] == 1
    return r


@pytest.mark.parametrize("workload,variant,frames", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, variant, frames):
    config = sequence.load_json("configs", run.cell_of(BENCH, workload)["config"])
    with control.VARIANTS[variant](config):
        broken = _run(monkeypatch, workload, frames)
    assert broken["correct"] is False, broken["checks"]


@pytest.mark.parametrize("workload", sorted({c[0] for c in CASES}))
def test_the_same_run_unbroken_is_correct(monkeypatch, workload):
    r = _run(monkeypatch, workload, max(c[2] for c in CASES if c[0] == workload))
    assert r["correct"] is True, r["checks"]
