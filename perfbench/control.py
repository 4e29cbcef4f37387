"""The control and the planted faults: the program with one guarantee of
the configuration broken, for the check that the comparison fails them.

Neither the benchmark's runs nor the program use this; calibrate.py (on
the card) and tests/test_perfbench_control.py (on the CPU) do. Each is a
context manager that patches the program for its block and restores it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def pose_solve_skipped(config=None):
    """Breaks ``pose_per_frame``: the tracker's pose solve (ops/lm, the
    stereo and the visual-inertial one) returns its initial state, the
    motion model's prediction, unchanged."""
    from vslam_torch.ops import lm

    def zero_iters(orig):
        def f(*a, **kw):
            kw["max_iters"] = 0
            return orig(*a, **kw)
        return f

    with _patched(lm, "motion_only_ba", zero_iters), _patched(lm, "motion_only_ba_imu", zero_iters):
        yield


@contextlib.contextmanager
def local_ba_skipped(config=None):
    """Breaks ``local_ba``: every keyframe's window comes back from the
    two-round BA unchanged (triangulation, assembly and write-back run)."""
    from vslam_torch.models import local_mapper

    def skip(orig):
        def f(self, p, n_slabs=1, stats=None):
            if stats is not None:
                stats.extend([0, 0])
            return p, torch.zeros((), device=p.obs_valid.device), torch.zeros_like(p.obs_valid)
        return f

    with _patched(local_mapper.LocalMapper, "_two_rounds", skip):
        yield


@contextlib.contextmanager
def rig_centre(config):
    """Breaks ``pose_per_frame`` (a pose of the left camera): every solved
    pose comes out of the pose solve at the stereo rig's centre, half the
    configuration's baseline along the left camera's x axis, as a slip in
    the frame of reference would return it (an answer altered where it is
    produced)."""
    from vslam_torch.ops import lm

    offset_m = 0.5 * float(config["system"]["Camera"]["bl"])

    def shift(T):
        d = torch.eye(4, dtype=T.dtype, device=T.device)
        d[0, 3] = offset_m
        return T @ d

    def shifted(orig):
        def f(*a, **kw):
            T, *rest = orig(*a, **kw)
            return (shift(T), *rest)
        return f

    with _patched(lm, "motion_only_ba", shifted), _patched(lm, "motion_only_ba_imu", shifted):
        yield


VARIANTS = {
    "pose_solve_skipped": pose_solve_skipped,
    "local_ba_skipped": local_ba_skipped,
    "rig_centre": rig_centre,
}
