"""What the motion-only LM kernel's wrapper and the tracker's bookkeeping
around it do before and after a launch, on the CPU (the kernel itself runs
only on a card: tests/test_torch_cuda.py holds it against its plain
version there).

- ``lm.kernel_layout`` takes each caller's form of the operands (the
  tracker's two starts, a batch of sequences, relocalization's single
  problem with a float baseline, flags expanded with a zero stride) and
  raises on a wrong dtype, rank, shape, stride or device, a host K, and
  more rows than the kernel stages;
- a CPU call is the plain version: no launch, no ``lm_kernel_solves``,
  and the tracker still counts its ``lm_iters``;
- the tracker's helpers fold the kernel's per-problem iteration counts into
  the reads it makes anyway (the retry loop's done flags, the frame blob);
- ``timing.lm_problem``, the generator of the card tests and of
  chip_smoke.py's table, makes problems the plain version solves, with
  demoted stereo rows, rows behind the camera and a case for the guard;
  ``timing.lm_flops`` counts what its bound is made of.
"""

import numpy as np
import pytest
import torch

from vslam_torch.kernels import timing
from vslam_torch.models import map_state, tracker
from vslam_torch.ops import lm
from vslam_torch.utils import metrics, synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

B, M = 2, 64


def _operands(per_problem=False, B=B):
    args, _ = timing.lm_problem(B=B, M=M, per_problem=per_problem, device="cpu")
    return list(args)


def _relocalization():
    """reloc._verify_candidate's form: one problem, unit weights, no stereo
    or right-only rows, K on the poses' device, a float baseline."""
    a = _operands(B=1)
    none = torch.zeros_like(a[4])
    a[2] = a[2].clone()
    a[2][:, 2] = -1.0
    a[3], a[4], a[5], a[8] = torch.ones_like(a[3]), none, none, 0.0
    return a


@pytest.mark.parametrize("form", ["shared", "per_problem", "expanded", "relocalization"])
def test_kernel_layout_takes_each_callers_form(form):
    a = _relocalization() if form == "relocalization" else _operands(per_problem=form == "per_problem")
    if form == "expanded":  # valid_b = valid.expand(B, -1): a zero batch stride
        a[6] = a[6].expand(B, -1)
    lay = lm.kernel_layout(*a)
    assert (lay.B, lay.M) == (1 if form == "relocalization" else B, M)
    strides = [s for _, s in lay.rows]
    assert strides == ([3 * M, 3 * M, M, M, M, M] if form == "per_problem" else [0] * 6)
    assert lay.K[0] is a[7] and lay.K[1] == (9 if form == "per_problem" else 0)
    if form == "relocalization":
        assert lay.baseline == (None, 0, 0.0)
    else:
        assert lay.baseline[1] == (1 if form == "per_problem" else 0)


def _bad(a, i, x):
    a = list(a)
    a[i] = x
    return a


BAD = {
    "float64 points": lambda a: _bad(a, 1, a[1].double()),
    "uint8 flags": lambda a: _bad(a, 4, a[4].to(torch.uint8)),
    "float64 poses": lambda a: _bad(a, 0, a[0].double()),
    "rank-4 points": lambda a: _bad(a, 1, a[1][None]),
    "points (M, 4)": lambda a: _bad(a, 1, torch.zeros(M, 4)),
    "weights of another M": lambda a: _bad(a, 3, a[3][:-1]),
    "strided observations": lambda a: _bad(a, 2, torch.zeros(M, 6)[:, ::2]),
    "strided per-problem points": lambda a: _bad(a, 1, torch.zeros(B, M, 6)[..., ::2]),
    "transposed poses": lambda a: _bad(a, 0, a[0].transpose(1, 2)),
    "poses (B, 3, 4)": lambda a: _bad(a, 0, a[0][:, :3]),
    "K (B + 1, 3, 3)": lambda a: _bad(a, 7, torch.eye(3).expand(B + 1, 3, 3).contiguous()),
    "host K": lambda a: _bad(a, 7, a[7].numpy()),
    "float64 K": lambda a: _bad(a, 7, a[7].double()),
    "K on another device": lambda a: _bad(a, 7, a[7].to("meta")),
    "baseline of another batch": lambda a: _bad(a, 8, torch.zeros(B + 1)),
    "float64 baseline": lambda a: _bad(a, 8, torch.tensor(0.5, dtype=torch.float64)),
}


@pytest.mark.parametrize("case", list(BAD))
def test_kernel_layout_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        lm.kernel_layout(*BAD[case](_operands()))


def test_kernel_layout_refuses_more_rows_than_the_kernel_stages():
    lm.kernel_layout(*timing.lm_problem(B=1, M=lm.MAX_ROWS, device="cpu")[0])
    with pytest.raises(ValueError, match="stages at most"):
        lm.kernel_layout(*timing.lm_problem(B=1, M=lm.MAX_ROWS + 1, device="cpu")[0])


def test_a_cpu_call_is_the_plain_version_and_launches_nothing():
    a = _operands()
    n0, its, reads = lm.LAUNCHES, [], []
    out = lm.motion_only_ba(*a, stats=its, reads=reads)
    ref = lm.motion_only_ba_ref(*a)
    assert lm.LAUNCHES == n0
    assert all(isinstance(n, int) for n in its + reads) and len(its) == len(reads) == 2
    for x, y in zip(out[:4] + tuple(out[4]), ref[:4] + tuple(ref[4])):
        assert torch.equal(x, y)


def test_the_cpu_tracker_counts_its_lm_and_takes_no_kernel():
    scene = synthetic.make_scene(n_frames=4, n_points=400, width=320, height=240, fps=10.0, seed=7)
    params = tracker.TrackerParams(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60)
    world = map_state.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512, device="cpu")
    trk = tracker.StereoTracker(scene.K, scene.baseline, 320, 240, world, params, device="cpu")
    n0 = lm.LAUNCHES
    for f in range(4):
        trk.track(scene.render(f), scene.render(f, right=True))
    trk.flush()
    c = trk.counters
    assert "lm_kernel_solves" not in c.summary()
    assert lm.LAUNCHES == n0 and c.get("lm_kernel_solves") == 0
    assert c.get("lm_iters") >= 2 * c.get("radius_attempts") > 0


def test_the_kernels_iterations_ride_the_reads_the_tracker_makes():
    """The card's bookkeeping with CPU tensors standing in for the
    kernel's device counts: per attempt the longest problem of each pass,
    summed; read with the done flags (one read), and for the refine pass
    with the frame blob (one read), counted once per batched frame."""
    c = metrics.Counters()
    count = c.inc
    its = [torch.tensor([3, 7]), torch.tensor([5, 2])]
    n = tracker._lm_iterations(its, count)
    assert int(n) == 12 and c.get("lm_iters") == 0
    done = tracker._read_done(torch.tensor([True, False]), n, count)
    assert done.tolist() == [True, False] and c.get("lm_iters") == 12 and c.get("host_reads") == 1
    # the host loop's counts (the CPU path) are counted at once
    assert tracker._lm_iterations([4, 8], count) is None and c.get("lm_iters") == 24
    np.testing.assert_array_equal(tracker._read_done(torch.tensor([False]), None, count), [False])
    # the refine pass: a blob of S = 3 rows, one copy for all, counted once
    blob = torch.arange(3 * 5, dtype=torch.float32).reshape(3, 5)
    step = metrics.Counters()
    shared = [blob, None, torch.tensor(9).expand(3), step]
    outs = [{"shared_blob": shared, "seq": s} for s in range(3)]
    rows = [tracker._host_blob(o, c) for o in outs]
    np.testing.assert_array_equal(np.stack(rows), blob.numpy())
    assert step.get("lm_iters") == 9 and c.get("host_reads") == 3
    one = tracker._host_blob({"blob": blob[0], "lm_iters": torch.tensor(6)}, c)
    np.testing.assert_array_equal(one, blob[0].numpy())
    assert c.get("lm_iters") == 30 and c.get("host_reads") == 4


@pytest.mark.parametrize("kw", [dict(), dict(per_problem=True), dict(behind=0.1), dict(outliers=0.9)])
def test_lm_problem_is_solved_by_the_plain_version(kw):
    args, T_true = timing.lm_problem(B=2, M=512, seed=11, device="cpu", **kw)
    T, chi2, inl, st, res = lm.motion_only_ba_ref(*args)
    valid, st_in = args[6], args[4]
    assert T.shape == T_true.shape == (2, 4, 4) and bool(torch.isfinite(T).all())
    assert bool((res.iterations > 0).all())
    if "outliers" in kw:  # the sweep keeps under a quarter: the guard's case
        assert bool((inl.sum(-1) < valid.sum(-1) // 4).all())
        return
    assert float((T - T_true).abs().max()) < 0.05
    assert bool((st_in & valid & inl & ~st).any())  # stereo rows demoted
    if "behind" in kw:
        from vslam_torch.geometry import se3

        z = se3.transform_points(se3.inverse(T), args[1][None])[..., 2]
        assert bool((z <= 0.05).any()) and not bool((inl & (z <= 0.05)).any())
        assert bool((chi2[z <= 0.05] >= 1e11).all())


def test_lm_flops_counts_each_pass_and_sweep():
    """The kernel's operation count behind chip_smoke.py's bound: per
    problem, (iterations + 1) evaluations of each pass's set and two
    sweeps of every row."""
    args, _ = timing.lm_problem(B=2, M=512, seed=11, device="cpu")
    inl = lm.motion_only_ba_ref(*args)[2]
    flops = timing.lm_flops(args, inl, [torch.tensor([3, 0]), torch.tensor([1, 5])])
    n_valid, n_inl = int(args[6].sum()), inl.sum(-1)
    row, huber, sweep = timing.LM_ROW_FLOPS, timing.LM_HUBER_FLOPS, timing.LM_SWEEP_FLOPS
    want = [4 * n_valid * (row + huber) + 2 * int(n_inl[0]) * row + 2 * 512 * sweep,
            1 * n_valid * (row + huber) + 6 * int(n_inl[1]) * row + 2 * 512 * sweep]
    assert flops.dtype == torch.float64 and flops.tolist() == want
