"""Tests of the port that need a CUDA device: the hand-written kernels
against their plain PyTorch versions (the window kernel, and the
motion-only LM kernel at the tracker's, a batch's and relocalization's
shapes), the benchmark's pose-solve controls on the card's LM, a short
tracker run and a short
VSlamSystem run on the card against the same runs on the CPU, the local
BA's bit-reproducibility on the card, the async mapper's worker thread and
side stream against the sync mapper, a short STEREO_IMU run, a short
mono-inertial run, relocalization retrieval, the slab-chunked Schur
reduction and the split BA rounds, single-image extraction against the
image-space ORB, the pose graphs, the split-map loop closure, the batched
frontend's kernel tables and run, the sharded BA over virtual shards
on one card, and each measuring tool's main (vslam_torch/tools) at a
small size. They skip without a card. The last ones (named ``*cards*``)
need four cards and skip with fewer: the multi-device dry run
(vslam_torch/dryrun.py) across cuda:0..3 and over NCCL, VSlamSystem
(shards=4), run_global and run_dataset over a 4-card mesh. This file
imports no jax (the GPU machine has none); run it there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py
    python -m pytest -q -s -m cuda tests/test_torch_cuda.py -k cards   # four cards
"""

import numpy as np
import pytest
import torch

from vslam_torch.geometry import se3
from vslam_torch.kernels import timing
from vslam_torch.models import map_state, reloc, system, tracker
from vslam_torch.ops import extract, lm, orb, patches, pyramid, schur
from vslam_torch.tools import counts
from vslam_torch.utils import synthetic
from vslam_torch.utils.config import ConfigFile

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _window_case(seed, B, h, w, q, P, Pw, dev):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, size=(B, h, w)).astype(np.float32)
    x0 = rng.integers(0, w - Pw + 1, size=(B, q)).astype(np.int32)
    y0 = rng.integers(0, h - P + 1, size=(B, q)).astype(np.int32)
    x0[:, :2], y0[:, :2] = [0, w - Pw], [0, h - P]
    return [torch.from_numpy(a).to(dev) for a in (img, x0, y0)]


@pytest.mark.parametrize(
    "case",
    [
        (2, 40, 56, 70, 31, 31),
        (2, 48, 64, 13, 11, 21),
        (1, 31, 33, 5, 31, 31),
        (2, 480, 752, 222, 31, 31),  # bench level 0: quota 222 of 1024
        (2, 134, 210, 61, 31, 31),  # bench level 7
    ],
)
def test_extract_windows_kernel_equals_plain_version(dev, case):
    img, x0, y0 = _window_case(0, *case[:4], *case[4:], dev)
    P, Pw = case[4], case[5]
    n0 = patches.LAUNCHES
    out = patches.extract_windows(img, x0, y0, P, Pw)
    torch.cuda.synchronize()
    assert patches.LAUNCHES == n0 + 1
    assert torch.equal(out, patches.extract_windows_ref(img, x0, y0, P, Pw))
    # out-of-range corners are clamped into the image by both versions
    x_bad, y_bad = x0.clone(), y0.clone()
    x_bad[0, 0], y_bad[0, 0] = 100_000, -7
    assert torch.equal(
        patches.extract_windows(img, x_bad, y_bad, P, Pw),
        patches.extract_windows_ref(img, x_bad, y_bad, P, Pw),
    )


def test_extract_windows_wrapper_rejects_what_the_kernel_does_not_take(dev):
    img, x0, y0 = _window_case(1, 2, 40, 56, 9, 31, 31, dev)
    with pytest.raises(TypeError):
        patches.extract_windows(img, x0.long(), y0, 31, 31)
    with pytest.raises(ValueError, match="contiguous"):
        patches.extract_windows(img.transpose(1, 2).contiguous().transpose(1, 2), x0, y0, 31, 31)
    with pytest.raises(ValueError, match="different devices"):
        patches.extract_windows(img, x0.cpu(), y0.cpu(), 31, 31)
    assert patches.extract_windows(img, x0[:, :0], y0[:, :0], 31, 31).shape == (2, 0, 31, 31)


def _bench_table(dev, seed=2, B=2, H=480, W=752, keys=1024, n_levels=8):
    """A full table at the bench shapes (752x480, scale 1.2, 8 levels, 1024
    keys per view, L+R: B=2), with out-of-range corners in the first and
    last level and an extra level without slots that is smaller than a
    window."""
    rng = np.random.default_rng(seed)
    levels, counts, x0s, y0s = [], [], [], []
    shapes = pyramid.level_shapes(H, W, n_levels, 1.2) + [(20, 25)]
    quotas = extract.level_quotas(keys, n_levels, 1.2) + [0]
    for (h, w), q in zip(shapes, quotas):
        levels.append(torch.from_numpy(rng.uniform(0.0, 255.0, size=(B, h, w)).astype(np.float32)).to(dev))
        counts.append(q)
        x0s.append(rng.integers(0, max(w - 31, 0) + 1, size=(B, q)).astype(np.int32))
        y0s.append(rng.integers(0, max(h - 31, 0) + 1, size=(B, q)).astype(np.int32))
    x0, y0 = np.concatenate(x0s, 1), np.concatenate(y0s, 1)
    x0[0, 0], y0[0, 0] = 100_000, -7
    x0[-1, -1], y0[-1, -1] = -3, 1_000
    return levels, counts, torch.from_numpy(x0).to(dev), torch.from_numpy(y0).to(dev)


def test_extract_windows_levels_kernel_equals_plain_version_on_bench_table(dev):
    levels, counts, x0, y0 = _bench_table(dev)
    n0 = patches.LAUNCHES
    out = patches.extract_windows_levels(levels, counts, x0, y0, 31, 31)
    torch.cuda.synchronize()
    assert patches.LAUNCHES == n0 + 1
    assert out.shape == (2, 1024, 31, 31)
    assert torch.equal(out, patches.extract_windows_levels_ref(levels, counts, x0, y0, 31, 31))
    with pytest.raises(ValueError, match="levels own slots"):
        many = [levels[-2]] * (patches.MAX_LEVELS + 1)
        patches.extract_windows_levels(many, [1] * len(many), x0[:, : len(many)].contiguous(),
                                       y0[:, : len(many)].contiguous(), 31, 31)


@pytest.mark.parametrize(
    "B, H, W, keys, n_levels",
    [(8, 480, 752, 1024, 8), (16, 240, 320, 512, 4)],
    ids=["bench-4-sequences", "run_batch-8-sequences"],
)
def test_extract_windows_levels_kernel_on_batched_tables(dev, B, H, W, keys, n_levels):
    """The tables of a batched frame (2S views: 4 sequences at the bench
    shape, 8 at run_batch's) in one launch, torch.equal to the plain
    version."""
    levels, counts, x0, y0 = _bench_table(dev, 4, B, H, W, keys, n_levels)
    n0 = patches.LAUNCHES
    out = patches.extract_windows_levels(levels, counts, x0, y0, 31, 31)
    torch.cuda.synchronize()
    assert patches.LAUNCHES == n0 + 1 and out.shape == (B, keys, 31, 31)
    assert torch.equal(out, patches.extract_windows_levels_ref(levels, counts, x0, y0, 31, 31))


def test_batched_frontend_on_card_matches_cpu(dev):
    """Two sequences x 4 frames of run_batch's configuration through the
    batched frontend on the card and on the CPU: one extract_windows launch
    per batched frame (and one per sequence at frame 0), the same
    keyframes, poses within 1e-3 m."""
    from vslam_torch import run_batch

    out = {}
    for d in (dev, torch.device("cpu")):
        scenes, pairs, front = run_batch.build(2, 4, "small", d)
        frames = [[(sc.render(f), sc.render(f, right=True)) for sc in scenes] for f in range(4)]
        n0 = patches.LAUNCHES
        run_batch.run_frames(front, pairs, frames)
        out[d.type] = (patches.LAUNCHES - n0, [p[0].new_kf_slots for p in pairs],
                       np.stack([p[0].trajectory() for p in pairs]))
    assert out["cuda"][0] == 2 + 3 and out["cpu"][0] == 0
    assert out["cuda"][1] == out["cpu"][1]
    assert np.abs(out["cuda"][2][..., :3, 3] - out["cpu"][2][..., :3, 3]).max() < 1e-3


def test_sharded_ba_on_card_with_virtual_shards(dev):
    """The 2-round BA over meshes of 2 and 4 virtual shards on one card
    against the unsharded card solve (tests/test_parallel.py:36-54's
    tolerances)."""
    from vslam_torch.parallel import mesh, sharded_ba

    p = _on(_ba_problem(), dev)
    ref = schur.local_ba_two_rounds(p)
    for n in (2, 4):
        m = mesh.make_mesh(devices=[dev] * n)
        q, err, kill = sharded_ba.run_problem(sharded_ba.sharded_two_rounds(m), p)
        rel = torch.linalg.inv(ref[0].poses) @ q.poses
        assert float(se3.se3_logmap(rel).abs().max()) < 1e-3
        assert torch.allclose(q.pts, ref[0].pts, rtol=1e-3, atol=1e-3)
        assert torch.equal(kill, ref[2])
        assert abs(float(err) - float(ref[1])) <= 1e-2 * max(float(ref[1]), 1.0)


def test_extract_batch_launches_the_kernel_once(dev):
    """One launch per extract_batch, and the same keys as the same call
    with the plain version in the kernel's place."""
    scene = synthetic.make_scene(n_frames=2, n_points=400, width=320, height=240, fps=10.0, seed=7)
    imgs = torch.from_numpy(np.stack([scene.render(1), scene.render(1, right=True)])).to(dev)
    kw = dict(n_levels=4, scale=1.2, total=512)
    n0 = patches.LAUNCHES
    keys = extract.extract_batch(imgs, **kw)
    torch.cuda.synchronize()
    assert patches.LAUNCHES == n0 + 1
    kernel = patches.extract_windows_levels
    try:
        patches.extract_windows_levels = patches.extract_windows_levels_ref
        ref = extract.extract_batch(imgs, **kw)
    finally:
        patches.extract_windows_levels = kernel
    for a, b in zip(keys, ref):
        assert torch.equal(a, b)


def test_extract_launches_the_kernel_once_and_matches_the_image_space_orb(dev):
    """Single-image extraction: one launch, row 0 of extract_batch; for the
    keys at least 15 px inside level 0, orientations and brief_descriptors
    on the blurred level read the kernel's windows' pixels: angles within
    1e-4 rad, the same descriptors with those angles."""
    scene = synthetic.make_scene(n_frames=2, n_points=400, width=320, height=240, fps=10.0, seed=7)
    img = torch.from_numpy(scene.render(1)).to(dev)
    kw = dict(n_levels=4, scale=1.2, total=512)
    n0 = patches.LAUNCHES
    keys = extract.extract(img, **kw)
    torch.cuda.synchronize()
    assert patches.LAUNCHES == n0 + 1
    for a, b in zip(keys, extract.extract_batch(img[None], **kw).select(0)):
        assert torch.equal(a, b)
    xy = keys.xy.round().long()
    sel = keys.valid & (keys.octave == 0) & (xy >= 15).all(-1)
    sel &= (xy[:, 0] <= 320 - 16) & (xy[:, 1] <= 240 - 16)
    blurred = pyramid.gaussian_blur(img)
    assert int(sel.sum()) > 50
    ang = orb.orientations(blurred, xy[sel])
    assert float((ang - keys.angle[sel]).abs().max()) <= 1e-4
    packed, signed = orb.brief_descriptors(blurred, xy[sel], keys.angle[sel])
    assert torch.equal(packed, keys.packed[sel]) and torch.equal(signed, keys.desc[sel])


# The motion-only LM kernel against its plain version on the same inputs.
# Tolerances: a pass stops at a relative cost decrease under 1e-5, and the
# two versions sum their rows in different orders, so they may stop at
# poses up to 1e-3 apart (entries of T; metres for the translation) with
# final costs 1e-3 apart (relative). Iterations agree within 1 a pass until
# the pass reaches that resolution: from the first iteration whose relative
# cost change is under 1e-5 in the plain version, whether a step lowers
# the cost is decided by the rounding of the sums, and the versions may run
# different tails of rejected and tiny steps (seen: 7 against 2 at poses
# 5e-6 apart). A pose 1e-3 off moves a pixel of a point 4 m away by up to
# 0.18 px, a chi^2 near the 7.815 gate by up to ~1: rows whose chi^2 lies
# within 1.0 of the gate may classify differently (at a solved pose the
# generated rows lie far from it: at most 1% of them may be that close).
LM_POSE_TOL, LM_COST_RTOL, LM_CHI2_MARGIN, LM_REL_TOL = 1e-3, 1e-3, 1.0, 1e-5

LM_CASES = {
    # the tracker's two starts at KITTI 00's active set: shared rows, K, baseline
    "tracker two starts B=2 A=4096": (dict(B=2, M=4096), 100),
    # run_batch's S=8 sequences: per-problem rows, K and baseline
    "per problem B=8": (dict(B=8, M=1024, per_problem=True, seed=1), 100),
    "rows behind the camera": (dict(B=2, M=2048, behind=0.1, seed=2), 100),
    # 90% outliers: the sweep keeps under a quarter, so the guard keeps the valid set
    "enough guard": (dict(B=2, M=2048, outliers=0.9, seed=3), 100),
    "max_iters=0": (dict(B=2, M=4096, seed=4), 0),
}


def _plain_passes(args, max_iters):
    """The plain version, and per LM pass its (B,) iterations and the first
    iteration whose relative cost change was under LM_REL_TOL (max_iters +
    1 where none was), from the costs its residual calls returned."""
    passes, real = [], lm.lm_solve

    def watched(linearize, residual, state0, **kw):
        costs = []

        def res(x):
            r = residual(x)
            costs.append(0.5 * torch.sum(r * r, dim=-1))
            return r

        out = real(linearize, res, state0, **kw)
        err, floor = costs[0], torch.full_like(out.iterations, max_iters + 1)
        for k, c in enumerate(costs[1:], start=1):  # trial k's cost; accepted when lower
            rel = (err - c).abs() / err.clamp(min=1e-12)
            floor = torch.where((rel < LM_REL_TOL) & (floor > max_iters), k, floor)
            err = torch.minimum(err, c)
        passes.append((out.iterations, floor))
        return out

    lm.lm_solve = watched
    try:
        return lm.motion_only_ba_ref(*args, max_iters=max_iters), passes
    finally:
        lm.lm_solve = real


def _lm_compare(args, max_iters):
    """One kernel call (one launch, bit-identical when repeated) against the
    plain version on the card; returns both results."""
    n0, its = lm.LAUNCHES, []
    out = lm.motion_only_ba(*args, max_iters=max_iters, stats=its)
    torch.cuda.synchronize()
    assert lm.LAUNCHES == n0 + 1
    again = lm.motion_only_ba(*args, max_iters=max_iters)
    for a, b in zip(out[:4] + tuple(out[4][1:]), again[:4] + tuple(again[4][1:])):
        assert torch.equal(a, b)
    ref, passes = _plain_passes(args, max_iters)
    T, chi2, inl, st, res = out
    T_r, chi2_r, inl_r, st_r, res_r = ref
    assert float((T - T_r).abs().max()) <= LM_POSE_TOL
    assert torch.allclose(res.error, res_r.error, rtol=LM_COST_RTOL, atol=0)
    for k, (n, floor) in zip(its, passes, strict=True):
        assert bool((((k - n).abs() <= 1) | (torch.minimum(k, n) >= floor - 1)).all()), (k, n, floor)
    assert torch.equal(res.iterations, its[1])
    near = (timing.lm_near_gate(args, T_r, chi2_r, LM_CHI2_MARGIN)
            | timing.lm_near_gate(args, T, chi2, LM_CHI2_MARGIN))
    if max_iters:  # an unsolved pose leaves the chi^2 anywhere
        assert int(near.sum()) <= 0.01 * near.numel()
    assert torch.equal(inl[~near], inl_r[~near]) and torch.equal(st[~near], st_r[~near])
    return out, ref


@pytest.mark.parametrize("case", list(LM_CASES))
def test_motion_only_lm_kernel_equals_plain_version(dev, case):
    kw, max_iters = LM_CASES[case]
    args, T_true = timing.lm_problem(device=dev, **kw)
    (T, chi2, inl, st, res), (_, _, inl_r, _, res_r) = _lm_compare(args, max_iters)
    valid, st_in = args[6], args[4]
    if max_iters == 0:  # the start comes back as it went in
        assert torch.equal(T, args[0]) and int(res.iterations.max()) == 0
        return
    if case != "enough guard":
        assert float((T - T_true).abs().max()) < 0.05
    if case == "rows behind the camera":
        pc = se3.transform_points(se3.inverse(T), args[1][None])
        assert not bool((inl & (pc[..., 2] <= 0.05)).any()) and bool((pc[..., 2] <= 0.05).any())
    elif case == "enough guard":
        assert bool((inl_r.sum(-1) < valid.sum(-1) // 4).all())  # the sweep left too few
    else:
        assert bool((st_in & valid & inl & ~st).any())  # some stereo rows demoted


def test_motion_only_lm_kernel_on_relocalization_call(dev):
    """reloc._verify_candidate's form: one problem, unit weights, no stereo
    or right-only rows, K on the card, a float baseline, max_iters 50."""
    (T0, pts, obs, _, st, _, valid, K, _), _ = timing.lm_problem(B=1, M=2048, seed=5, device=dev)
    none = torch.zeros_like(st)
    obs = obs.clone()
    obs[:, 2] = -1.0
    args = (T0, pts, obs, torch.ones_like(obs[:, 0]), none, none, valid, K, 0.0)
    _lm_compare(args, 50)


def test_pose_solve_controls_still_change_the_card_poses(dev):
    """perfbench's controls patch lm.motion_only_ba: on the card (the
    kernel's path) pose_solve_skipped still returns the prediction (frame
    1 stays at frame 0's pose), and rig_centre still moves each solved pose
    half the baseline along the camera's x (a solve: the kernel's pose
    times the offset; the tracker: poses off the plain run's)."""
    from perfbench import control

    scene = synthetic.make_scene(n_frames=3, n_points=400, width=320, height=240, fps=10.0, seed=7)
    params = tracker.TrackerParams(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60)

    def run():
        world = map_state.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512, device=dev)
        trk = tracker.StereoTracker(scene.K, scene.baseline, 320, 240, world, params, device=dev)
        n0 = lm.LAUNCHES
        for f in range(3):
            trk.track(scene.render(f), scene.render(f, right=True))
        poses = np.asarray(trk.trajectory())
        c = trk.counters
        assert c.get("lm_kernel_solves") == c.get("radius_attempts") == lm.LAUNCHES - n0 > 0
        return poses

    plain = run()
    with control.pose_solve_skipped():
        skipped = run()
    with control.rig_centre({"system": {"Camera": {"bl": scene.baseline}}}):
        shifted = run()
    assert np.abs(plain[1][:3, 3] - plain[0][:3, 3]).max() > 0.01  # the scene moves
    np.testing.assert_array_equal(skipped[1], skipped[0])
    assert np.abs(shifted[1:, :3, 3] - plain[1:, :3, 3]).max() > 0.01
    args, _ = timing.lm_problem(B=2, M=1024, device=dev)
    T = lm.motion_only_ba(*args)[0]
    cfg = {"system": {"Camera": {"bl": 0.537}}}
    with control.rig_centre(cfg):
        n0 = lm.LAUNCHES
        T_shift = lm.motion_only_ba(*args)[0]
        assert lm.LAUNCHES == n0 + 1
    d = torch.eye(4, device=dev)
    d[0, 3] = 0.5 * 0.537
    assert torch.allclose(T_shift, T @ d, atol=1e-6, rtol=0)


def test_tracker_on_card_matches_cpu(dev):
    """Five frames of the small tracker scene on the card and on the CPU
    (plain versions): the same keyframes, poses within 1e-4 m."""
    scene = synthetic.make_scene(n_frames=5, n_points=400, width=320, height=240, fps=10.0, seed=7)
    params = tracker.TrackerParams(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60)
    runs = {}
    for d in (dev, torch.device("cpu")):
        world = map_state.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512, device=d)
        trk = tracker.StereoTracker(scene.K, scene.baseline, 320, 240, world, params, device=d)
        n0 = patches.LAUNCHES
        for f in range(5):
            trk.track(scene.render(f), scene.render(f, right=True))
        runs[d.type] = (trk, trk.trajectory(), patches.LAUNCHES - n0)
    (tg, pg, launches), (tc, pc, cpu_launches) = runs["cuda"], runs["cpu"]
    assert launches == 5 and cpu_launches == 0  # one launch per stereo frame
    # every pose solve on the card took the LM kernel, none on the CPU
    cg, cc = tg.counters, tc.counters
    assert cg.get("lm_kernel_solves") == cg.get("radius_attempts") > 0 == cc.get("lm_kernel_solves")
    assert 0 < cg.get("lm_iters") <= cc.get("lm_iters") + 2 * cc.get("radius_attempts")
    assert tg.new_kf_slots == tc.new_kf_slots
    np.testing.assert_allclose(pg, pc, atol=1e-4, rtol=0)


def _ba_problem(seed=3, W=6, L=96, n_bad=30) -> schur.BAProblem:
    """tests/test_ba.py's window (W poses on a forward path, every landmark
    seen by every pose, stereo on even landmarks, perturbed poses and
    points) with outliers on stereo rows, built on the CPU without jax."""
    rng = np.random.default_rng(seed)
    Kc = torch.tensor([[460.0, 0, 320.0], [0, 460.0, 240.0], [0, 0, 1.0]])
    xi = torch.tensor([[0.01 * i, 0.02 * i, 0.005 * i, 0.1 * i, 0.01 * i, 0.6 * i] for i in range(W)])
    poses_gt = se3.se3_expmap(xi)
    pts_gt = torch.from_numpy(np.stack(
        [rng.uniform(-6, 6, L), rng.uniform(-4, 4, L), rng.uniform(6, 30, L)], -1
    ).astype(np.float32))
    pc = se3.transform_points(se3.inverse(poses_gt), pts_gt[None])  # (W, L, 3)
    u = 460.0 * pc[..., 0] / pc[..., 2] + 320.0
    v = 460.0 * pc[..., 1] / pc[..., 2] + 240.0
    ur = 460.0 * (pc[..., 0] - 0.12) / pc[..., 2] + 320.0
    uv = torch.stack([u, v, ur], -1).reshape(-1, 3)
    obs_lm = torch.arange(L).repeat(W)
    bad = rng.choice(np.nonzero(obs_lm.numpy() % 2 == 0)[0], n_bad, replace=False)
    uv[bad, :2] += torch.from_numpy(rng.uniform(15, 40, (n_bad, 2)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(0, 0.02, (W, 6)).astype(np.float32))
    noise[0] = 0.0
    n = W * L
    return schur.BAProblem(
        poses=poses_gt @ se3.se3_expmap(noise), fixed=torch.arange(W) == 0,
        pose_valid=torch.ones(W, dtype=torch.bool),
        pts=pts_gt + torch.from_numpy(rng.normal(0, 0.05, (L, 3)).astype(np.float32)),
        pt_valid=torch.ones(L, dtype=torch.bool),
        obs_kf=torch.arange(W).repeat_interleave(L), obs_lm=obs_lm, obs_uv=uv,
        obs_stereo=obs_lm % 2 == 0, obs_right=torch.zeros(n, dtype=torch.bool),
        obs_w=torch.ones(n), obs_valid=torch.ones(n, dtype=torch.bool), K=Kc,
        baseline=torch.tensor(0.12), odo_rel=se3.inverse(poses_gt[:-1]) @ poses_gt[1:],
        odo_valid=torch.ones(W - 1, dtype=torch.bool),
    )


def _on(p, dev):
    return schur.BAProblem(*(t.to(dev) for t in p))


def test_local_ba_on_card_is_bit_reproducible(dev):
    """Two solves of one window on the card are bit-identical: the Hessian
    blocks are summed by a sorted segment sum, not by float atomics."""
    p = _on(_ba_problem(), dev)
    a = schur.local_ba_two_rounds(p)
    b = schur.local_ba_two_rounds(p)
    for x, y in zip((a[0].poses, a[0].pts, a[0].obs_valid, a[1], a[2]),
                    (b[0].poses, b[0].pts, b[0].obs_valid, b[1], b[2])):
        assert torch.equal(x, y)


def test_split_ba_rounds_on_card_equal_two_rounds(dev):
    """local_ba_round1 then local_ba_round2 on the card: the same bits as
    local_ba_two_rounds."""
    p = _on(_ba_problem(), dev)
    a = schur.local_ba_round2(schur.local_ba_round1(p))
    b = schur.local_ba_two_rounds(p)
    for x, y in zip((a[0].poses, a[0].pts, a[0].obs_valid, a[1], a[2]),
                    (b[0].poses, b[0].pts, b[0].obs_valid, b[1], b[2])):
        assert torch.equal(x, y)


def test_local_ba_on_card_matches_cpu(dev):
    """The same window on the card and on the CPU: poses within 1e-4,
    landmarks within 1e-4 of their range, the sweep and kill masks
    identical."""
    p = _ba_problem()
    g = schur.local_ba_two_rounds(_on(p, dev))
    c = schur.local_ba_two_rounds(p)
    np.testing.assert_allclose(g[0].poses.cpu().numpy(), c[0].poses.numpy(), atol=1e-4, rtol=0)
    dist = torch.linalg.norm(g[0].pts.cpu() - c[0].pts, dim=1)
    assert bool((dist <= 1e-4 * torch.linalg.norm(c[0].pts, dim=1)).all()), float(dist.max())
    assert torch.equal(g[0].obs_valid.cpu(), c[0].obs_valid)
    assert torch.equal(g[2].cpu(), c[2])


def _small_system_conf(slam_mode: int = 1) -> ConfigFile:
    cam = {"fx": 460.0, "fy": 460.0, "cx": 160.0, "cy": 120.0}
    return ConfigFile.from_dict({
        "rectified": True, "slamMode": slam_mode, "Camera_l": cam, "Camera_r": cam,
        "Camera": {"width": 320, "height": 240, "fps": 10.0, "bl": 0.12},
        "FE": {"nFeatures": 512, "nLevels": 4, "imScale": 1.2},
        "IMU": {"Hz": 200, "gravity": [0.0, 0.0, -9.81]},
    })


def test_system_on_card_matches_cpu(dev):
    """Twelve frames of the small system scene through VSlamSystem on the
    card and on the CPU: the same keyframes and local-BA runs, one
    extract_windows launch per frame, poses within 1e-3."""
    scene = synthetic.make_scene(n_frames=12, n_points=400, width=320, height=240, fps=10.0, seed=7)
    conf = _small_system_conf()
    params = tracker.TrackerParams(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60)
    runs = {}
    for d in (dev, torch.device("cpu")):
        sys_ = system.VSlamSystem(conf, lm_capacity=8192, kf_capacity=64, tracker_params=params, device=d)
        n0 = patches.LAUNCHES
        for f in range(12):
            sys_.track_stereo(scene.render(f), scene.render(f, right=True))
        sys_.exit()
        runs[d.type] = (sys_, sys_.trajectory(), patches.LAUNCHES - n0)
    (sg, pg, launches), (sc, pc, _) = runs["cuda"], runs["cpu"]
    assert launches == 12
    assert sg.tracker.new_kf_slots == sc.tracker.new_kf_slots
    assert sg.mapper.ba_count == sc.mapper.ba_count >= 2
    np.testing.assert_allclose(pg, pc, atol=1e-3, rtol=0)


def test_async_worker_on_card_matches_sync_mapper(dev):
    """The async facade with a zero consume latency on the card: the BA is
    solved on the worker thread's side stream behind phase A's event and
    written back after the join, before the next tracked frame, as the
    sync mapper does; the keyframe poses are the sync run's bit for bit."""
    scene = synthetic.make_scene(n_frames=12, n_points=400, width=320, height=240, fps=10.0, seed=7)
    params = tracker.TrackerParams(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60)
    runs = []
    for async_ba in (False, True):
        sys_ = system.VSlamSystem(_small_system_conf(), async_ba=async_ba, lm_capacity=8192,
                                  kf_capacity=64, tracker_params=params, device=dev)
        sys_.ba_latency_frames = 0
        sys_.deterministic_ba_latency = True
        for f in range(12):
            sys_.track_stereo(scene.render(f), scene.render(f, right=True))
        sys_.exit()
        runs.append((sys_, sys_.trajectory()))
    (ss, ps), (sa, pa) = runs
    assert sa.mapper.ba_count == ss.mapper.ba_count >= 2
    assert sa.tracker.new_kf_slots == ss.tracker.new_kf_slots
    assert sa._pending_ba is None and sa.mapper._side is not None
    np.testing.assert_array_equal(sa.world.kf_poses_host, ss.world.kf_poses_host)
    np.testing.assert_allclose(pa, ps, atol=1e-6, rtol=0)


def test_stereo_imu_on_card_matches_cpu(dev):
    """Eight STEREO_IMU frames (the scene's gravity and initial velocity,
    IMU rows per frame) on the card and on the CPU: the same keyframes,
    poses within 1e-3."""
    from vslam_torch.utils import datasets

    scene = synthetic.make_scene(n_frames=8, n_points=400, width=320, height=240, fps=10.0, seed=7)
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    params = tracker.TrackerParams(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60)
    runs = {}
    for d in (dev, torch.device("cpu")):
        sys_ = system.VSlamSystem(_small_system_conf(0), lm_capacity=8192, kf_capacity=64,
                                  tracker_params=params, device=d)
        sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
        for f in range(8):
            sys_.track_stereo(scene.render(f), scene.render(f, right=True), imu=bins[f])
        sys_.exit()
        runs[d.type] = (sys_, sys_.trajectory())
    (sg, pg), (sc, pc) = runs["cuda"], runs["cpu"]
    assert sg.tracker.imu_cfg is not None and sg.tracker.new_kf_slots == sc.tracker.new_kf_slots
    np.testing.assert_allclose(pg, pc, atol=1e-3, rtol=0)


def test_mono_on_card_matches_cpu(dev):
    """Twelve frames of the lateral mono scene (tests/test_system.py's,
    1024 features) through VSlamSystem in slamMode 2 on the card and on the
    CPU: the same bootstrap and keyframe slots and landmark count, one
    extract_windows launch per bootstrap view and per tracked frame, poses
    within 1e-3."""
    from vslam_torch.utils import datasets

    scene = synthetic.make_scene(n_frames=12, n_points=500, width=320, height=240, fps=10.0, seed=7,
                                 texture="distinct", motion="lateral")
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    params = tracker.TrackerParams(n_features=1024, n_levels=4, active_size=2048, kf_min_stereo=60)
    runs = {}
    for d in (dev, torch.device("cpu")):
        sys_ = system.VSlamSystem(_small_system_conf(2), lm_capacity=8192, kf_capacity=64,
                                  tracker_params=params, device=d)
        sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
        n0 = patches.LAUNCHES
        for f in range(12):
            sys_.track_mono_imu(scene.render(f), imu=bins[f])
        sys_.exit()
        runs[d.type] = (sys_, sys_.trajectory(), patches.LAUNCHES - n0)
    (sg, pg, launches), (sc, pc, cpu_launches) = runs["cuda"], runs["cpu"]
    trk = sg.tracker
    assert isinstance(trk, tracker.MonoTracker) and trk.initialized and cpu_launches == 0
    tracked = 12 - 1 - int(sg.world.kf_frame_idx[trk.bootstrap_slots[-1]])
    assert launches == len(trk.bootstrap_slots) + tracked
    assert trk.bootstrap_slots == sc.tracker.bootstrap_slots
    assert trk.new_kf_slots == sc.tracker.new_kf_slots
    assert sg.world.n_landmarks == sc.world.n_landmarks
    np.testing.assert_allclose(pg, pc, atol=1e-3, rtol=0)


def test_retrieve_on_card_matches_cpu(dev):
    """reloc.retrieve of a mapped view (frame 2 of an 8-frame stereo run
    on the CPU) against the map copied to the card: the same keyframe and
    votes, the verified pose within 1e-4."""
    import dataclasses

    scene = synthetic.make_scene(n_frames=8, n_points=400, width=320, height=240, fps=10.0, seed=7)
    params = tracker.TrackerParams(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60)
    world = map_state.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512, device="cpu")
    trk = tracker.StereoTracker(scene.K, scene.baseline, 320, 240, world, params, device="cpu")
    for f in range(8):
        trk.track(scene.render(f), scene.render(f, right=True))
    trk.flush()
    img = torch.from_numpy(scene.render(2)[None].astype(np.float32))
    kw = dict(n_levels=4, scale=1.2, total=512)
    cpu = reloc.retrieve(world, extract.extract_batch(img, **kw).select(0), world.n_keyframes, scene.K)
    world.arrays = map_state.MapArrays(**{f.name: getattr(world.arrays, f.name).to(dev)
                                          for f in dataclasses.fields(world.arrays)})
    card = reloc.retrieve(world, extract.extract_batch(img.to(dev), **kw).select(0), world.n_keyframes,
                          scene.K)
    assert card[0] == cpu[0] >= 0 and card[1] == cpu[1] >= reloc.MIN_VOTES
    np.testing.assert_allclose(card[2], cpu[2], atol=1e-4, rtol=0)


def test_slabbed_schur_on_card(dev):
    """The 2-round BA with the reduction in 4 landmark slabs on the card:
    bit-identical when repeated, within 5e-4 of the unslabbed solve
    (tests/test_ba.py:141-147), the same kill mask."""
    p = _on(_ba_problem(), dev)
    a = schur.local_ba_two_rounds(p, n_slabs=4)
    b = schur.local_ba_two_rounds(p, n_slabs=4)
    c = schur.local_ba_two_rounds(p)
    assert torch.equal(a[0].poses, b[0].poses) and torch.equal(a[2], b[2])
    np.testing.assert_allclose(a[0].poses.cpu().numpy(), c[0].poses.cpu().numpy(), atol=5e-4, rtol=0)
    assert torch.equal(a[2], c[2])


def _drifted_graph(n=40):
    """A 40-pose chain with biased odometry and one true loop edge 0 -> n-1
    (tests/test_loop_closure.py:18-60's problem, built with the port's
    se3): (poses, chain_rel, loop-edge slots)."""
    def expm(xi):
        return se3.se3_expmap(torch.tensor(xi, dtype=torch.float32)).numpy()

    step, drift = expm([0.0, 0.02, 0.0, 0.0, 0.0, 0.3]), expm([5e-4, 0.0225, 0.0, 0.004, 0.002, 0.301])
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
        est.append(est[-1] @ drift)
    gt, est = np.stack(gt), np.stack(est)
    loop = (np.array([0, 0, 0, 0]), np.array([n - 1, 0, 0, 0]),
            np.stack([np.linalg.inv(gt[0]) @ gt[-1]] + [np.eye(4, dtype=np.float32)] * 3).astype(np.float32),
            np.array([100.0, 0, 0, 0], np.float32))
    return est, np.tile(drift, (n - 1, 1, 1)), loop


@pytest.mark.parametrize("solver", ["dense", "chain", "sim3"])
def test_pose_graph_on_card_matches_cpu(dev, solver):
    """Each pose-graph solver on the card: bit-identical when repeated,
    within 5e-5 of the same solve on the CPU (another sum order over 30
    GN steps; translations reach 12 m, so a few float32 ulps)."""
    from vslam_torch.models import pose_graph

    est, chain_rel, (li, lj, lrel, lw) = _drifted_graph()
    n = len(est)
    w = np.full(n - 1, 100.0, np.float32)
    if solver == "dense":
        ei = np.concatenate([np.arange(n - 1), li[:1]])
        ej = np.concatenate([np.arange(1, n), lj[:1]])
        args = (est, np.ones(n, bool), ei, ej, np.concatenate([chain_rel, lrel[:1]]), np.full(n, 100.0, np.float32))
        fn = pose_graph.optimize
    else:
        args = (est, np.ones(n, bool), chain_rel, w, li, lj, lrel, lw)
        fn = pose_graph.optimize_chain if solver == "chain" else pose_graph.optimize_sim3_chain

    def run(device):
        return fn(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args), iters=30)

    a, b, c = run(dev), run(dev), run("cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    np.testing.assert_allclose(a[0].cpu().numpy(), c[0].numpy(), atol=5e-5, rtol=0)


@pytest.mark.parametrize("case", ["stereo", "mono"])
def test_split_map_closure_on_card_matches_cpu(dev, case):
    """The split-map closure (tests/test_loop_closure.py:374-456; mono
    through the Sim(3) graph) on the card and on the CPU: the same old
    keyframe, merge pairs and n_merged, identical observation tables,
    keyframe poses within 1e-4."""
    from vslam_torch.models import loop_closure

    scale_err, baseline = {"stereo": (1.0, 0.12), "mono": (0.9, 0.0)}[case]
    out = []
    for device in (dev, "cpu"):
        w, _, _, K = synthetic.split_map_world(scale_err=scale_err, device=device)
        n = w.n_keyframes
        c = loop_closure.LoopCloser(w, K, baseline, min_gap=3)
        assert c.try_close(n - 2) is None
        pairs = c._merge_pairs(n - 1, c._last_cand[1])
        r = c.try_close(n - 1)
        out.append((pairs, r, w))
    (pg, rg, wg), (pc, rc, wc) = out
    assert pg == pc and rg is not None and rc is not None
    assert (rg["old_kf"], rg["n_merged"], rg["path"]) == (rc["old_kf"], rc["n_merged"], rc["path"])
    assert torch.equal(wg.arrays.obs_lm.cpu(), wc.arrays.obs_lm) and np.array_equal(wg.kf_obs_lm, wc.kf_obs_lm)
    assert torch.equal(wg.arrays.lm_valid.cpu(), wc.arrays.lm_valid)
    np.testing.assert_allclose(wg.kf_poses_host, wc.kf_poses_host, atol=1e-4, rtol=0)


TOOL_NAMES = ["ab_kf_policy", "measure_ba_scaling", "profile_bench", "profile_depth", "profile_device",
              "profile_extract", "profile_frame", "profile_rtt", "profile_solver", "roofline"]

# Each tool runs in a fresh process (a process that has run the async
# mapper, as earlier tests here do, can lose the kernels of a short
# profiled call), cut to tests/test_torch_tools.py's size: 320x240, 512
# features, 4 levels; short runs, two keyframe variants, an eighth of the
# BA windows' landmarks.
_TOOL_DRIVER = """
import importlib, sys
from vslam_torch.tools import (_common, ab_kf_policy, measure_ba_scaling, profile_bench, profile_depth,
                               profile_extract, profile_solver)

_common.SCENE = dict(n_points=400, width=320, height=240, fps=10.0, seed=7)
_common.PARAMS = dict(n_features=512, n_levels=4, active_size=1024)
for mod, values in ((profile_extract, dict(H=240, W=320, N_LEVELS=4, TOTAL=512)),
                    (profile_solver, dict(A=1024, N=512)),
                    (profile_bench, dict(N_FRAMES=16, WARMUP=6)), (profile_depth, dict(N_FRAMES=14, WARMUP=6)),
                    (ab_kf_policy, dict(N_FRAMES=16, WARMUP=6, VARIANTS=ab_kf_policy.VARIANTS[:2]))):
    for name, value in values.items():
        setattr(mod, name, value)
build = measure_ba_scaling.build_problem
measure_ba_scaling.build_problem = lambda Wn=20, L=4096, **kw: build(Wn=min(Wn, 20), L=L // 8, **kw)
name = sys.argv[1]
if __name__ == "__main__":
    importlib.import_module("vslam_torch.tools." + name).main(
        *([["--device", "cuda"]] if name == "measure_ba_scaling" else []))
"""


@pytest.mark.parametrize("name", TOOL_NAMES)
def test_tool_main_on_card(dev, name):
    """Each measuring tool's main on the card at a small size, in a fresh
    process: rc 0 and one JSON line with the card's name and power limit
    and its rows; the roofline's 8 rows all timed, none above its bound,
    the one-launch patch row a single extract_windows launch, the warm-up
    one launch per frame."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _TOOL_DRIVER, name], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith('{"tool"')][-1])
    assert line["tool"] == name and line["device"]["name"] and line["device"]["power_limit"]
    assert line["rows"]
    if name == "roofline":
        assert len(line["rows"]) == 8
        for r in line["rows"]:
            assert r["device_ms"] > 0 and 0 < r["share_pct"] <= 100, r
        (patch,) = [r for r in line["rows"] if r["stage"].startswith("patches frame")]
        assert patch["extract_windows_launches"] == 1 and patch["syncs"] == 0
        assert line["warmup_extract_windows_launches"] == line["warmup_frames"]


# ---------------------------------------------------------------------------
# Across four cards (vslam_torch/dryrun.py, VSlamSystem(shards=4),
# run_global and run_dataset over a 4-card mesh). They need 4 cards and
# skip with fewer; each prints one JSON line of what it measured.

N_CARDS = 4
SYS_FRAMES = 40  # chip_smoke.py phase 6: the first 40 frames of the bench's 80-frame scene
SYS_ATE_GATE_M, SYS_POSE_TOL_M = 0.05, 1e-3
FRONTEND_TOL_M = 2e-3  # a batch against its solo runs, tests/test_parallel.py:292
DS_ATE_GATE_M = 0.08  # tests/test_driver.py:118 (uint8 PNG input)


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available():
        pytest.skip(f"needs {N_CARDS} CUDA cards (the CUDA kernels have no CPU or interpret mode)")
    n = torch.cuda.device_count()
    if n < N_CARDS:
        pytest.skip(f"needs {N_CARDS} CUDA cards; {n} visible")
    from vslam_torch.parallel import mesh as mesh_mod

    return [str(d) for d in mesh_mod.make_mesh(N_CARDS).devices]  # cuda:0..3


@pytest.fixture(scope="module")
def dryrun_cards(cards):
    """The dry run over cuda:0..3, over four virtual shards on cuda:0, and
    parts (a) and (b) unsharded on cuda:0."""
    from vslam_torch import dryrun

    res = dryrun.dryrun_multichip(N_CARDS)
    virt = dryrun.dryrun_multichip(N_CARDS, devices=["cuda:0"] * N_CARDS)
    return res, virt, dryrun.unsharded(dryrun.dryrun_problem(N_CARDS, "cuda:0"))


def _emit(test: str, **fields):
    import json

    print(json.dumps({"test": test, **fields}), flush=True)


@pytest.mark.parametrize("part", ["a", "b"])
def test_dryrun_solve_on_four_cards_equals_virtual_shards(cards, dryrun_cards, part):
    """Part (a) (the live-size two-round BA, 2 + 2 iterations) and part (b)
    (4 landmark slabs, 1 + 1) on cuda:0..3: bit for bit the same solve over
    four virtual shards on cuda:0 (the same kernels on the same inputs,
    the partials summed on cuda:0 in shard order), and within
    test_sharded_ba_on_card_with_virtual_shards's tolerances of the
    unsharded cuda:0 solve."""
    from vslam_torch import dryrun

    res, virt, ref = dryrun_cards
    assert res["mesh"] == cards
    vs_virtual, vs_unsharded = dryrun.compare(res[part], virt[part]), dryrun.compare(res[part], ref[part])
    _emit(f"dryrun_{part}_cards", wall_s=res[part]["wall_s"], virtual_wall_s=virt[part]["wall_s"],
          unsharded_wall_s=ref[part]["wall_s"], iters=res[part]["iters"], vs_virtual=vs_virtual,
          vs_unsharded=vs_unsharded)
    assert vs_virtual["bit_equal"], vs_virtual
    assert vs_unsharded["within"], vs_unsharded


def test_dryrun_frontend_on_four_cards(cards, dryrun_cards):
    """Part (c): sequence s's tracker on cuda:s, one batched step per card.
    Each card made one extract_windows launch, equal to its plain version
    on the same card; the trajectories are bit for bit those of four
    one-sequence frontends on cuda:0, and within FRONTEND_TOL_M of one
    four-sequence batch on cuda:0."""
    from vslam_torch import dryrun

    res, virt, _ = dryrun_cards
    c = res["c"]
    assert c["devices"] == cards and c["launches"] == [1] * N_CARDS
    assert [w["device"] for w in c["windows"]] == cards
    assert all(w["equal"] and w["max_abs_err"] == 0.0 for w in c["windows"]), c["windows"]
    batch = dryrun.dryrun_frontend(["cuda:0"] * N_CARDS, split=False)
    gap = float(np.abs(c["poses"][..., :3, 3] - batch["poses"][..., :3, 3]).max())
    _emit("dryrun_c_cards", wall_s=c["wall_s"], launches=c["launches"], windows=c["windows"],
          vs_virtual_equal=bool(np.array_equal(c["poses"], virt["c"]["poses"])), vs_one_batch_max_dt_m=gap,
          vs_one_batch_equal=bool(np.array_equal(c["poses"], batch["poses"])))
    assert np.isfinite(c["poses"]).all()
    assert np.array_equal(c["poses"], virt["c"]["poses"])
    assert gap <= FRONTEND_TOL_M


def test_nccl_processes_on_four_cards(cards):
    """Part (a) over four processes, one card each, joined by NCCL: the
    ranks' results are identical, and each is within the card tolerances of
    the single-process four-card solve (NCCL's all-reduce adds the four
    partials in its own order, the single process in shard order)."""
    from vslam_torch import dryrun

    out = dryrun.run_processes(N_CARDS, "cuda")
    _emit("dryrun_nccl_cards", ranks=out["ranks"], single_process_wall_s=out["single_process_wall_s"])
    assert [r["rank"] for r in out["ranks"]] == list(range(N_CARDS))
    for r in out["ranks"]:
        assert r["iters"] == [2, 2] and r["vs_single_process"]["within"], r
    for res in out["results"][1:]:
        for k in ("poses", "pts", "err", "kill"):
            assert np.array_equal(res[k], out["results"][0][k]), k


def test_run_global_on_four_cards(cards):
    """LocalMapper.run_global on chip_smoke.py phase 15's corridor (256
    keyframes, 50,000 landmarks, 8 slabs) with a 4-card mesh, and without:
    phase 15's gates on both (8 slabs, error < 0.01 per observation,
    relative error < 0.7x the drifted one); wall per LM iteration, and the
    launches and each card's device busy of one slabbed iteration."""
    import time

    from vslam_torch.models import local_mapper
    from vslam_torch.parallel import mesh as mesh_mod
    from vslam_torch.tools import measure_ba_scaling

    out = {}
    for name, m in (("unsharded", None), ("cards", mesh_mod.make_mesh(N_CARDS))):
        world, c = synthetic.corridor_world(256, 50_000, 1024, device="cuda")
        rng = np.random.default_rng(1)
        drift = np.cumsum(rng.normal(0, 0.004, (256, 3)), axis=0).astype(np.float32)
        drift[0] = 0.0
        pert = c["poses"].copy()
        pert[:, :3, 3] += drift
        world.arrays.kf_pose.copy_(torch.from_numpy(pert))
        world.kf_poses_host[:] = pert
        mapper = local_mapper.LocalMapper(world, c["K"], c["baseline"],
                                          local_mapper.LocalMapperConfig(iters_round1=3, iters_round2=5), mesh=m)
        solve, problems = local_mapper.schur.local_ba_two_rounds, []

        def recording(p, *args, **kwargs):
            problems.append((p, kwargs.get("n_slabs", 1)))
            return solve(p, *args, **kwargs)

        local_mapper.schur.local_ba_two_rounds = recording
        try:
            measure_ba_scaling._sync("cuda")
            t0 = time.perf_counter()
            r = mapper.run_global(max_landmarks=1 << 17)
            measure_ba_scaling._sync("cuda")
            wall = time.perf_counter() - t0
        finally:
            local_mapper.schur.local_ba_two_rounds = solve
        n_obs = int((c["obs_lm"] >= 0).sum())
        rel = lambda ps: float(np.mean(np.linalg.norm(  # noqa: E731
            (np.linalg.inv(ps[:-5]) @ ps[5:])[:, :3, 3] - (np.linalg.inv(c["poses"][:-5]) @ c["poses"][5:])[:, :3, 3],
            axis=1)))
        iters = mapper.counters.get("lm_iters_round1") + mapper.counters.get("lm_iters_round2")
        p, n_slabs = problems[-1]
        out[name] = {"wall_s": wall, "lm_iters": iters, "wall_ms_per_iter": wall * 1e3 / iters,
                     "n_slabs": n_slabs, "error_per_obs": r["error"] / n_obs,
                     "rel_err": [rel(pert), rel(world.kf_poses_host[:256])],
                     **measure_ba_scaling.iteration_profile(p, m, n_slabs)}
    _emit("run_global_cards", **out)
    for name, o in out.items():
        assert o["n_slabs"] == 8 and o["error_per_obs"] < 0.01, (name, o)
        assert o["rel_err"][1] < 0.7 * o["rel_err"][0], (name, o)


@pytest.fixture(scope="module")
def bench_frames(cards):
    """The first SYS_FRAMES frames of the bench's 80-frame scene, on cuda:0."""
    from vslam_torch.tools import _common

    scene = _common.bench_scene(80)
    frames = _common.scene_frames(scene)[:SYS_FRAMES]
    return scene, [torch.from_numpy(f).to("cuda:0", torch.float32) for f in frames]


def _bench_system(scene, shards, async_ba):
    """chip_smoke.py phase 6's facade (the bench's tracker parameters and
    map capacities) with `shards` and the sync or async mapper."""
    K = scene.K
    cam = {"fx": float(K[0, 0]), "fy": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2])}
    conf = ConfigFile.from_dict({
        "rectified": True, "slamMode": 1, "Camera_l": dict(cam), "Camera_r": dict(cam),
        "Camera": {"width": scene.width, "height": scene.height, "fps": 20.0, "bl": float(scene.baseline)},
        "FE": {"nFeatures": 1024, "nLevels": 8, "imScale": 1.2},
    })
    sys_ = system.VSlamSystem(conf, async_ba=async_ba, lm_capacity=1 << 15, kf_capacity=128, shards=shards,
                              tracker_params=tracker.TrackerParams(n_features=1024, n_levels=8, active_size=4096))
    sys_.deterministic_ba_latency = True
    return sys_


@pytest.mark.parametrize("async_ba", [False, True], ids=["sync", "async"])
def test_system_shards_on_four_cards(cards, bench_frames, async_ba):
    """VSlamSystem(shards=4) over the bench's first 40 frames against
    shards=None: the same keyframe slots and BA count, poses within 1e-3
    m, ATE <= 0.05 m; fps, BA walls and the window kernel's launches (one
    per frame) of both."""
    import time

    from vslam_torch.utils import trajectory

    scene, frames = bench_frames
    out = {}
    for shards in (None, N_CARDS):
        sys_ = _bench_system(scene, shards, async_ba)
        assert (sys_.mapper.mesh is None) == (shards is None)
        if shards:
            assert [str(d) for d in sys_.mapper.mesh.devices] == cards
        n0 = patches.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fr in frames:
            sys_.track_stereo(fr[0], fr[1])
        sys_.exit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traj = sys_.trajectory()
        out[shards] = {"fps": len(frames) / wall, "launches": patches.LAUNCHES - n0,
                       "keyframes": list(sys_.tracker.new_kf_slots), "ba_runs": sys_.mapper.ba_count,
                       "ate_m": trajectory.ate_rmse(traj, scene.poses_c2w[: len(traj)], align=False),
                       "ba": sys_.mapper.metrics.summary(), "traj": traj}
    a, b = out[None], out[N_CARDS]
    dt = float(np.linalg.norm(a["traj"][:, :3, 3] - b["traj"][:, :3, 3], axis=1).max())
    _emit(f"system_{'async' if async_ba else 'sync'}_cards", max_dt_m=dt,
          **{str(k): {n: v for n, v in o.items() if n != "traj"} for k, o in out.items()})
    assert a["launches"] == b["launches"] == SYS_FRAMES
    assert a["keyframes"] == b["keyframes"] and a["ba_runs"] == b["ba_runs"] > 0
    assert dt <= SYS_POSE_TOL_M
    assert a["ate_m"] <= SYS_ATE_GATE_M and b["ate_m"] <= SYS_ATE_GATE_M


def test_run_dataset_shards_on_four_cards(cards, tmp_path):
    """python -m vslam_torch.run_dataset --shards 4 on 20 frames in the
    KITTI layout at KITTI 00's 1241x376 (chip_smoke.py phase 17's scene,
    seed 6, uint8 PNGs), against the same run unsharded: the same
    keyframes and BA runs, trajectories within 1e-3 m, ATE <= 0.08 m."""
    import json
    import os

    from PIL import Image

    from vslam_torch import run_dataset
    from vslam_torch.utils import trajectory

    n = 20
    scene = synthetic.make_scene(n_frames=n, n_points=900, width=1241, height=376, fps=10.0, seed=6)
    for sub in ("image_0", "image_1"):
        os.makedirs(tmp_path / sub)
        for f in range(n):
            img = scene.render(f, right=sub == "image_1")
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(tmp_path / sub / f"{f:06d}.png")
    np.savetxt(tmp_path / "times.txt", scene.times[:n])
    K = scene.K
    cam = {"fx": float(K[0, 0]), "fy": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2])}
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "rectified": True, "slamMode": 1, "dataset": "KITTI", "imagesPath": str(tmp_path),
        "fileExtension": ".png", "Camera_l": cam, "Camera_r": cam,
        "Camera": {"width": 1241, "height": 376, "fps": 10.0, "bl": float(scene.baseline)},
        "FE": {"nFeatures": 2000, "nLevels": 8, "imScale": 1.2, "edgeThreshold": 19,
               "maxFastThreshold": 20, "minFastThreshold": 7},
    }))
    out = {}
    for shards in (None, str(N_CARDS)):
        path = tmp_path / f"traj_{shards}.txt"
        r = run_dataset.main([str(cfg), "--no-prefetch", "--out", str(path)]
                             + (["--shards", shards] if shards else []))
        traj = trajectory.load_kitti_trajectory(str(path))
        out[shards] = {**{k: r[k] for k in ("frames", "fps", "keyframes", "ba_runs")},
                       "ate_m": trajectory.ate_rmse(traj, scene.poses_c2w[:n], align=False), "traj": traj}
    a, b = out[None], out[str(N_CARDS)]
    dt = float(np.linalg.norm(a["traj"][:, :3, 3] - b["traj"][:, :3, 3], axis=1).max())
    _emit("run_dataset_cards", max_dt_m=dt, **{str(k): {n: v for n, v in o.items() if n != "traj"}
                                               for k, o in out.items()})
    assert a["frames"] == b["frames"] == n
    assert a["keyframes"] == b["keyframes"] and a["ba_runs"] == b["ba_runs"]
    assert dt <= SYS_POSE_TOL_M and a["ate_m"] <= DS_ATE_GATE_M and b["ate_m"] <= DS_ATE_GATE_M
