"""Tests of the port that need a CUDA device: the hand-written kernels
against their plain PyTorch versions, a short tracker run and a short
VSlamSystem run on the card against the same runs on the CPU, the local
BA's bit-reproducibility on the card, the async mapper's worker thread and
side stream against the sync mapper, a short STEREO_IMU run, a short
mono-inertial run, relocalization retrieval, the slab-chunked Schur
reduction and the split BA rounds, single-image extraction against the
image-space ORB, the pose graphs, the split-map loop closure, the batched
frontend's kernel tables and run, the sharded BA over virtual shards
on one card, and each measuring tool's main (vslam_torch/tools) at a
small size. They skip without a card. This file
imports no jax (the GPU machine has none); run it there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from vslam_torch.geometry import se3
from vslam_torch.models import map_state, reloc, system, tracker
from vslam_torch.ops import extract, orb, patches, pyramid, schur
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
