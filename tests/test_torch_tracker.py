"""The port's stereo tracking slice against vslam_tpu on the CPU: one
tracked frame from a state handed across by ``vslam_torch.models.convert``,
the whole tracker (no mapper) on the tests/test_tracking.py scene, the
map allocator, the paths that are not ported (they raise), and a check
that the port never imports jax."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_torch.models import convert, map_state as tms, tracker as ttr
from vslam_torch.utils import trajectory as ttraj
from vslam_tpu.models import map_state as jms, tracker as jtr
from vslam_tpu.utils import synthetic, trajectory

torch.set_num_threads(2)  # xdist runs several workers on one box

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
WORLD = dict(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
N_FRAMES = 12


@pytest.fixture(scope="module")
def scene():
    s = synthetic.make_scene(n_frames=N_FRAMES, n_points=400, width=320, height=240, fps=10.0, seed=7)
    s.frames = [(s.render(f), s.render(f, right=True)) for f in range(N_FRAMES)]
    return s


def _jax_tracker(scene):
    world = jms.WorldMap(**WORLD)
    trk = jtr.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height, world,
        jtr.TrackerParams(**PARAMS),
    )
    return trk


def _torch_tracker(scene, device="cpu"):
    world = tms.WorldMap(**WORLD, device=device)
    return ttr.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height, world,
        ttr.TrackerParams(**PARAMS), device=device,
    )


def _np_map(m) -> dict:
    return {f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}


def test_track_step_from_converted_state(scene):
    """JAX initialises the map on frame 0; the map and tracker state cross
    over through convert.py; one tracked frame then agrees. Matches and
    inlier masks are exact; the pose within 1e-5."""
    jt = _jax_tracker(scene)
    jt.track(*scene.frames[0])
    tt = _torch_tracker(scene)

    tt.world.arrays = convert.map_arrays_from_jax(_np_map(jt.world.arrays), "cpu")
    state_np = jax.tree.map(np.asarray, jt._state)
    host_np = {
        "active_ids": jt.active_ids, "miss_age": jt.miss_age,
        "frame_records": jt.frame_records, "new_kf_slots": jt.new_kf_slots,
    }
    state_t, host_t = convert.tracker_state_from_jax(state_np, host_np, "cpu")
    assert host_t["new_kf_slots"] == [0] and len(host_t["frame_records"]) == 1
    np.testing.assert_array_equal(host_t["active_ids"], jt.active_ids)
    # the converted map is the map the port builds itself from frame 0
    tt.track(*scene.frames[0])
    own = tt.world.arrays
    conv = convert.map_arrays_from_jax(_np_map(jt.world.arrays), "cpu")
    for name in ("lm_valid", "obs_lm", "obs_valid", "obs_oct", "obs_stereo", "kf_valid"):
        assert torch.equal(getattr(own, name), getattr(conv, name)), name
    np.testing.assert_allclose(own.lm_pos.numpy(), conv.lm_pos.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tt.active_ids, jt.active_ids)

    LR = np.stack(scene.frames[1])
    p = jt.params
    _, jo = jtr._track_step(
        jnp.asarray(LR), jt._state, jt._imu_dummy, jt._imu_const, jt._radii_first,
        jnp.float32(p.refine_radius), jnp.float32(jt._desc_thr), jnp.float32(jt._ratio),
        jt.K, jt.baseline, jt.scale_factors, jt._static, jt.width, jt.height,
        p.n_levels, p.min_inliers,
    )
    _, to = ttr._track_step(
        torch.from_numpy(LR), state_t, tt._radii_first, tt.params.refine_radius,
        tt._desc_thr, tt._ratio, tt.K, tt.baseline, tt.scale_factors, tt.params,
        tt.width, tt.height,
    )
    jb, tb = np.asarray(jo["blob"]), to["blob"].numpy()
    np.testing.assert_allclose(tb[:16], jb[:16], atol=1e-5, rtol=0)  # pose
    np.testing.assert_array_equal(tb[25:29], jb[25:29])  # match/inlier/key counts
    # stereo-matched key count: XLA fuses the JAX frame program, and inside
    # it match_stereo matches 212 keys on this frame where the JAX
    # package's own standalone match_stereo on the same keys matches 210,
    # as the port does (tests/test_torch_matching.py holds match_stereo
    # exact); 1% covers the fused program's rounding
    assert abs(tb[29] - jb[29]) <= 0.01 * jb[29], (tb[29], jb[29])
    np.testing.assert_array_equal(tb[33:], jb[33:])  # lost flag, miss ages
    assert jb[26] >= 50  # a real solve, not a refusal
    for name in ("midx", "inliers", "midx_r", "st_flags", "in_frame"):
        np.testing.assert_array_equal(to[name].numpy(), np.asarray(jo[name]), err_msg=name)


@pytest.fixture(scope="module")
def both_runs(scene):
    runs = {}
    for name, trk in (("jax", _jax_tracker(scene)), ("torch", _torch_tracker(scene))):
        for left, right in scene.frames:
            trk.track(left, right)
        runs[name] = (trk, trk.trajectory())
    return runs


def test_slice_matches_jax_trajectory_and_keyframes(scene, both_runs):
    """The slice end to end (StereoTracker.track without a mapper): the
    same keyframes at the same frames, per-frame poses within 1e-3, and
    both ATEs under tests/test_tracking.py's 0.03 m gate."""
    (jt, jp), (tt, tp) = both_runs["jax"], both_runs["torch"]
    assert tt.new_kf_slots == jt.new_kf_slots and len(jt.new_kf_slots) >= 2
    n_kf = jt.world.n_keyframes
    assert tt.world.n_keyframes == n_kf
    np.testing.assert_array_equal(tt.world.kf_frame_idx[:n_kf], jt.world.kf_frame_idx[:n_kf])
    assert [s for s, _ in tt.frame_records] == [s for s, _ in jt.frame_records]
    assert tp.shape == jp.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=0)
    gt = scene.poses_c2w[:N_FRAMES]
    ate_j = trajectory.ate_rmse(jp, gt, align=False)
    ate_t = ttraj.ate_rmse(tp, gt, align=False)
    assert ate_j < 0.03 and ate_t < 0.03, (ate_j, ate_t)
    assert abs(tt.world.n_landmarks - jt.world.n_landmarks) <= 0.02 * jt.world.n_landmarks


def test_map_growth_mid_run_keeps_the_trajectory(scene, both_runs):
    """A map that starts too small grows its landmark and keyframe axes
    while tracking (new device tensors mid-run); the run is the same as
    with room to spare."""
    world = tms.WorldMap(lm_capacity=300, kf_capacity=2, keys_per_kf=512, device="cpu")
    trk = ttr.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height, world,
        ttr.TrackerParams(**PARAMS), device="cpu",
    )
    for left, right in scene.frames:
        trk.track(left, right)
    poses = trk.trajectory()
    ref, ref_poses = both_runs["torch"]
    assert world.lm_capacity > 300 and world.kf_capacity > 2
    assert trk.new_kf_slots == ref.new_kf_slots
    assert world.n_landmarks == ref.world.n_landmarks
    np.testing.assert_array_equal(poses, ref_poses)


def test_reanchor_and_add_active_match_jax(scene):
    """The hooks a mapper drives: a re-anchoring delta applied while frames
    are in the pipeline (their blobs are corrected at process time) and
    landmarks merged into the active set. Both trackers then go on
    tracking; host state and poses agree."""
    trackers = [_jax_tracker(scene), _torch_tracker(scene)]
    delta = np.eye(4, dtype=np.float32)
    delta[:3, 3] = [0.01, -0.02, 0.005]
    for trk in trackers:
        for left, right in scene.frames[:5]:
            trk.track(left, right)
        old = trk.world.kf_poses_host[1].copy()
        trk.reanchor(1, old, delta @ old)
        extra = np.arange(trk.world.n_landmarks - 3, trk.world.n_landmarks)
        trk.add_active(extra)
    jt, tt = trackers
    np.testing.assert_array_equal(tt.active_ids, jt.active_ids)
    np.testing.assert_array_equal(tt.miss_age, jt.miss_age)
    np.testing.assert_allclose(tt._D, jt._D, atol=1e-7)
    np.testing.assert_allclose(tt.pose, jt.pose, atol=1e-4)
    for trk in trackers:
        for left, right in scene.frames[5:8]:
            trk.track(left, right)
    jp, tp = jt.trajectory(), tt.trajectory()
    assert tt.new_kf_slots == jt.new_kf_slots
    np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=0)


def test_world_map_allocator_matches_jax():
    jw = jms.WorldMap(lm_capacity=64, kf_capacity=2, keys_per_kf=8, right_obs_per_kf=4)
    tw = tms.WorldMap(lm_capacity=64, kf_capacity=2, keys_per_kf=8, right_obs_per_kf=4, device="cpu")
    for count in (20, 30, 40, 5):
        np.testing.assert_array_equal(tw.alloc_landmarks(count), jw.alloc_landmarks(count))
        assert tw.lm_capacity == jw.lm_capacity
    tw.release_landmarks(np.arange(90, 95))
    jw.release_landmarks(np.arange(90, 95))
    assert tw.n_landmarks == jw.n_landmarks
    for f in range(3):
        assert tw.alloc_keyframe(f) == jw.alloc_keyframe(f)
    assert tw.kf_capacity == jw.kf_capacity == 4
    assert tw.arrays.obs_lm.shape == (4, 8) and tw.arrays.lm_pos.shape == (128, 3)
    tw.kf_obs_lm[:3] = jw.kf_obs_lm[:3] = np.array([[1, 2, 3] + [-1] * 5] * 3)
    np.testing.assert_array_equal(tw.covisible_kfs(0, min_weight=2), jw.covisible_kfs(0, min_weight=2))


def test_unported_paths_raise(scene):
    """A StereoTracker given no right image (with and without IMU rows, on
    a stereo-inertial tracker too) is refused and points to MonoTracker,
    which takes the same single image; relocalization on an empty map
    finds nothing (the caller then re-seeds); the debug hook fires once
    per processed frame with its stats; a tracker on another device than
    its map is refused."""
    imu_cfg = ttr.ImuConfig(
        gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3, hz=200.0,
        T_bc=np.eye(4, dtype=np.float32), gravity_w=np.array([0.0, 0.0, -9.81], np.float32),
    )
    ti = ttr.StereoTracker(
        scene.K, scene.baseline, 320, 240, tms.WorldMap(**WORLD, device="cpu"),
        ttr.TrackerParams(**PARAMS), imu_cfg=imu_cfg, device="cpu",
    )
    with pytest.raises(ValueError, match="MonoTracker"):
        ti.track(scene.frames[0][0], imu=np.zeros((3, 7), np.float32))
    tt = _torch_tracker(scene)
    with pytest.raises(ValueError, match="MonoTracker"):
        tt.track(scene.frames[0][0], imu=np.zeros((3, 7), np.float32))
    with pytest.raises(ValueError, match="MonoTracker"):
        tt.track(scene.frames[0][0])
    assert tt._relocalize(5, {}) is False and tt.counters.get("relocalizations") == 0
    tm = ttr.MonoTracker(scene.K, 320, 240, tms.WorldMap(**WORLD, device="cpu"),
                         ttr.TrackerParams(**PARAMS), imu_cfg=imu_cfg, device="cpu")
    tm.track(scene.frames[0][0])
    assert tm.bootstrap_slots == tm.gate_slots == [0] and tm.world.n_keyframes == 1
    with pytest.raises(ValueError, match="one image"):
        tm.track(np.stack(scene.frames[1]))
    fired = []
    th = _torch_tracker(scene)
    th.debug_hook = lambda frame_idx, pose, outputs, stats: fired.append((frame_idx, stats))
    for f in range(2):
        th.track(*scene.frames[f])
    th.flush()
    assert [f for f, _ in fired] == [1] and fired[0][1] is th.last_stats
    assert fired[0][1]["n_inliers"] >= 50
    with pytest.raises(ValueError, match="device"):
        ttr.StereoTracker(
            scene.K, scene.baseline, 320, 240, tms.WorldMap(**WORLD, device="cpu"),
            device="meta",
        )


def test_port_never_imports_jax():
    """``import vslam_torch`` plus a 2-frame CPU track, a 2-frame batch of
    two sequences and the multi-device dry run's problem and split
    frontend, in a fresh interpreter where importing jax fails loudly."""
    code = textwrap.dedent(
        """
        import importlib.abc, sys
        for m in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
            del sys.modules[m]

        class _NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("vslam_torch must not import " + name)

        sys.meta_path.insert(0, _NoJax())
        import numpy as np, torch
        torch.set_num_threads(1)
        import vslam_torch
        from vslam_torch.models import map_state, tracker
        from vslam_torch.utils import synthetic

        s = synthetic.make_scene(n_frames=2, n_points=200, width=160, height=120, fps=10.0, seed=3)
        p = tracker.TrackerParams(n_features=128, n_levels=2, active_size=256)
        w = map_state.WorldMap(lm_capacity=1024, kf_capacity=8, keys_per_kf=128, device="cpu")
        t = tracker.StereoTracker(s.K, s.baseline, 160, 120, w, p, device="cpu")
        for f in range(2):
            t.track(s.render(f), s.render(f, right=True))
        assert t.trajectory().shape == (2, 4, 4)
        assert w.n_landmarks > 0
        # the parallel layer: two sequences through the batched frontend,
        # and a BA over two virtual shards
        from vslam_torch import bench_tracker, run_batch  # noqa: F401
        from vslam_torch.ops import schur
        from vslam_torch.parallel import mesh, multi_seq, sharded_ba
        ts = [tracker.StereoTracker(s.K, s.baseline, 160, 120,
                                    map_state.WorldMap(lm_capacity=1024, kf_capacity=8, keys_per_kf=128,
                                                       device="cpu"), p, device="cpu") for _ in range(2)]
        front = multi_seq.BatchedStereoFrontend(ts)
        for f in range(2):
            front.track([(s.render(f), s.render(f, right=True))] * 2)
        front.flush()
        assert all(x.trajectory().shape == (2, 4, 4) for x in ts)
        assert sharded_ba.sharded_two_rounds(mesh.make_mesh(2, device="cpu")) is not None
        # the multi-device dry run: its problem and its split frontend
        from vslam_torch import dryrun
        assert dryrun.dryrun_problem(2, "cpu").obs_kf.shape == (24576,)
        assert np.isfinite(dryrun.dryrun_frontend(["cpu"] * 2)["poses"]).all()
        assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
        print("NO_JAX_OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]
