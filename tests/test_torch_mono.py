"""The port's monocular-inertial path against vslam_tpu on the CPU:
MonoTracker's IMU bootstrap and tracking on tests/test_tracking.py's scenes
(320x240, 512 features, 4 levels; the 10 fps scene and the slow 40 fps one
whose bootstrap records intermediate views), the mono triangulation on maps
converted from the JAX run (``vslam_torch.models.convert``), including the
fallback to the preceding keyframes when the newest has no covisibility,
and VSlamSystem in slamMode 2 on tests/test_system.py's lateral scene,
shortened."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vslam_torch.models import convert, local_mapper as tlm, map_state as tms, system as tsys
from vslam_torch.models import tracker as ttr
from vslam_torch.utils import trajectory as ttraj
from vslam_torch.utils.config import ConfigFile as TConfig
from vslam_tpu.models import local_mapper as jlm, map_state as jms, system as jsys
from vslam_tpu.models import tracker as jtr
from vslam_tpu.utils import datasets, synthetic, trajectory as jtraj
from vslam_tpu.utils.config import ConfigFile as JConfig

torch.set_num_threads(2)  # xdist runs several workers on one box

W, H, FX = 320, 240, 460.0
K = np.array([[FX, 0, W / 2.0], [0, FX, H / 2.0], [0, 0, 1]], np.float32)
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
WORLD = dict(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
N_FRAMES = 12
BOOT_TOL = 1e-5  # bootstrap poses: IMU dead reckoning, the same f32 ops
TRACK_TOL = 1e-3  # tracked poses (test_torch_tracker.py's slice tolerance)


def _imu_cfg(mod):
    return mod.ImuConfig(
        gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3, hz=200.0,
        T_bc=np.eye(4, dtype=np.float32), gravity_w=synthetic.GRAVITY_W.astype(np.float32),
    )


def _dt_rows(scene):
    """Per-frame [dt, gyro, accel] rows (tests/test_tracking.py:156-167)."""
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    out, prev_t = [], None
    for rows in bins:
        if not len(rows):
            out.append(None)
            continue
        t = rows[:, 0]
        p0 = prev_t if prev_t is not None else t[0] - 1.0 / scene.imu_hz
        prev_t = float(t[-1])
        dts = np.diff(np.concatenate([[p0], t]))
        out.append(np.concatenate([dts[:, None], rows[:, 1:7]], axis=1).astype(np.float32))
    return out


def _snapshot(world) -> dict:
    return {
        "arrays": {f.name: np.asarray(getattr(world.arrays, f.name))
                   for f in dataclasses.fields(world.arrays)},
        **{k: getattr(world, k).copy() for k in ("kf_obs_lm", "kf_obs_r_lm", "kf_frame_idx", "kf_poses_host")},
        **{k: getattr(world, k) for k in ("n_landmarks", "n_keyframes", "lm_capacity", "kf_capacity")},
    }


def _restore(snap: dict, port: bool):
    kw = dict(lm_capacity=snap["lm_capacity"], kf_capacity=snap["kf_capacity"], keys_per_kf=512)
    if port:
        w = tms.WorldMap(**kw, device="cpu")
        w.arrays = convert.map_arrays_from_jax(snap["arrays"], "cpu")
    else:
        w = jms.WorldMap(**kw)
        w.arrays = jms.MapArrays(**{k: jnp.asarray(v) for k, v in snap["arrays"].items()})
    for k in ("kf_obs_lm", "kf_obs_r_lm", "kf_frame_idx", "kf_poses_host"):
        setattr(w, k, snap[k].copy())
    w.n_landmarks, w.n_keyframes = snap["n_landmarks"], snap["n_keyframes"]
    return w


def _run(port: bool, scene, n, bootstrap_only=False):
    """MonoTracker + the mapper's mono triangulation (the init handoff,
    then one pass per keyframe, as the facade does). The world is
    snapshotted before the init triangulation."""
    if port:
        world = tms.WorldMap(**WORLD, device="cpu")
        trk = ttr.MonoTracker(K, W, H, world, ttr.TrackerParams(**PARAMS), imu_cfg=_imu_cfg(ttr),
                              device="cpu")
        mapper = tlm.LocalMapper(world, K, 0.0, tlm.LocalMapperConfig(n_levels=4))
    else:
        world = jms.WorldMap(**WORLD)
        trk = jtr.MonoTracker(K, W, H, world, jtr.TrackerParams(**PARAMS), imu_cfg=_imu_cfg(jtr))
        mapper = jlm.LocalMapper(world, K, 0.0, jlm.LocalMapperConfig(n_levels=4))
    trk.velocity = scene.velocities[0].astype(np.float32)
    out = {"poses": [], "init_ids": None}
    for f, rows in enumerate(_dt_rows(scene)[:n]):
        nk = len(trk.new_kf_slots)
        out["poses"].append(trk.track(scene.frames[f], imu=rows))
        if trk.needs_init_triangulation:
            out["snap"] = _snapshot(world)
            out["init_frame"] = f
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            out["init_ids"] = ids
            trk.add_active(ids)
            trk.needs_init_triangulation = False
            trk.last_kf_tracked = max(len(ids), 1)
            if bootstrap_only:
                break
        elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
            trk.add_active(mapper.find_new_points(trk.new_kf_slots[-1], mono=True))
    out["trk"], out["world"] = trk, world
    out["traj"] = trk.trajectory()
    return out


def _scene(n, fps, **kw):
    s = synthetic.make_scene(n_frames=n, n_points=400, width=W, height=H, fps=fps, seed=7, **kw)
    s.frames = [s.render(f) for f in range(n)]
    return s


@pytest.fixture(scope="module")
def runs():
    scene = _scene(N_FRAMES, 10.0)
    return {"scene": scene, "jax": _run(False, scene, N_FRAMES), "torch": _run(True, scene, N_FRAMES)}


def test_mono_bootstrap_and_tracking_match_jax(runs):
    """The 10 fps scene (every frame passes the motion gate): identical
    bootstrap_slots, gate_slots and keyframes; the poses through the
    bootstrap within 1e-5, every tracked pose within 1e-3; the same init
    landmark ids; both ATEs under tests/test_tracking.py's 0.15 m."""
    j, t = runs["jax"], runs["torch"]
    jt, tt = j["trk"], t["trk"]
    assert tt.initialized and jt.initialized
    assert tt.bootstrap_slots == jt.bootstrap_slots and tt.gate_slots == jt.gate_slots
    assert len(tt.gate_slots) == tt.BOOTSTRAP_KFS and len(tt.bootstrap_slots) >= tt.MIN_BOOTSTRAP_VIEWS
    assert t["init_frame"] == j["init_frame"]
    np.testing.assert_array_equal(t["init_ids"], j["init_ids"])
    assert len(t["init_ids"]) > 20
    boot = t["init_frame"] + 1
    np.testing.assert_allclose(np.stack(t["poses"][:boot]), np.stack(j["poses"][:boot]), atol=BOOT_TOL, rtol=0)
    assert tt.new_kf_slots == jt.new_kf_slots
    n_kf = jt.world.n_keyframes
    np.testing.assert_array_equal(tt.world.kf_frame_idx[:n_kf], jt.world.kf_frame_idx[:n_kf])
    assert t["traj"].shape == j["traj"].shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(t["traj"], j["traj"], atol=TRACK_TOL, rtol=0)
    gt = runs["scene"].poses_c2w[:N_FRAMES]
    ate_j = jtraj.ate_rmse(j["traj"], gt, align=False)
    ate_t = ttraj.ate_rmse(t["traj"], gt, align=False)
    assert ate_j < 0.15 and ate_t < 0.15, (ate_j, ate_t)
    for k in ("n_matched", "n_inliers", "n_keys", "lost"):
        assert tt.last_stats[k] == jt.last_stats[k], (k, tt.last_stats, jt.last_stats)
    assert tt.counters.get("keyframes") == len(tt.new_kf_slots)


def _tri_window(snap):
    """_dispatch_triangulation's window for the snapshot's newest KF: its
    keyframes share no landmark yet, so the preceding keyframes stand in."""
    kf = snap["n_keyframes"] - 1
    w = _restore(snap, port=True)
    assert len(w.covisible_kfs(kf, 10, 15)) == 0
    older = np.arange(max(0, kf - (tlm.WINDOW - 1)), kf)
    pad = tlm.WINDOW - 1 - len(older)
    slots = np.concatenate([np.zeros(pad, np.int64), older, [kf]])
    valid = np.concatenate([np.zeros(pad, bool), np.ones(len(older) + 1, bool)])
    spawn = np.arange(snap["n_landmarks"], snap["n_landmarks"] + tlm.SPAWN_TRI)
    return kf, slots, valid, spawn


def test_triangulate_new_points_mono_matches_jax(runs):
    """On the converted map of the init triangulation: identical
    slot_of_cand, key_views, spawn_valid and n_new; positions within 1e-4
    m + 2e-5 of the coordinate (test_torch_mapper.py's triangulation
    tolerance: the DLT starts differ by eigh's rounding, the polish ends at
    f32 noise along the ray)."""
    snap = runs["jax"]["snap"]
    kf, slots, valid, spawn = _tri_window(snap)
    jw = _restore(snap, port=False)
    rj = jlm._triangulate_new_points_mono(
        jw.arrays, jnp.asarray(slots, jnp.int32), jnp.asarray(valid), jnp.asarray(spawn, jnp.int32),
        jnp.ones(jlm.SPAWN_TRI, bool), jnp.asarray(K), jnp.float32(120.0), jnp.float32(3.0),
        n_levels=4, scale=1.2,
    )
    tw = _restore(snap, port=True)
    rt = tlm._triangulate_new_points_mono(
        tw.arrays, torch.from_numpy(slots), torch.from_numpy(valid), torch.from_numpy(spawn),
        torch.ones(tlm.SPAWN_TRI, dtype=torch.bool), torch.from_numpy(K), 120.0, 3.0,
        n_levels=4, scale=1.2,
    )
    for name in ("slot_of_cand", "key_views", "spawn_valid"):
        np.testing.assert_array_equal(rt[name].numpy(), np.asarray(rj[name]), err_msg=name)
    ok = rt["spawn_valid"].numpy()
    assert int(rt["n_new"]) == int(rj["n_new"]) == ok.sum() > 20
    assert (rt["key_views"].numpy()[~valid[:-1]] < 0).all()  # padded views match nothing
    np.testing.assert_allclose(rt["spawn_pos"].numpy()[ok], np.asarray(rj["spawn_pos"])[ok], atol=1e-4, rtol=2e-5)
    np.testing.assert_array_equal(rt["spawn_desc"].numpy()[ok], np.asarray(rj["spawn_desc"])[ok])


@pytest.fixture(scope="module")
def slow_runs():
    """The slow scene's bootstrap (40 fps: each 0.1 m gate takes ~3-4
    frames, so the frames between gates become views)."""
    scene = _scene(16, 40.0)
    return {"jax": _run(False, scene, 16, bootstrap_only=True),
            "torch": _run(True, scene, 16, bootstrap_only=True)}


def test_slow_bootstrap_records_intermediate_views_as_jax(slow_runs):
    """Identical bootstrap_slots (more than the 3 gates, at most the
    window) and gate_slots; poses within 1e-5."""
    j, t = slow_runs["jax"], slow_runs["torch"]
    jt, tt = j["trk"], t["trk"]
    assert tt.initialized and tt.bootstrap_slots == jt.bootstrap_slots
    assert tt.gate_slots == jt.gate_slots and len(tt.gate_slots) == 3
    assert 3 < len(tt.bootstrap_slots) <= tt.MAX_BOOTSTRAP_VIEWS
    np.testing.assert_allclose(np.stack(t["poses"]), np.stack(j["poses"]), atol=BOOT_TOL, rtol=0)
    np.testing.assert_allclose(tt.trajectory(), jt.trajectory(), atol=BOOT_TOL, rtol=0)


@pytest.mark.parametrize("which", ["fast", "slow"])
def test_find_new_points_mono_on_converted_map_matches_jax(runs, slow_runs, which):
    """find_new_points(mono=True) through both mappers on the converted
    map of each init triangulation (the no-covisibility fallback to the
    preceding keyframes): the same new landmark ids and host observation
    tables, identical device obs_lm / lm_valid / lm_nobs / lm_desc,
    positions within the triangulation tolerance."""
    snap = (runs if which == "fast" else slow_runs)["jax"]["snap"]
    kf = snap["n_keyframes"] - 1
    jw, tw = _restore(snap, port=False), _restore(snap, port=True)
    jm = jlm.LocalMapper(jw, K, 0.0, jlm.LocalMapperConfig(n_levels=4))
    tm = tlm.LocalMapper(tw, K, 0.0, tlm.LocalMapperConfig(n_levels=4))
    ij, it = jm.find_new_points(kf, mono=True), tm.find_new_points(kf, mono=True)
    np.testing.assert_array_equal(it, ij)
    assert len(it) > 20
    np.testing.assert_array_equal(tw.kf_obs_lm, jw.kf_obs_lm)
    assert tw.n_landmarks == jw.n_landmarks
    mj = {f.name: np.asarray(getattr(jw.arrays, f.name)) for f in dataclasses.fields(jw.arrays)}
    for name in ("obs_lm", "lm_valid", "lm_nobs", "lm_desc", "lm_bitsum"):
        np.testing.assert_array_equal(getattr(tw.arrays, name).numpy()[:-1], mj[name][:-1], err_msg=name)
    np.testing.assert_allclose(tw.arrays.lm_pos.numpy()[it], mj["lm_pos"][ij], atol=1e-4, rtol=2e-5)


def _mono_config() -> dict:
    cam = {"fx": FX, "fy": FX, "cx": W / 2.0, "cy": H / 2.0}
    return {
        "rectified": True, "slamMode": 2, "dataset": "KITTI",
        "imagesPath": "/nonexistent", "fileExtension": ".png",
        "Camera": {"width": W, "height": H, "fps": 10.0, "bl": 0.12},
        "Camera_l": dict(cam), "Camera_r": dict(cam),
        "FE": {"nFeatures": 1024, "nLevels": 4, "imScale": 1.2, "edgeThreshold": 19,
               "maxFastThreshold": 20, "minFastThreshold": 7},
        "IMU": {"Hz": 200, "gyroscope_noise_density": 1.7e-4,
                "accelerometer_noise_density": 2.0e-3, "gyroscope_random_walk": 1.9e-5,
                "accelerometer_random_walk": 3.0e-3, "gravity": [0.0, 0.0, -9.81]},
    }


def test_mono_facade_matches_jax(tmp_path):
    """VSlamSystem in slamMode 2 through track_mono_imu on
    tests/test_system.py's lateral, distinct-texture scene (1024 features,
    as there), 14 of its 30 frames: a MonoTracker with the 1200 px schedule
    and relaxed thresholds, the init handoff, triangulation at every
    keyframe; identical keyframe slots and landmark counts, poses within
    1e-3 m / 1e-3 rad, both ATEs under test_system.py's 0.05 m."""
    n = 14
    scene = synthetic.make_scene(n_frames=n, n_points=500, width=W, height=H, fps=10.0, seed=7,
                                 texture="distinct", motion="lateral")
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    params = dict(n_features=1024, n_levels=4, active_size=2048, spawn_per_kf=256, kf_min_stereo=60)
    path = tmp_path / "mono.yaml"
    path.write_text(yaml.safe_dump(_mono_config()))
    js = jsys.VSlamSystem(JConfig(str(path)), lm_capacity=8192, kf_capacity=64,
                          tracker_params=jtr.TrackerParams(**params))
    ts = tsys.VSlamSystem(TConfig.from_dict(_mono_config()), lm_capacity=8192, kf_capacity=64,
                          tracker_params=ttr.TrackerParams(**params), device="cpu")
    assert isinstance(ts.tracker, ttr.MonoTracker)
    assert ts.tracker._radii[-1] == 1200.0 and ts.tracker._desc_thr == 150.0
    assert abs(ts.tracker._ratio - 0.9) < 1e-6
    for sys_ in (js, ts):
        sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
        for f in range(n):
            sys_.track_mono_imu(scene.render(f), imu=bins[f])
        sys_.exit()
    assert ts.tracker.initialized and not ts.tracker.needs_init_triangulation
    assert ts.tracker.new_kf_slots == js.tracker.new_kf_slots
    assert ts.tracker.bootstrap_slots == js.tracker.bootstrap_slots
    assert ts.world.n_landmarks == js.world.n_landmarks > 100
    assert ts.mapper.ba_count == js.mapper.ba_count == 0  # no mono window BA
    jp, tp = js.trajectory(), ts.trajectory()
    assert tp.shape == jp.shape == (n, 4, 4)
    dt = np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1)
    R = np.einsum("fji,fjk->fik", tp[:, :3, :3].astype(np.float64), jp[:, :3, :3])
    ang = np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert dt.max() < 1e-3 and ang.max() < 1e-3, (dt.max(), ang.max())
    gt = scene.poses_c2w[:n]
    assert jtraj.ate_rmse(jp, gt, align=False) < 0.05 and ttraj.ate_rmse(tp, gt, align=False) < 0.05


def test_converted_mono_tracker_state():
    """convert.tracker_state_from_jax carries a mono tracker's host state
    (initialized, bootstrap and gate slots, the init flag) and a missing
    device state."""
    host = {"active_ids": np.full(4, -1), "miss_age": np.zeros(4), "frame_records": [],
            "new_kf_slots": [0, 1], "initialized": False, "bootstrap_slots": [0, 1],
            "gate_slots": [0], "needs_init_triangulation": False}
    state, h = convert.tracker_state_from_jax(None, host, "cpu")
    assert state is None and h["bootstrap_slots"] == [0, 1] and h["gate_slots"] == [0]
    assert h["initialized"] is False and h["needs_init_triangulation"] is False
