"""The port's local mapper and stereo VSlamSystem facade against
vslam_tpu on the CPU, on tests/test_system.py's scene (320x240, 512
features, 4 levels, 12 frames, seed 7): one JAX system run (the world is
snapshotted before each local-BA run), the port's system on the same
frames, and the mapper's pieces on maps converted from the JAX snapshots
(``vslam_torch.models.convert``). Also: the paths once not ported (the
mesh, shards) run, and the camera and trajectory helpers match the JAX ones."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from vslam_torch.geometry import camera as tcam
from vslam_torch.models import (
    convert, local_mapper as tlm, map_state as tms, system as tsys, tracker as ttr,
)
from vslam_torch.ops import schur as tsch
from vslam_torch.utils import trajectory as ttraj
from vslam_torch.utils.config import ConfigFile as TConfig
from vslam_tpu.geometry import camera as jcam
from vslam_tpu.models import local_mapper as jlm, map_state as jms, system as jsys, tracker as jtr
from vslam_tpu.utils import synthetic, trajectory as jtraj
from vslam_tpu.utils.config import ConfigFile as JConfig

torch.set_num_threads(2)  # xdist runs several workers on one box

W, H = 320, 240
FX, BL = 460.0, 0.12
N_FRAMES = 12
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
CAPS = dict(lm_capacity=8192, kf_capacity=64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(rectified: bool = True) -> dict:
    """tests/test_system.py's config (reference YAML schema) as a dict;
    unrectified adds identity D/K/R/P blocks (a pass-through remap)."""
    cam = {"fx": FX, "fy": FX, "cx": W / 2.0, "cy": H / 2.0}
    if not rectified:
        k = [FX, 0.0, W / 2.0, 0.0, FX, H / 2.0, 0.0, 0.0, 1.0]
        cam |= {
            "D": {"rows": 1, "cols": 5, "data": [0.0] * 5},
            "K": {"rows": 3, "cols": 3, "data": k},
            "R": {"rows": 3, "cols": 3, "data": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]},
            "P": {"rows": 3, "cols": 4, "data": k[:3] + [0.0] + k[3:6] + [0.0] + k[6:] + [0.0]},
        }
    return {
        "rectified": rectified, "slamMode": 1, "dataset": "KITTI",
        "imagesPath": "/nonexistent", "fileExtension": ".png",
        "Camera": {"width": W, "height": H, "fps": 10.0, "bl": BL},
        "Camera_l": dict(cam), "Camera_r": dict(cam),
        "FE": {"nFeatures": 512, "nLevels": 4, "imScale": 1.2, "edgeThreshold": 19,
               "maxFastThreshold": 20, "minFastThreshold": 7},
    }


def _jax_config(tmp_path_factory, rectified=True) -> JConfig:
    path = tmp_path_factory.mktemp("cfg") / "config.yaml"
    path.write_text(yaml.safe_dump(_config(rectified)))
    return JConfig(str(path))


@pytest.fixture(scope="module")
def scene():
    s = synthetic.make_scene(n_frames=N_FRAMES, n_points=400, width=W, height=H, fps=10.0, seed=7)
    s.frames = [(s.render(f), s.render(f, right=True)) for f in range(N_FRAMES)]
    return s


def _snapshot(world) -> dict:
    return {
        "arrays": {f.name: np.asarray(getattr(world.arrays, f.name)) for f in dataclasses.fields(world.arrays)},
        **{k: getattr(world, k).copy() for k in ("kf_obs_lm", "kf_obs_r_lm", "kf_frame_idx", "kf_poses_host")},
        **{k: getattr(world, k) for k in ("n_landmarks", "n_keyframes", "lm_capacity", "kf_capacity")},
    }


def _restore(snap: dict, port: bool):
    """A WorldMap of either package holding the snapshot."""
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


def _mappers(snap):
    cfg = dict(n_levels=4, scale=1.2)
    K = np.array([[FX, 0, W / 2.0], [0, FX, H / 2.0], [0, 0, 1]], np.float32)
    jw, tw = _restore(snap, port=False), _restore(snap, port=True)
    return (
        jlm.LocalMapper(jw, K, BL, jlm.LocalMapperConfig(**cfg)),
        tlm.LocalMapper(tw, K, BL, tlm.LocalMapperConfig(**cfg)),
    )


def _np_map(m) -> dict:
    return {f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """One sync VSlamSystem run per package on the 12 frames; the JAX
    world is snapshotted before each local-BA run."""
    js = jsys.VSlamSystem(
        _jax_config(tmp_path_factory), **CAPS, tracker_params=jtr.TrackerParams(**PARAMS)
    )
    snaps = []
    run = js.mapper.run

    def recording_run(kf_slot, mono=False):
        snaps.append({"kf_slot": kf_slot, **_snapshot(js.world)})
        r = run(kf_slot, mono=mono)
        snaps[-1]["result"] = r
        return r

    js.mapper.run = recording_run
    ts = tsys.VSlamSystem(
        TConfig.from_dict(_config()), **CAPS, tracker_params=ttr.TrackerParams(**PARAMS),
        device="cpu",
    )
    for sys_ in (js, ts):
        for left, right in scene.frames:
            sys_.track_stereo(left, right)
        sys_.exit()
    return {"jax": js, "torch": ts, "jp": js.trajectory(), "tp": ts.trajectory(), "snaps": snaps}


def test_system_matches_jax(scene, runs):
    """The slice end to end: the same keyframes at the same frames, the
    same number of local-BA runs (>= 2), per-frame poses within 1e-3,
    landmark counts within 2%, both ATEs under test_system.py's 0.03 m."""
    js, ts, jp, tp = runs["jax"], runs["torch"], runs["jp"], runs["tp"]
    assert ts.tracker.new_kf_slots == js.tracker.new_kf_slots
    n = js.world.n_keyframes
    np.testing.assert_array_equal(ts.world.kf_frame_idx[:n], js.world.kf_frame_idx[:n])
    assert ts.mapper.ba_count == js.mapper.ba_count >= 2
    assert tp.shape == jp.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=0)
    assert abs(ts.world.n_landmarks - js.world.n_landmarks) <= 0.02 * js.world.n_landmarks
    gt = scene.poses_c2w[:N_FRAMES]
    ate_j = jtraj.ate_rmse(jp, gt, align=False)
    ate_t = ttraj.ate_rmse(tp, gt, align=False)
    assert ate_j < 0.03 and ate_t < 0.03, (ate_j, ate_t)
    stats = ts.mapper.metrics.summary()
    assert stats["run"]["count"] == ts.mapper.ba_count
    assert ts.mapper.counters.get("lm_iters_round1") >= ts.mapper.ba_count


def _tri_inputs(snap, port):
    """_dispatch_triangulation's window and spawn inputs for the snapshot's
    keyframe (host logic shared by both packages)."""
    w = _restore(snap, port)
    kf = snap["kf_slot"]
    covis = w.covisible_kfs(kf, 10, 15)
    older = np.sort(np.unique(covis[covis != kf]))[-(jlm.WINDOW - 1):]
    pad = jlm.WINDOW - 1 - len(older)
    slots = np.concatenate([np.zeros(pad, np.int64), older, [kf]])
    valid = np.concatenate([np.zeros(pad, bool), np.ones(len(older) + 1, bool)])
    spawn = np.arange(w.n_landmarks, w.n_landmarks + jlm.SPAWN_TRI)
    return w, slots, valid, spawn


def test_triangulate_new_points_matches_jax(runs):
    """On the last keyframe's converted map: identical slot_of_cand,
    key_views and spawn_valid; spawned positions within 1e-4 m + 2e-5 of
    the coordinate (the Gauss-Newton polish ends at f32 noise along the
    viewing ray, which the window's short baselines amplify: ~1e-5 of the
    range at 10-14 m; the DLT starts alone differ by up to 1e-3 m)."""
    snap = runs["snaps"][-1]
    K = np.array([[FX, 0, W / 2.0], [0, FX, H / 2.0], [0, 0, 1]], np.float32)
    jw, slots, valid, spawn = _tri_inputs(snap, port=False)
    rj = jlm._triangulate_new_points(
        jw.arrays, jnp.asarray(slots, jnp.int32), jnp.asarray(valid), jnp.asarray(spawn, jnp.int32),
        jnp.ones(jlm.SPAWN_TRI, bool), jnp.asarray(K), jnp.float32(BL), n_levels=4, scale=1.2,
    )
    tw, *_ = _tri_inputs(snap, port=True)
    rt = tlm._triangulate_new_points(
        tw.arrays, torch.from_numpy(slots), torch.from_numpy(valid), torch.from_numpy(spawn),
        torch.ones(tlm.SPAWN_TRI, dtype=torch.bool), torch.from_numpy(K), torch.tensor(BL),
        n_levels=4, scale=1.2,
    )
    for name in ("slot_of_cand", "key_views", "spawn_valid"):
        np.testing.assert_array_equal(rt[name].numpy(), np.asarray(rj[name]), err_msg=name)
    ok = rt["spawn_valid"].numpy()
    assert ok.sum() >= 5 and int(rt["n_new"]) == int(rj["n_new"])
    np.testing.assert_allclose(rt["spawn_pos"].numpy()[ok], np.asarray(rj["spawn_pos"])[ok], atol=1e-4, rtol=2e-5)
    np.testing.assert_array_equal(rt["spawn_desc"].numpy()[ok], np.asarray(rj["spawn_desc"])[ok])


def test_dispatch_and_assemble_match_jax(runs):
    """The run order of the mapper on a converted map: triangulation
    scattered into the map (_apply_triangulation included), then the
    window assembly with the speculative spawn slots. The maps agree
    (integer tables exact); assembled from the same map, the problems have
    identical integer fields, take and n_live, and floats within 1e-6."""
    snap = runs["snaps"][-1]
    jm, tm = _mappers(snap)
    pj = jm._dispatch_triangulation(snap["kf_slot"])
    pt = tm._dispatch_triangulation(snap["kf_slot"])
    mj, mt = _np_map(jm.world.arrays), tm.world.arrays
    for name in ("obs_lm", "obs_r_lm"):
        np.testing.assert_array_equal(getattr(mt, name).numpy(), mj[name], err_msg=name)
    # the dump slot P-1 takes the unused spawn rows in both packages, in
    # an unspecified order
    for name in ("lm_valid", "lm_bitsum", "lm_nobs", "lm_desc"):
        np.testing.assert_array_equal(getattr(mt, name).numpy()[:-1], mj[name][:-1], err_msg=name)
    # spawned positions: the tolerance of test_triangulate_new_points_matches_jax
    np.testing.assert_allclose(mt.lm_pos.numpy()[:-1], mj["lm_pos"][:-1], atol=1e-4, rtol=2e-5)
    # the assembly on the same map: the JAX map after its triangulation
    tm.world.arrays = convert.map_arrays_from_jax(mj, "cpu")
    aj = jm._assemble(snap["kf_slot"], extra_ids=pj["spawn"])
    at = tm._assemble(snap["kf_slot"], extra_ids=pt["spawn"])
    for a, b in zip(at[1:3], aj[1:3]):  # kf_slots, kf_valid (host)
        np.testing.assert_array_equal(a, b)
    for name, a, b in (("lm_safe", at[3], aj[3]), ("take", at[4], aj[4]), ("n_live", at[5], aj[5])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for name in tsch.BAProblem._fields:
        a, b = getattr(at[0], name).numpy(), np.asarray(getattr(aj[0], name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(at[5]) > 500 and at[0].fixed.numpy().sum() >= 1


def _writeback_case(snap):
    """Write-back inputs with two killed rows on one landmark, a kill in
    the LAST KF slot at full capacity (a copy of the newest keyframe put
    in slot kf_capacity - 1), right-camera kills, and a padding row."""
    a = dict(snap["arrays"])
    last = snap["kf_capacity"] - 1
    kf = snap["kf_slot"]
    for name in ("kf_pose", "kf_valid", "obs_uv", "obs_oct", "obs_stereo", "obs_lm",
                 "obs_desc", "obs_valid", "obs_r_uv", "obs_r_oct", "obs_r_lm"):
        a[name] = a[name].copy()
        a[name][last] = a[name][kf]
    obs = a["obs_lm"]
    shared = np.intersect1d(obs[kf][obs[kf] >= 0], obs[kf - 1][obs[kf - 1] >= 0])[:3]
    rows_kf, rows_key = [], []
    for slot in (kf - 1, last):
        for lm in shared:
            rows_kf.append(slot)
            rows_key.append(int(np.nonzero(obs[slot] == lm)[0][0]))
    rows_kf += [0, 0]  # non-kill rows aliasing key 0 of KF 0
    rows_key += [0, 0]
    kill = np.array([True] * (len(rows_kf) - 2) + [False, False])
    r_keys = np.nonzero(a["obs_r_lm"][kf] >= 0)[0][:2]
    kf_slots = np.array([kf - 1, last, kf, 0], np.int64)
    kf_valid = np.array([True, True, True, False])
    rng = np.random.default_rng(5)
    new_poses = a["kf_pose"][kf_slots] + rng.normal(0, 1e-3, (4, 4, 4)).astype(np.float32)
    lm_slots = np.concatenate([shared, [snap["lm_capacity"] - 1]])
    new_pts = rng.normal(0, 1, (len(lm_slots), 3)).astype(np.float32)
    args = dict(
        kf_slots=kf_slots, kf_valid=kf_valid, new_poses=new_poses, lm_slots=lm_slots,
        lm_keep=np.arange(len(lm_slots)) < len(shared), new_pts=new_pts,
        obs_kill_kf=np.array(rows_kf), obs_kill_key=np.array(rows_key), obs_kill=kill,
        obs_r_kill_kf=np.full(len(r_keys) + 1, kf), obs_r_kill_key=np.concatenate([r_keys, [0]]),
        obs_r_kill=np.array([True] * len(r_keys) + [False]),
    )
    return a, args, shared


def test_writeback_ba_matches_jax(runs):
    """writeback_ba in place against the JAX functional update, with two
    killed rows on each of three landmarks (one in the last KF slot at full
    capacity): identical obs_lm, obs_r_lm, lm_bitsum, lm_nobs, lm_desc,
    and the written poses and points bit for bit."""
    snap = runs["snaps"][-1]
    arrays, args, shared = _writeback_case(snap)
    mj = jms.writeback_ba(
        jms.MapArrays(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        **{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in args.items()},
    )
    mt = convert.map_arrays_from_jax(arrays, "cpu")
    tms.writeback_ba(mt, **{k: torch.from_numpy(v) for k, v in args.items()})
    mj = _np_map(mj)
    for name in ("obs_lm", "obs_r_lm", "lm_bitsum", "lm_nobs", "lm_desc", "kf_pose"):
        np.testing.assert_array_equal(getattr(mt, name).numpy(), mj[name], err_msg=name)
    np.testing.assert_array_equal(mt.lm_pos.numpy()[:-1], mj["lm_pos"][:-1])
    before = arrays["lm_nobs"][shared].astype(int)
    np.testing.assert_array_equal(mt.lm_nobs.numpy()[shared], before - 2)  # both kills counted
    assert (mt.obs_lm.numpy()[snap["kf_capacity"] - 1] == -1).sum() > (
        arrays["obs_lm"][snap["kf_capacity"] - 1] == -1
    ).sum()


def test_apply_triangulation_with_duplicate_claims_matches_jax(runs):
    """_apply_triangulation in place on a converted map, with two new
    landmarks claiming one key of an older view (equal Hamming distances
    pass the one-to-one gate together): the key keeps the later candidate,
    as the JAX scatter and the host mirror do, and both landmarks fold the
    key's descriptor; identical obs_lm, lm_bitsum, lm_nobs, lm_desc."""
    snap = runs["snaps"][-1]
    _, slots, _, _ = _tri_inputs(snap, port=False)
    a = snap["arrays"]
    kf, Kk = snap["kf_slot"], a["obs_lm"].shape[1]
    free_new = np.nonzero(a["obs_valid"][kf] & (a["obs_lm"][kf] < 0))[0][:6]
    older = slots[-2]
    free_old = np.nonzero(a["obs_valid"][older] & (a["obs_lm"][older] < 0))[0][:6]
    soc = np.full(Kk, -1, np.int64)
    soc[free_new] = snap["n_landmarks"] + np.arange(6)
    kv = np.full((len(slots) - 1, Kk), -1, np.int64)
    kv[-1, free_new] = free_old
    kv[-1, free_new[4]] = kv[-1, free_new[1]]  # candidates 1 and 4 claim one key
    kv[-2, free_new[:2]] = np.nonzero(a["obs_valid"][slots[-3]])[0][:2]
    mj = jlm._apply_triangulation(
        jms.MapArrays(**{k: jnp.asarray(v) for k, v in a.items()}), jnp.asarray(slots, jnp.int32),
        jnp.asarray(soc, jnp.int32), jnp.asarray(kv, jnp.int32),
    )
    mt = convert.map_arrays_from_jax(a, "cpu")
    tlm._apply_triangulation(mt, torch.from_numpy(slots), torch.from_numpy(soc), torch.from_numpy(kv))
    mj = _np_map(mj)
    for name in ("obs_lm", "lm_nobs", "lm_bitsum", "lm_desc"):
        np.testing.assert_array_equal(getattr(mt, name).numpy()[:-1], mj[name][:-1], err_msg=name)
    assert mt.obs_lm[older, free_old[1]] == soc[free_new[4]]
    assert (mt.lm_nobs.numpy()[soc[free_new]] - a["lm_nobs"][soc[free_new]] >= 1).all()


def test_last_writer_is_the_serial_scatter_winner():
    """map_state.last_writer keeps, for each target, the last ok row aiming
    at it: the row a serial scatter (the CPU's, XLA's) leaves in place,
    whatever order a CUDA scatter would write duplicates in."""
    rng = np.random.default_rng(11)
    n, rows = 50, 400
    tgt = rng.integers(0, n + 1, rows)  # n is the discard row
    ok = rng.uniform(size=rows) < 0.7
    win = tms.last_writer(torch.from_numpy(tgt), torch.from_numpy(ok), n).numpy()
    last = {}
    for i in np.nonzero(ok)[0]:
        last[tgt[i]] = i
    expect = np.zeros(rows, bool)
    expect[list(last.values())] = True
    np.testing.assert_array_equal(win, expect)
    assert len(np.unique(tgt[win])) == win.sum() < ok.sum()  # duplicates occurred


def test_mapper_run_from_converted_state(runs):
    """LocalMapper.run on the converted map of each keyframe the JAX run
    mapped: the same window, n_killed and new landmark ids; poses within
    1e-4; the window's landmarks within 1e-4 of their range."""
    for snap in runs["snaps"]:
        jm, tm = _mappers(snap)
        rj, rt = jm.run(snap["kf_slot"]), tm.run(snap["kf_slot"])
        assert rt["window"] == rj["window"] and rt["n_killed"] == rj["n_killed"]
        np.testing.assert_array_equal(rt["new_lm_ids"], rj["new_lm_ids"])
        np.testing.assert_allclose(tm.world.kf_poses_host, jm.world.kf_poses_host, atol=1e-4, rtol=0)
        np.testing.assert_allclose(rt["new_pose"], rj["new_pose"], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(tm.world.kf_obs_lm, jm.world.kf_obs_lm)
        np.testing.assert_array_equal(tm.world.kf_obs_r_lm, jm.world.kf_obs_r_lm)
        assert tm.world.n_landmarks == jm.world.n_landmarks
        ids = np.unique(tm.world.kf_obs_lm[rt["window"]])
        ids = ids[ids >= 0]
        pj = np.asarray(jm.world.arrays.lm_pos)[ids]
        dist = np.linalg.norm(tm.world.arrays.lm_pos.numpy()[ids] - pj, axis=1)
        assert (dist <= 1e-4 * np.linalg.norm(pj, axis=1)).all(), dist.max()
        assert abs(rt["error"] - rj["error"]) <= 1e-3 * max(rj["error"], 1.0)


def test_unrectified_rig_remaps_on_the_device(scene):
    """An EuRoC-style config (identity D/K/R/P) sends the frames through
    the facade's remap, kept as tensors on the device; the trajectory is
    the rectified one."""
    sys_r = tsys.VSlamSystem(TConfig.from_dict(_config(True)), **CAPS,
                             tracker_params=ttr.TrackerParams(**PARAMS), device="cpu")
    sys_u = tsys.VSlamSystem(TConfig.from_dict(_config(False)), **CAPS,
                             tracker_params=ttr.TrackerParams(**PARAMS), device="cpu")
    assert sys_r._maps is None and sys_u._maps is not None
    left, right = sys_u._rectify(*scene.frames[0])
    assert isinstance(left, torch.Tensor) and left.shape == (H, W)
    np.testing.assert_allclose(left.numpy(), scene.frames[0][0], atol=1e-3)
    for sys_ in (sys_r, sys_u):
        for l, r in scene.frames[:4]:
            sys_.track_stereo(l, r)
    np.testing.assert_allclose(sys_u.trajectory(), sys_r.trajectory(), atol=1e-4, rtol=0)


def test_camera_matches_jax():
    """init_undistort_rectify_map with real distortion and a rectifying
    rotation, remap_bilinear (border pixels included), project and
    backproject against the JAX versions."""
    rng = np.random.default_rng(2)
    Kc = np.array([[458.6, 0, 367.2], [0, 457.3, 248.4], [0, 0, 1]])
    D = np.array([-0.28, 0.074, 1.9e-4, 1.8e-5, 0.0])
    ang = 0.02
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    P = np.array([[435.2, 0, 367.5, 0], [0, 435.2, 252.2, 0], [0, 0, 1, 0]])
    mj = jcam.init_undistort_rectify_map(Kc, D, R, P, 160, 120)
    mt = tcam.init_undistort_rectify_map(Kc, D, R, P, 160, 120)
    np.testing.assert_array_equal(mt, mj)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    src = mj + rng.normal(0, 3.0, mj.shape).astype(np.float32)  # some samples off the border
    np.testing.assert_allclose(
        tcam.remap_bilinear(torch.from_numpy(img), torch.from_numpy(src)).numpy(),
        np.asarray(jcam.remap_bilinear(jnp.asarray(img), jnp.asarray(src))), atol=1e-3, rtol=1e-6,
    )
    pts = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    K32 = Kc.astype(np.float32)
    uv_t = tcam.project(torch.from_numpy(K32), torch.from_numpy(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(jcam.project(jnp.asarray(K32), jnp.asarray(pts))), rtol=1e-6)
    back = tcam.backproject(torch.from_numpy(K32), uv_t, torch.from_numpy(pts[:, 2]))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-4)


def test_trajectory_io_matches_jax(tmp_path, scene):
    """KITTI and TUM files written by both packages hold the same numbers;
    rpe_rmse agrees."""
    poses = scene.poses_c2w[:N_FRAMES].astype(np.float32)
    times = np.arange(N_FRAMES) * 0.1
    jtraj.save_kitti_trajectory(str(tmp_path / "j.txt"), poses)
    ttraj.save_kitti_trajectory(str(tmp_path / "t.txt"), poses)
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()
    np.testing.assert_allclose(ttraj.load_kitti_trajectory(str(tmp_path / "t.txt")), poses, atol=1e-6)
    jtraj.save_tum_trajectory(str(tmp_path / "j.tum"), times, poses)
    ttraj.save_tum_trajectory(str(tmp_path / "t.tum"), times, poses)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.tum"), np.loadtxt(tmp_path / "j.tum"), atol=2e-6)
    noisy = poses.copy()
    noisy[:, :3, 3] += np.random.default_rng(0).normal(0, 0.01, (N_FRAMES, 3))
    assert ttraj.rpe_rmse(noisy, poses, 2) == pytest.approx(jtraj.rpe_rmse(noisy, poses, 2), rel=1e-9)


def test_unported_paths_raise(runs, tmp_path):
    """The paths once not ported (ROADMAP A12) run: shards=2 on the CPU
    gives the mapper a 2-shard mesh and "auto" an unsharded one (one device);
    a mesh that cannot divide the landmark slots or the observation rows
    raises ValueError, as JAX's does (local_mapper.py:656-661).
    loop_closure=True builds the closer; MONOCULAR (sync or async) builds a
    MonoTracker; global BA and mono triangulation run on every mapper entry
    (sync, staged and async) of the stereo map."""
    from vslam_torch import run_synthetic
    from vslam_torch.parallel import mesh as tmesh

    conf = TConfig.from_dict(_config())
    params = ttr.TrackerParams(**PARAMS)
    two = tsys.VSlamSystem(conf, **CAPS, tracker_params=params, device="cpu", shards=2)
    assert two.mapper.mesh.size == 2
    auto = tsys.VSlamSystem(conf, **CAPS, tracker_params=params, device="cpu", shards="auto")
    assert auto.mapper.mesh is None
    lc = tsys.VSlamSystem(conf, **CAPS, tracker_params=params, device="cpu", loop_closure=True)
    assert lc.loop_closer is not None and lc.loop_closer.world is lc.world
    for async_ba in (False, True):
        mono = tsys.VSlamSystem(conf, **CAPS, tracker_params=params, device="cpu",
                                mode=tsys.SlamMode.MONOCULAR, async_ba=async_ba)
        assert isinstance(mono.tracker, ttr.MonoTracker) and mono.tracker.baseline == 0.0
    ts = runs["torch"]
    m = ts.mapper
    n_kf = ts.world.n_keyframes
    r = ts.global_ba()
    assert r["window"] == list(range(n_kf)) and r["kf_slot"] == n_kf - 1 and np.isfinite(r["error"])
    for call in (lambda: m.run(n_kf - 1, mono=True), lambda: m.run_async(n_kf - 1, mono=True),
                 lambda: m.finish(m.run_async_staged(n_kf - 1, mono=True))):
        assert call()["kf_slot"] == n_kf - 1
    assert isinstance(m.find_new_points(n_kf - 1, mono=True), np.ndarray)
    with pytest.raises(ValueError, match="must divide landmark slots"):
        tlm.LocalMapper(ts.world, np.eye(3), BL, mesh=tmesh.make_mesh(3, device="cpu"))
    p = tsch.BAProblem(*[torch.zeros(1)] * len(tsch.BAProblem._fields))
    with pytest.raises(ValueError, match="observation rows"):
        tsch.local_ba(p, mesh=tmesh.make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="observation rows"):
        tsch.local_ba_two_rounds(p, n_slabs=4, mesh=tmesh.make_mesh(2, device="cpu"))
    # the trajectory files the facade writes
    ts.save_trajectory(str(tmp_path / "traj.txt"), times=np.arange(N_FRAMES) * 0.1)
    assert np.loadtxt(tmp_path / "traj.txt").shape == (N_FRAMES, 12)
    assert np.loadtxt(tmp_path / "traj.txt.tum").shape == (N_FRAMES, 8)


def test_facade_never_imports_jax():
    """``vslam_torch.models.system`` and ``vslam_torch.run_synthetic``, an
    8-frame CPU run with the sync local mapper and a global BA after it,
    8 frames with the async one, 4 STEREO_IMU frames and 8 mono-inertial
    frames, in a fresh interpreter where importing jax fails loudly."""
    code = textwrap.dedent(
        """
        import importlib.abc, sys

        class _NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("vslam_torch must not import " + name)

        sys.meta_path.insert(0, _NoJax())
        import numpy as np, torch
        torch.set_num_threads(1)
        from vslam_torch import run_synthetic  # noqa: F401
        from vslam_torch.models import system, tracker
        from vslam_torch.utils import datasets, synthetic
        from vslam_torch.utils.config import ConfigFile

        s = synthetic.make_scene(n_frames=8, n_points=300, width=160, height=120, fps=10.0, seed=3)
        cam = {"fx": 460.0, "fy": 460.0, "cx": 80.0, "cy": 60.0}
        rig = {"Camera_l": cam, "Camera_r": cam,
               "Camera": {"width": 160, "height": 120, "fps": 10.0, "bl": 0.12}}
        bins = datasets.bin_imu_per_frame(s.imu, s.times)
        # n_features >= the mapper's SPAWN_TRI budget (512), as in vslam_tpu
        p = tracker.TrackerParams(n_features=512, n_levels=2, active_size=1024, spawn_per_kf=128, kf_every=2)
        counts = []
        for mode, async_ba, n in ((1, False, 8), (1, True, 8), (0, False, 4), (2, False, 8)):
            conf = ConfigFile.from_dict({"slamMode": mode, **rig})
            sys_ = system.VSlamSystem(conf, async_ba=async_ba, lm_capacity=2048, kf_capacity=16,
                                      tracker_params=p, device="cpu")
            if mode != 1:
                sys_._gravity_set = True
                sys_.tracker.set_gravity(synthetic.GRAVITY_W)
                sys_.tracker.velocity = s.velocities[0].astype(np.float32)
            for f in range(n):
                if mode == 2:
                    sys_.track_mono_imu(s.render(f), imu=bins[f])
                else:
                    sys_.track_stereo(s.render(f), s.render(f, right=True), imu=bins[f])
            sys_.exit()
            assert sys_.trajectory().shape == (n, 4, 4) and sys_._pending_ba is None
            counts.append(sys_.mapper.ba_count)
            if mode == 1 and not async_ba:
                g = sys_.global_ba()
                assert g["window"] == list(range(sys_.world.n_keyframes))
        assert counts[0] >= 2 and counts[1] >= 1 and sys_.tracker.initialized
        assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
        print("NO_JAX_OK", counts)
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]
