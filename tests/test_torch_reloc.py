"""Lost-tracking recovery in the port against vslam_tpu on the CPU:
tests/test_tracking.py's three scenarios (stereo relocalization after a
blackout and a teleport back, a stereo re-seed after a blackout into an
unmapped scene, and the mono relocalization of a hovering camera) through
both packages, and models/reloc.py's pieces (keyframe_votes,
_verify_candidate, retrieve) on the retrieval inputs of the JAX run,
handed across by ``vslam_torch.models.convert``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_torch.models import convert, local_mapper as tlm, map_state as tms, reloc as treloc
from vslam_torch.models import tracker as ttr
from vslam_torch.ops import extract as text
from vslam_tpu.models import local_mapper as jlm, map_state as jms, reloc as jreloc
from vslam_tpu.models import tracker as jtr
from vslam_tpu.utils import datasets, synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

W, H = 320, 240
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
WORLD = dict(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
POSE_TOL = 1e-3  # poses after a recovery (the tracker slice's tolerance)
BLACK = np.zeros((H, W), np.float32)


def _np(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _instrument(trk, reloc_mod, log):
    """Log every due recovery as (frame, kind, slot) and every retrieval's
    inputs and result."""
    relocalize, insert = trk._relocalize, trk._insert_keyframe
    retrieve = reloc_mod.retrieve

    def logged_relocalize(frame_idx, outputs):
        ok = relocalize(frame_idx, outputs)
        log["recoveries"].append((frame_idx, "reloc" if ok else "refused", trk.last_kf_slot if ok else -1))
        return ok

    def logged_insert(frame_idx, pose, outputs, layout, ages, reseed=False, defer=False):
        n = insert(frame_idx, pose, outputs, layout, ages, reseed=reseed, defer=defer)
        if reseed:
            log["recoveries"].append((frame_idx, "reseed", trk.last_kf_slot))
        return n

    def logged_retrieve(world, keys, n_keyframes, K, baseline=0.0, min_inliers=25):
        out = retrieve(world, keys, n_keyframes, K, baseline=baseline, min_inliers=min_inliers)
        log["retrievals"].append({
            "arrays": _np(world.arrays), "kf_capacity": world.kf_capacity,
            "keys": {k: np.asarray(v) if not torch.is_tensor(v) else v.numpy() for k, v in keys._asdict().items()},
            "n_keyframes": n_keyframes, "baseline": baseline, "min_inliers": min_inliers,
            "result": out,
        })
        return out

    trk._relocalize, trk._insert_keyframe = logged_relocalize, logged_insert
    return logged_retrieve


def _drive(port: bool, make, frames, step=None):
    """Track `frames` ((left, right-or-None, imu) triples) with the tracker
    `make(port)` builds; retrieval calls are recorded while it runs."""
    trk, mapper = make(port)
    reloc_mod = treloc if port else jreloc
    log = {"recoveries": [], "retrievals": []}
    saved = reloc_mod.retrieve
    reloc_mod.retrieve = _instrument(trk, reloc_mod, log)
    try:
        for left, right, imu in frames:
            nk = len(trk.new_kf_slots)
            trk.track(left, right, imu) if right is not None else trk.track(left, imu=imu)
            if step is not None:
                step(trk, mapper, nk)
        trk.flush()
    finally:
        reloc_mod.retrieve = saved
    log["trk"], log["traj"] = trk, trk.trajectory()
    return log


def _stereo(scene):
    def make(port):
        if port:
            w = tms.WorldMap(**WORLD, device="cpu")
            return ttr.StereoTracker(scene.K, scene.baseline, W, H, w, ttr.TrackerParams(**PARAMS),
                                     device="cpu"), None
        w = jms.WorldMap(**WORLD)
        return jtr.StereoTracker(scene.K.astype(np.float32), scene.baseline, W, H, w,
                                 jtr.TrackerParams(**PARAMS)), None
    return make


def _pair(scene, f):
    return scene.render(f), scene.render(f, right=True), None


@pytest.fixture(scope="module")
def stereo_reloc():
    """tests/test_tracking.py:373-409: frames 0-7, 6 black frames, frames
    0-7 again."""
    scene = synthetic.make_scene(n_frames=16, n_points=400, width=W, height=H, fps=10.0, seed=7)
    frames = [_pair(scene, f) for f in range(8)] + [(BLACK, BLACK, None)] * 6
    frames += [_pair(scene, f) for f in range(8)]
    return {"scene": scene, **{k: _drive(k == "torch", _stereo(scene), frames) for k in ("jax", "torch")}}


@pytest.fixture(scope="module")
def stereo_reseed():
    """tests/test_tracking.py:323-370: 6 frames of seed 7, 3 black frames,
    10 frames of seed 23 (an unmapped scene)."""
    s1 = synthetic.make_scene(n_frames=8, n_points=400, width=W, height=H, fps=10.0, seed=7)
    s2 = synthetic.make_scene(n_frames=12, n_points=400, width=W, height=H, fps=10.0, seed=23)
    frames = [_pair(s1, f) for f in range(6)] + [(BLACK, BLACK, None)] * 3
    frames += [_pair(s2, f) for f in range(10)]
    return {"s2": s2, **{k: _drive(k == "torch", _stereo(s1), frames) for k in ("jax", "torch")}}


def _mono_make(scene):
    p = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256)

    def make(port):
        K = scene.K.astype(np.float32)
        mod = ttr if port else jtr
        imu_cfg = mod.ImuConfig(
            gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3, hz=200.0,
            T_bc=np.eye(4, dtype=np.float32), gravity_w=synthetic.GRAVITY_W.astype(np.float32),
        )
        if port:
            w = tms.WorldMap(**WORLD, device="cpu")
            trk = ttr.MonoTracker(K, W, H, w, ttr.TrackerParams(**p), imu_cfg=imu_cfg, device="cpu")
            mapper = tlm.LocalMapper(w, K, 0.0, tlm.LocalMapperConfig(n_levels=4, scale=1.2))
        else:
            w = jms.WorldMap(**WORLD)
            trk = jtr.MonoTracker(K, W, H, w, jtr.TrackerParams(**p), imu_cfg=imu_cfg)
            mapper = jlm.LocalMapper(w, K, 0.0, jlm.LocalMapperConfig(n_levels=4, scale=1.2))
        trk.velocity = scene.velocities[0].astype(np.float32)
        return trk, mapper
    return make


def _mono_step(trk, mapper, nk):
    if getattr(trk, "needs_init_triangulation", False):
        ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
        trk.add_active(ids)
        trk.needs_init_triangulation = False
        trk.last_kf_tracked = max(len(ids), 1)
    elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
        trk.add_active(mapper.find_new_points(trk.new_kf_slots[-1], mono=True))


@pytest.fixture(scope="module")
def mono_reloc():
    """tests/test_tracking.py:412-491: 10 frames of a lateral sweep, 6
    black frames without IMU, then frame 2's view held for 12 frames."""
    scene = synthetic.make_scene(n_frames=20, n_points=500, width=W, height=H, fps=10.0, seed=11,
                                 texture="distinct", motion="lateral")
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)

    def dt_rows(f):
        rows = bins[f]
        if rows is None or len(rows) == 0:
            return None
        t = rows[:, 0]
        dts = np.diff(np.concatenate([[t[0] - 0.005], t]))
        return np.concatenate([np.maximum(dts, 0)[:, None], rows[:, 1:7]], axis=1).astype(np.float32)

    hover = scene.render(2)
    frames = [(scene.render(f), None, dt_rows(f)) for f in range(10)]
    frames += [(BLACK, None, None)] * 6 + [(hover, None, None)] * 12
    return {"scene": scene, **{k: _drive(k == "torch", _mono_make(scene), frames, _mono_step)
                               for k in ("jax", "torch")}}


def _same_recovery(j, t):
    """The same recovery frames, kinds and retrieved slots; the same
    keyframes; every pose within POSE_TOL."""
    assert t["recoveries"] == j["recoveries"] and t["recoveries"]
    assert [r["result"][:2] for r in t["retrievals"]] == [r["result"][:2] for r in j["retrievals"]]
    assert t["trk"].new_kf_slots == j["trk"].new_kf_slots
    assert t["traj"].shape == j["traj"].shape
    np.testing.assert_allclose(t["traj"], j["traj"], atol=POSE_TOL, rtol=0)
    for k in ("n_inliers", "lost"):
        assert t["trk"].last_stats[k] == j["trk"].last_stats[k]


def test_stereo_relocalization_matches_jax(stereo_reloc):
    """One relocalization, at the same frame onto the same keyframe, in
    both packages; the tail back in the original world frame (< 0.15 m,
    tests/test_tracking.py:409's gate)."""
    j, t = stereo_reloc["jax"], stereo_reloc["torch"]
    _same_recovery(j, t)
    # retrievals on the black frames find nothing; the first replayed
    # frame past the recovery spacing relocalizes
    assert [k for _, k, _ in t["recoveries"] if k != "refused"] == ["reloc"]
    assert t["trk"].counters.get("relocalizations") == 1
    assert t["trk"].last_stats["n_inliers"] >= PARAMS["kf_min_stereo"]
    gt = stereo_reloc["scene"].poses_c2w[[5, 6, 7]]
    errs = np.linalg.norm(t["traj"][-3:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs.max() < 0.15, errs


def test_stereo_reseed_matches_jax(stereo_reseed):
    """Relocalization refused on the unmapped scene, then a re-seed
    keyframe at the same frame in both packages; the spawn count is its
    tracked baseline; relative motion after it within 0.15 m of the
    ground truth (tests/test_tracking.py:370)."""
    j, t = stereo_reseed["jax"], stereo_reseed["torch"]
    _same_recovery(j, t)
    kinds = [k for _, k, _ in t["recoveries"]]
    assert "reseed" in kinds and "reloc" not in kinds
    tt = t["trk"]
    assert tt.lost_streak == 0 and tt.last_stats["n_inliers"] >= 50
    poses, gt = t["traj"], stereo_reseed["s2"].poses_c2w
    rec0 = 6 + 3 + 6
    est_rel = np.linalg.inv(poses[rec0]) @ poses[-1]
    gt_rel = np.linalg.inv(gt[rec0 - 9]) @ gt[9]
    assert np.linalg.norm(est_rel[:3, 3] - gt_rel[:3, 3]) < 0.15


def test_mono_relocalization_matches_jax(mono_reloc):
    """The hovering mono camera relocalizes once, at the same frame onto
    the same keyframe, in both packages, and ends near the hover view's
    true pose (< 0.25 m, tests/test_tracking.py:491)."""
    j, t = mono_reloc["jax"], mono_reloc["torch"]
    _same_recovery(j, t)
    assert t["trk"].counters.get("relocalizations") == 1
    gt_t = mono_reloc["scene"].poses_c2w[2][:3, 3]
    errs = np.linalg.norm(t["traj"][-3:, :3, 3] - gt_t[None], axis=1)
    assert errs.max() < 0.25, errs


def _accepted(run):
    """The JAX run's accepted retrieval, its map and keys as the port's."""
    rec = next(r for r in run["jax"]["retrievals"] if r["result"][0] >= 0)
    m = convert.map_arrays_from_jax(rec["arrays"], "cpu")
    keys = text.Keys(**{k: torch.from_numpy(np.array(v, np.int64 if k in ("octave", "packed") else None))
                        for k, v in rec["keys"].items()})
    return rec, m, keys


@pytest.mark.parametrize("chunk", [treloc.VOTE_CHUNK, 5])
def test_keyframe_votes_match_jax(stereo_reloc, monkeypatch, chunk):
    """Exact integer votes over the padded keyframe prefix, whatever the
    keyframe chunk."""
    rec, m, keys = _accepted(stereo_reloc)
    a = rec["arrays"]
    Wc = 16
    want = np.asarray(jreloc.keyframe_votes(
        jnp.asarray(a["obs_desc"][:Wc]), jnp.asarray(a["obs_valid"][:Wc]),
        jnp.asarray(a["kf_valid"][:Wc]), jnp.asarray(rec["keys"]["desc"]), jnp.asarray(rec["keys"]["valid"]),
    ))
    monkeypatch.setattr(treloc, "VOTE_CHUNK", chunk)
    got = treloc.keyframe_votes(m.obs_desc[:Wc], m.obs_valid[:Wc], m.kf_valid[:Wc], keys.desc, keys.valid)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() >= treloc.MIN_VOTES


@pytest.mark.parametrize("which", ["stereo", "mono"])
def test_verify_candidate_matches_jax(stereo_reloc, mono_reloc, which):
    """The PnP verification of the accepted keyframe: pose within 1e-5,
    n_inliers and n_matches exact."""
    run = stereo_reloc if which == "stereo" else mono_reloc
    rec, m, keys = _accepted(run)
    slot = rec["result"][0]
    jm = jms.MapArrays(**{k: jnp.asarray(v) for k, v in rec["arrays"].items()})
    K = run["scene"].K.astype(np.float32)
    Tj, nij, nmj = jreloc._verify_candidate(
        jm, jnp.int32(slot), jnp.asarray(rec["keys"]["xy"]), jnp.asarray(rec["keys"]["desc"]),
        jnp.asarray(rec["keys"]["valid"]), jnp.asarray(K), jnp.float32(rec["baseline"]),
    )
    Tt, nit, nmt = treloc._verify_candidate(m, slot, keys.xy, keys.desc, keys.valid,
                                            torch.from_numpy(K), rec["baseline"])
    assert int(nit) == int(nij) and int(nmt) == int(nmj) and int(nit) >= 20
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("which", ["stereo", "mono"])
def test_retrieve_matches_jax(stereo_reloc, mono_reloc, which):
    """retrieve on every retrieval input the JAX run made (refused ones
    included): the same slot and votes, the pose within 1e-5."""
    run = stereo_reloc if which == "stereo" else mono_reloc
    for rec in run["jax"]["retrievals"]:
        w = tms.WorldMap(**WORLD, device="cpu")
        w.arrays = convert.map_arrays_from_jax(rec["arrays"], "cpu")
        w.kf_capacity = rec["kf_capacity"]
        keys = text.Keys(**{k: torch.from_numpy(np.array(v, np.int64 if k in ("octave", "packed") else None))
                            for k, v in rec["keys"].items()})
        slot, votes, T = treloc.retrieve(w, keys, rec["n_keyframes"], run["scene"].K,
                                         baseline=rec["baseline"], min_inliers=rec["min_inliers"])
        j_slot, j_votes, j_T = rec["result"]
        assert (slot, votes) == (j_slot, j_votes)
        if slot >= 0:
            np.testing.assert_allclose(T, np.asarray(j_T), atol=1e-5, rtol=0)
        else:
            assert T is None and j_T is None
