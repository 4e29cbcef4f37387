"""The port's multi-sequence batch mode with IMU on the CPU
(tests/test_parallel.py:299-470's shapes): mono-inertial, 2 sequences x 14
frames (bootstraps unbatched, then one batched mono step), against the
port's own solo runs (1e-6 m) and against vslam_tpu's
BatchedStereoFrontend on the same frames (the same keyframe slots, poses
within 1e-3 m), with tests/test_parallel.py's ATE gate; and the batched
preintegration with per-sequence parameters. The stereo-inertial batch
(2 sequences x 8 frames) is tests/test_torch_multi_seq_imu.py, which runs
these helpers: the two fixtures take about a minute each."""

import numpy as np
import pytest
import torch

from vslam_torch.models import local_mapper as tlm, map_state as tms, tracker as ttr
from vslam_torch.parallel import multi_seq as tseq
from vslam_torch.utils import trajectory as ttraj
from vslam_tpu.models import local_mapper as jlm, map_state as jms, tracker as jtr
from vslam_tpu.parallel import multi_seq as jseq
from vslam_tpu.utils import datasets, synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

S = 2
# the same ops on the same inputs: equal on the CPU (tests/test_parallel.py:380,
# 466 allow 2e-3 m)
SOLO_TOL_M = 1e-6
JAX_TOL_M = 1e-3  # tests/test_torch_mono.py's and test_torch_tracker.py's tracked-pose tolerance
ATE_GATE_M = {"mono": 0.06, "stereo_imu": 0.04}
IMU = dict(gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3, hz=200.0)
CASES = {
    # mode: frames, scene parameters, tracker parameters
    "mono": (14, lambda s: dict(n_points=500, seed=11 + 5 * s, texture="distinct", motion="lateral"),
             dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256)),
    "stereo_imu": (8, lambda s: dict(n_points=400, seed=7 + 5 * s),
                   dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)),
}


def _dt_rows(bins, f):
    """tests/test_parallel.py:313-321: a frame's [dt, gyro, accel] rows."""
    rows = bins[f]
    if rows is None or len(rows) == 0:
        return None
    t = rows[:, 0]
    dts = np.diff(np.concatenate([[t[0] - 1.0 / 200.0], t]))
    return np.concatenate([np.maximum(dts, 0)[:, None], rows[:, 1:7]], axis=1).astype(np.float32)


def _pair(torch_pkg: bool, mode: str, scene):
    trk_mod, map_mod, lm_mod = (ttr, tms, tlm) if torch_pkg else (jtr, jms, jlm)
    kw = {"device": "cpu"} if torch_pkg else {}
    params = trk_mod.TrackerParams(**CASES[mode][2])
    K = scene.K.astype(np.float32)
    world = map_mod.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=params.n_features, **kw)
    cfg = trk_mod.ImuConfig(**IMU, T_bc=np.eye(4, dtype=np.float32),
                            gravity_w=synthetic.GRAVITY_W.astype(np.float32))
    if mode == "mono":
        trk = trk_mod.MonoTracker(K, scene.width, scene.height, world, params, imu_cfg=cfg, **kw)
    else:
        trk = trk_mod.StereoTracker(K, scene.baseline, scene.width, scene.height, world, params,
                                    imu_cfg=cfg, **kw)
    trk.velocity = scene.velocities[0].astype(np.float32)
    baseline = 0.0 if mode == "mono" else scene.baseline
    mapper = lm_mod.LocalMapper(world, K, baseline, lm_mod.LocalMapperConfig(n_levels=4, scale=1.2))
    return trk, mapper


def _service(mode, trk, mapper, nk):
    """tests/test_parallel.py:344-352 (mono) and :440-444 (stereo-IMU)."""
    if mode == "mono":
        if trk.needs_init_triangulation:
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            trk.add_active(ids)
            trk.needs_init_triangulation = False
            trk.last_kf_tracked = max(len(ids), 1)
        elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
            trk.add_active(mapper.find_new_points(trk.new_kf_slots[-1], mono=True))
    elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
        r = mapper.run(trk.new_kf_slots[-1])
        trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        trk.add_active(r["new_lm_ids"])


def _frame(mode, scene, f):
    img = scene.render(f)
    return img if mode == "mono" else (img, scene.render(f, right=True))


def batch_runs(mode: str) -> dict:
    """Solo port runs, the port's batch and JAX's batch of one mode."""
    n, scene_kw, _ = CASES[mode]
    scenes = [synthetic.make_scene(n_frames=n, width=320, height=240, fps=10.0, **scene_kw(s))
              for s in range(S)]
    frames = [[_frame(mode, sc, f) for sc in scenes] for f in range(n)]
    rows = [[_dt_rows(datasets.bin_imu_per_frame(sc.imu, sc.times), f) for sc in scenes] for f in range(n)]
    solo = []
    for s, sc in enumerate(scenes):
        trk, mapper = _pair(True, mode, sc)
        for f in range(n):
            nk = len(trk.new_kf_slots)
            fr = frames[f][s]
            if mode == "mono":
                trk.track(fr, imu=rows[f][s])
            else:
                trk.track(*fr, imu=rows[f][s])
            _service(mode, trk, mapper, nk)
        solo.append(trk.trajectory())
    out = {"mode": mode, "n": n, "scenes": scenes, "solo": solo}
    for name, front_mod in (("torch", tseq), ("jax", jseq)):
        pairs = [_pair(name == "torch", mode, sc) for sc in scenes]
        front = front_mod.BatchedStereoFrontend([p[0] for p in pairs])
        assert front._has_imu and front._mono == (mode == "mono")
        for f in range(n):
            nks = [len(p[0].new_kf_slots) for p in pairs]
            front.track(frames[f], imu=rows[f])
            for (trk, mapper), nk in zip(pairs, nks):
                _service(mode, trk, mapper, nk)
        front.flush()
        out[name] = pairs
    return out


@pytest.fixture(scope="module")
def runs():
    return batch_runs("mono")


def test_inertial_batch_matches_solo_runs(runs):
    """Each sequence of the batch against its own solo run of the port:
    poses within 1e-6 m, ATE under tests/test_parallel.py's gate."""
    check_solo(runs)


def test_inertial_batch_matches_jax_batch(runs):
    """The port's batch against vslam_tpu's on the same frames and IMU
    rows: the same keyframe slots at the same frames, poses within 1e-3 m."""
    check_jax(runs)


def check_solo(runs):
    mode, n = runs["mode"], runs["n"]
    for s, ((trk, _), solo) in enumerate(zip(runs["torch"], runs["solo"])):
        batched = trk.trajectory()
        assert len(batched) == len(solo) == n
        np.testing.assert_allclose(batched, solo, atol=SOLO_TOL_M, rtol=0)
        ate = ttraj.ate_rmse(batched, runs["scenes"][s].poses_c2w[:n], align=False)
        assert ate < ATE_GATE_M[mode], (mode, s, ate)


def check_jax(runs):
    for s, ((tt, _), (jt, _)) in enumerate(zip(runs["torch"], runs["jax"])):
        assert tt.new_kf_slots == jt.new_kf_slots, (runs["mode"], s)
        n_kf = jt.world.n_keyframes
        np.testing.assert_array_equal(tt.world.kf_frame_idx[:n_kf], jt.world.kf_frame_idx[:n_kf])
        np.testing.assert_allclose(tt.trajectory(), jt.trajectory(), atol=JAX_TOL_M, rtol=0)


def test_per_sequence_imu_constants_batch():
    """Per-sequence noise parameters ride as (S,) tensors, and a sequence
    whose sample bin is shorter keeps its preintegration once its rows run
    out: the batched preintegration equals each sequence's own."""
    from vslam_torch.ops import imu as timu

    rng = np.random.default_rng(0)
    rows = [np.concatenate([np.full((k, 1), 0.005), rng.normal(0, 0.3, (k, 6))], 1).astype(np.float32)
            for k in (7, 3)]
    rows[1][1, 0] = 0.0  # a dt == 0 row is skipped
    prms = [timu.ImuParams(1.7e-4, 2e-3, 1.9e-5, 3e-3), timu.ImuParams(3e-4, 4e-3, 2e-5, 5e-3)]
    bias = torch.from_numpy(rng.normal(0, 0.01, (2, 6)).astype(np.float32))
    batch_prm = timu.ImuParams(*(torch.tensor(np.float32(c)) for c in zip(*prms)))
    pre_b = timu.preintegrate(rows, bias, batch_prm)
    for s in range(2):
        pre_s = timu.preintegrate(rows[s], bias[s], prms[s])
        for name, a, b in zip(timu.PreintState._fields, pre_b, pre_s):
            np.testing.assert_allclose(a[s].numpy(), b.numpy(), rtol=1e-6, atol=1e-9, err_msg=name)
