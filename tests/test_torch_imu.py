"""The port's stereo-inertial path against vslam_tpu on the CPU: the IMU
ops on seeded rows (zero-dt pads included), the 15-dof motion-only solve,
one tracked frame from a converted IMU state, the STEREO_IMU facade on
tests/test_system.py's setup (320x240, 512 features, 4 levels, 10 frames,
seed 7, gravity and the initial velocity from the scene), the gravity-init
mechanism, and the IMU binning helpers."""

import os
import tempfile

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from vslam_torch.models import convert, map_state as tms, system as tsys, tracker as ttr
from vslam_torch.ops import imu as timu, lm as tlm
from vslam_torch.utils import datasets as tds, trajectory as ttraj
from vslam_torch.utils.config import ConfigFile as TConfig
from vslam_tpu.models import map_state as jms, system as jsys, tracker as jtr
from vslam_tpu.ops import imu as jimu, lm as jlm
from vslam_tpu.utils import datasets as jds, synthetic, trajectory as jtraj
from vslam_tpu.utils.config import ConfigFile as JConfig

torch.set_num_threads(2)  # xdist runs several workers on one box

W, H = 320, 240
FX, BL = 460.0, 0.12
N_FRAMES = 10
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
CAPS = dict(lm_capacity=8192, kf_capacity=64)
IMU_PRM = dict(gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3)
REL = 1e-5


def _jparams():
    return jimu.ImuParams(**{k: jnp.float32(v) for k, v in IMU_PRM.items()})


def _config() -> dict:
    """tests/test_system.py's STEREO_IMU config (reference YAML schema)."""
    cam = {"fx": FX, "fy": FX, "cx": W / 2.0, "cy": H / 2.0}
    return {
        "rectified": True, "slamMode": 0, "dataset": "KITTI",
        "imagesPath": "/nonexistent", "fileExtension": ".png",
        "Camera": {"width": W, "height": H, "fps": 10.0, "bl": BL},
        "Camera_l": dict(cam), "Camera_r": dict(cam),
        "FE": {"nFeatures": 512, "nLevels": 4, "imScale": 1.2, "edgeThreshold": 19,
               "maxFastThreshold": 20, "minFastThreshold": 7},
        "IMU": {"Hz": 200, "gyroscope_noise_density": 1.7e-4,
                "accelerometer_noise_density": 2.0e-3, "gyroscope_random_walk": 1.9e-5,
                "accelerometer_random_walk": 3.0e-3},
    }


def _jax_config(tmp_path_factory) -> JConfig:
    path = tmp_path_factory.mktemp("cfg") / "config.yaml"
    path.write_text(yaml.safe_dump(_config()))
    return JConfig(str(path))


@pytest.fixture(scope="module")
def scene():
    s = synthetic.make_scene(n_frames=12, n_points=400, width=W, height=H, fps=10.0, seed=7)
    s.frames = [(s.render(f), s.render(f, right=True)) for f in range(N_FRAMES)]
    s.bins = jds.bin_imu_per_frame(s.imu, s.times)
    return s


def _rows(seed: int, k: int = 12) -> np.ndarray:
    """64 padded [dt, gyro, accel] rows: k real samples at ~200 Hz with one
    zero-dt row among them, then dt == 0 pads."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((64, 7), np.float32)
    rows[:k, 0] = rng.uniform(0.004, 0.006, k)
    rows[3, 0] = 0.0
    rows[:k, 1:4] = rng.normal(0, 0.4, (k, 3))
    rows[:k, 4:7] = rng.normal(0, 2.0, (k, 3)) + [0.3, -0.2, 9.81]
    return rows


def _close(a, b, name, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-6)
    assert np.abs(a - b).max() <= rel * scale, (name, np.abs(a - b).max(), scale)


def _rand_pose(rng, rot=0.3, trans=1.0) -> np.ndarray:
    w = rng.normal(0, rot, 3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, rng.normal(0, trans, 3)
    return T


@pytest.mark.parametrize("seed", [0, 1])
def test_imu_ops_match_jax(seed):
    """preintegrate (zero-dt rows and pads skipped), bias_corrected,
    predict and combined_residual against the JAX module within 1e-5 of
    each quantity's scale; also an empty interval."""
    rng = np.random.default_rng(100 + seed)
    rows = _rows(seed)
    bias = rng.normal(0, 0.02, 6).astype(np.float32)
    pj = jimu.preintegrate(jnp.asarray(rows), jnp.asarray(bias), _jparams())
    pt = timu.preintegrate(rows, torch.from_numpy(bias), timu.ImuParams(**IMU_PRM))
    for name in jimu.PreintState._fields:
        _close(getattr(pt, name).numpy(), getattr(pj, name), name)
    bias_i = bias + rng.normal(0, 0.01, 6).astype(np.float32)
    for a, b, name in zip(
        timu.bias_corrected(pt, torch.from_numpy(bias_i), torch.from_numpy(bias)),
        jimu.bias_corrected(pj, jnp.asarray(bias_i), jnp.asarray(bias)), ("dR", "dv", "dp"),
    ):
        _close(a.numpy(), b, name)
    T_i, T_j = _rand_pose(rng), _rand_pose(rng)
    v_i, v_j = rng.normal(0, 1, 3).astype(np.float32), rng.normal(0, 1, 3).astype(np.float32)
    g = np.array([0.1, -0.2, -9.81], np.float32)
    Tp_t, vp_t = timu.predict(torch.from_numpy(T_i), torch.from_numpy(v_i), pt,
                              torch.from_numpy(bias_i), torch.from_numpy(bias), torch.from_numpy(g))
    Tp_j, vp_j = jimu.predict(jnp.asarray(T_i), jnp.asarray(v_i), pj, jnp.asarray(bias_i),
                              jnp.asarray(bias), jnp.asarray(g))
    _close(Tp_t.numpy(), Tp_j, "predict T")
    _close(vp_t.numpy(), vp_j, "predict v")
    # the residual at the predicted state and away from it
    for Tj, vj in ((np.asarray(Tp_j), np.asarray(vp_j)), (T_j, v_j)):
        rt = timu.combined_residual(
            torch.from_numpy(T_i), torch.from_numpy(v_i), torch.from_numpy(bias_i),
            torch.from_numpy(Tj), torch.from_numpy(vj), torch.from_numpy(bias_i + 1e-3), pt,
            torch.from_numpy(bias), torch.from_numpy(g), timu.ImuParams(**IMU_PRM),
        )
        rj = jimu.combined_residual(
            jnp.asarray(T_i), jnp.asarray(v_i), jnp.asarray(bias_i), jnp.asarray(Tj),
            jnp.asarray(vj), jnp.asarray(bias_i + 1e-3), pj, jnp.asarray(bias),
            jnp.asarray(g), _jparams(),
        )
        _close(rt.numpy(), rj, "combined_residual", rel=1e-4)
    empty = timu.preintegrate(np.zeros((64, 7), np.float32), torch.zeros(6), timu.ImuParams(**IMU_PRM))
    assert float(empty.dt) == 0.0 and torch.equal(empty.dR, torch.eye(3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inertial_jacobians_match_forward_mode(seed):
    """The analytic Jacobians of the 15-dof solve against
    torch.func.jacfwd (float64, a batch of one state): the
    CombinedImuFactor in [omega_b, rho_b, dv_j, db_j] (body pose perturbed
    on the right), the SO(3) and SE(3) right Jacobian inverses at angles
    on both sides of the series/closed-form switch, and Ad(T)."""
    from torch.func import jacfwd

    from vslam_torch.geometry import se3

    torch.set_default_dtype(torch.float64)
    try:
        rng = np.random.default_rng(200 + seed)
        d64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
        rows = _rows(seed).astype(np.float64)
        rows_t = d64(timu.active_rows(rows))
        bias_i = d64(rng.normal(0, 0.02, 6))
        pre = timu.preintegrate(rows_t, bias_i, timu.ImuParams(**IMU_PRM))
        T_i, T_j = d64(_rand_pose(rng)), d64(_rand_pose(rng, rot=0.5))
        v_i, v_j = d64(rng.normal(0, 1, 3)), d64(rng.normal(0, 1, 3))
        b_j, g = bias_i + 1e-3, d64([0.1, -0.2, -9.81])
        prm = timu.ImuParams(**IMU_PRM)
        r, J = timu.combined_residual_and_jacobian(T_i, v_i, bias_i, T_j, v_j, b_j, pre, bias_i, g, prm)

        def f(d):
            Tj = se3.retract(T_j[None], d[None, :6])
            return timu.combined_residual(T_i, v_i, bias_i, Tj, v_j[None] + d[None, 6:9],
                                          b_j[None] + d[None, 9:], pre, bias_i, g, prm)[0]

        np.testing.assert_allclose(r.numpy(), f(torch.zeros(15)).numpy(), rtol=1e-12, atol=1e-12)
        J_ad = jacfwd(f)(torch.zeros(15))
        np.testing.assert_allclose(J.numpy(), J_ad.numpy(), rtol=1e-6, atol=1e-6 * float(J_ad.abs().max()))
        # against the derivative of so3_logmap/se3_logmap as implemented,
        # at angles where its 1e-8 guard (scale theta / (|q_v| + 1e-8))
        # perturbs it by less than 1e-6; the SO(3) series runs below 0.5 rad
        for angle in (0.05, 0.3, 0.9, 2.0):
            phi = d64(rng.normal(0, 1, 3))
            phi = phi / torch.linalg.norm(phi) * angle
            Jso = jacfwd(lambda d: se3.so3_logmap(se3.so3_expmap(phi[None]) @ se3.so3_expmap(d[None]))[0])
            np.testing.assert_allclose(se3.so3_right_jacobian_inv(phi).numpy(),
                                       Jso(torch.zeros(3)).numpy(), atol=1e-6)
        for size in (0.03, 0.1):  # prior residuals: centimetres to decimetres
            xi = d64(rng.normal(0, size, 6))
            Jse = jacfwd(lambda d: se3.se3_logmap(se3.se3_expmap(xi[None]) @ se3.se3_expmap(d[None]))[0])
            np.testing.assert_allclose(se3.se3_right_jacobian_inv(xi).numpy(),
                                       Jse(torch.zeros(6)).numpy(), atol=1e-6)
        xi = d64(rng.normal(0, 0.3, 6))
        lhs = T_i @ se3.se3_expmap(xi) @ se3.inverse(T_i)
        # T_i's rotation is orthonormal to float32 precision only
        np.testing.assert_allclose(lhs.numpy(), se3.se3_expmap(se3.adjoint(T_i) @ xi).numpy(), atol=1e-6)
    finally:
        torch.set_default_dtype(torch.float32)


def test_imu_predict_matches_jax(scene):
    """The tracker's host-callable dead-reckoning step, with samples and
    without (the inputs come back unchanged)."""
    cfg = jtr.ImuConfig(**IMU_PRM, hz=200.0, T_bc=np.eye(4, dtype=np.float32),
                        gravity_w=synthetic.GRAVITY_W.astype(np.float32))
    rows = np.zeros((64, 7), np.float32)
    b = scene.bins[3]
    rows[: len(b), 0] = np.diff(np.concatenate([scene.bins[2][-1:, 0], b[:, 0]]))
    rows[: len(b), 1:] = b[:, 1:]
    assert len(b) >= 10
    T0 = scene.poses_c2w[2].astype(np.float32)
    v0 = scene.velocities[2].astype(np.float32)
    g = cfg.gravity_w
    Tj, vj = jtr._imu_predict(jnp.asarray(rows), jnp.asarray(T0), jnp.asarray(v0), jnp.zeros(6),
                              jnp.asarray(g), jnp.eye(4), _jparams())
    Tt, vt = ttr._imu_predict(rows, torch.from_numpy(T0), torch.from_numpy(v0), torch.zeros(6),
                              torch.from_numpy(g), torch.eye(4), timu.ImuParams(**IMU_PRM))
    _close(Tt.numpy(), Tj, "T")
    _close(vt.numpy(), vj, "v")
    assert np.abs(Tt.numpy() - scene.poses_c2w[3]).max() < 1e-3  # exact IMU, exact GT
    T_same, v_same = ttr._imu_predict(np.zeros((64, 7), np.float32), torch.from_numpy(T0),
                                      torch.from_numpy(v0), torch.zeros(6), torch.from_numpy(g),
                                      torch.eye(4), timu.ImuParams(**IMU_PRM))
    assert torch.equal(T_same, torch.from_numpy(T0)) and torch.equal(v_same, torch.from_numpy(v0))


def test_motion_only_ba_imu_matches_jax():
    """The 15-dof solve on a seeded problem (a rotated pose, 30 gross
    outliers, stereo, mono and right-camera rows, invalid rows): the pose
    within 1e-5, velocity and bias within 1e-5 of their scale, identical
    inlier and stereo masks, the same final cost within 1e-5."""
    rng = np.random.default_rng(7)
    M = 400
    K = np.array([[FX, 0, W / 2.0], [0, FX, H / 2.0], [0, 0, 1]], np.float32)
    rows = _rows(3, k=10)
    bias = rng.normal(0, 0.01, 6).astype(np.float32)
    T_bc = _rand_pose(rng, rot=0.05, trans=0.05)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    T_prev_wb = _rand_pose(rng, rot=0.2, trans=0.5)
    v_prev = rng.normal(0, 1, 3).astype(np.float32)
    # the true camera pose is the IMU prediction, so both factor sets agree
    Tw, vw = jimu.predict(jnp.asarray(T_prev_wb), jnp.asarray(v_prev),
                          jimu.preintegrate(jnp.asarray(rows), jnp.asarray(bias), _jparams()),
                          jnp.asarray(bias), jnp.asarray(bias), jnp.asarray(g))
    T_true = (np.asarray(Tw) @ T_bc).astype(np.float32)
    pc = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(2, 25, M)], 1)
    pts = (pc @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    u = FX * pc[:, 0] / pc[:, 2] + W / 2.0
    v = FX * pc[:, 1] / pc[:, 2] + H / 2.0
    ur = FX * (pc[:, 0] - BL) / pc[:, 2] + W / 2.0
    obs = (np.stack([u, v, ur], 1) + rng.normal(0, 0.6, (M, 3))).astype(np.float32)
    obs[:30] += rng.normal(0, 40, (30, 3)).astype(np.float32)
    is_right = np.zeros(M, bool)
    is_right[300:320] = True
    obs[300:320, 0] = ur[300:320] + rng.normal(0, 0.6, 20)
    stereo = (pc[:, 2] < 10) & ~is_right
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, M)).astype(np.float32)
    valid = rng.uniform(size=M) < 0.92
    T_init = T_true.copy()
    T_init[:3, 3] += [0.03, -0.02, 0.04]
    v_init = np.asarray(vw) + 0.02
    pj = jimu.preintegrate(jnp.asarray(rows), jnp.asarray(bias), _jparams())
    args = (T_init, v_init, bias, T_prev_wb, v_prev)
    vis = (pts, obs, inv_s2, stereo, is_right, valid, K, np.float32(BL))
    oj = jax.jit(lambda a, pre, gg, Tbc, v_: jlm.motion_only_ba_imu(*a, pre, gg, _jparams(), Tbc, *v_))(
        tuple(jnp.asarray(x) for x in args), pj, jnp.asarray(g), jnp.asarray(T_bc),
        tuple(jnp.asarray(x) for x in vis),
    )
    pt = timu.preintegrate(rows, torch.from_numpy(bias), timu.ImuParams(**IMU_PRM))
    ot = tlm.motion_only_ba_imu(
        *(torch.from_numpy(np.asarray(x)) for x in args), pt, torch.from_numpy(g),
        timu.ImuParams(**IMU_PRM), torch.from_numpy(T_bc),
        *(torch.from_numpy(np.asarray(x)) for x in vis),
    )
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-5, rtol=0)
    _close(ot[1].numpy(), oj[1], "v")
    _close(ot[2].numpy(), oj[2], "bias", rel=1e-4)
    np.testing.assert_array_equal(ot[4].numpy(), np.asarray(oj[4]))  # inliers
    np.testing.assert_array_equal(ot[5].numpy(), np.asarray(oj[5]))  # stereo after demotion
    # the final costs agree; the iteration counts need not: here JAX's
    # second step passes the 1e-5 relative-decrease test and the port's
    # misses it by float noise, so the port stops only once lambda has
    # climbed past 1e6 through rejected steps, at the same pose
    assert abs(float(ot[6].error[0]) - float(oj[6].error)) <= 1e-5 * float(oj[6].error)
    assert 200 < ot[4].numpy().sum() < valid.sum() - 20  # the outliers are out


def _imu_cfg(cls):
    return cls(**IMU_PRM, hz=200.0, T_bc=np.eye(4, dtype=np.float32),
               gravity_w=synthetic.GRAVITY_W.astype(np.float32))


def test_track_step_from_converted_imu_state(scene):
    """JAX tracks frames 0-1 with an IMU config; its map, tracker state and
    IMU constants cross over through convert.py; one IMU frame then agrees:
    pose within 1e-5, velocity and bias within 1e-5 of their scale, the
    same counts, identical match and inlier masks."""
    world = jms.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
    jt = jtr.StereoTracker(scene.K.astype(np.float32), BL, W, H, world,
                           jtr.TrackerParams(**PARAMS), imu_cfg=_imu_cfg(jtr.ImuConfig))
    jt.velocity = scene.velocities[0].astype(np.float32)
    rows, last = [], None
    for f in range(3):  # [dt, gyro, accel] rows as the facade cuts them
        b = scene.bins[f].astype(np.float64)
        if not len(b):
            rows.append(None)
            continue
        prev = last if last is not None else b[0, 0] - 1 / 200.0
        dts = np.maximum(np.diff(np.concatenate([[prev], b[:, 0]])), 0.0)
        rows.append(np.concatenate([dts[:, None], b[:, 1:]], 1).astype(np.float32))
        last = b[-1, 0]
    jt.track(*scene.frames[0], imu=rows[0])
    jt.track(*scene.frames[1], imu=rows[1])
    state_np = jax.tree.map(np.asarray, jt._state)
    host_np = {"active_ids": jt.active_ids, "miss_age": jt.miss_age,
               "frame_records": jt.frame_records, "new_kf_slots": jt.new_kf_slots}
    state_t, _ = convert.tracker_state_from_jax(state_np, host_np, "cpu")
    imu_t = convert.imu_const_from_jax(jax.tree.map(np.asarray, jt._imu_const), "cpu")
    np.testing.assert_array_equal(state_t["vel"].numpy(), np.asarray(jt._state["vel"]))
    samples = np.zeros((64, 7), np.float32)
    samples[: len(rows[2])] = rows[2]
    LR = np.stack(scene.frames[2])
    p = jt.params
    _, jo = jtr._track_step(
        jnp.asarray(LR), jt._state, jnp.asarray(samples), jt._imu_const, jt._radii,
        jnp.float32(p.refine_radius), jnp.float32(jt._desc_thr), jnp.float32(jt._ratio),
        jt.K, jt.baseline, jt.scale_factors, jt._static, jt.width, jt.height,
        p.n_levels, p.min_inliers, has_imu=True,
    )
    tt = ttr.StereoTracker(scene.K.astype(np.float32), BL, W, H,
                           tms.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512, device="cpu"),
                           ttr.TrackerParams(**PARAMS), imu_cfg=_imu_cfg(ttr.ImuConfig), device="cpu")
    _, to = ttr._track_step(
        torch.from_numpy(LR), state_t, tt._radii, tt.params.refine_radius, tt._desc_thr,
        tt._ratio, tt.K, tt.baseline, tt.scale_factors, tt.params, W, H,
        imu=(samples, *imu_t),
    )
    jb, tb = np.asarray(jo["blob"]), to["blob"].numpy()
    np.testing.assert_allclose(tb[:16], jb[:16], atol=1e-5, rtol=0)  # pose
    _close(tb[16:19], jb[16:19], "vel")
    _close(tb[19:25], jb[19:25], "bias", rel=1e-4)
    np.testing.assert_array_equal(tb[25:29], jb[25:29])  # match/inlier/key counts
    # the stereo-matched key count may differ by a key or two inside JAX's
    # fused frame program (see test_torch_tracker.py)
    assert abs(tb[29] - jb[29]) <= 0.01 * jb[29]
    np.testing.assert_array_equal(tb[33:], jb[33:])  # lost flag, miss ages
    assert jb[26] >= 50
    for name in ("midx", "inliers", "midx_r", "st_flags", "in_frame"):
        np.testing.assert_array_equal(to[name].numpy(), np.asarray(jo[name]), err_msg=name)


def _imu_run(sys_, scene, n):
    """tests/test_system.py:210-229: gravity overridden with the scene's
    (the synthetic body frame is not EuRoC-mounted), initial velocity from
    the scene, absolute-time IMU rows per frame."""
    sys_._gravity_set = True
    sys_.tracker.set_gravity(synthetic.GRAVITY_W.astype(np.float32))
    sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
    for f in range(n):
        sys_.track_stereo(*scene.frames[f], imu=scene.bins[f])
    sys_.exit()
    return sys_.trajectory()


def test_stereo_imu_system_matches_jax(scene, tmp_path_factory):
    """The STEREO_IMU facade (sync mapper) end to end: the same keyframes
    at the same frames, the same BA count, poses within 1e-3, both ATEs
    under test_system.py's 0.08 m gate."""
    js = jsys.VSlamSystem(_jax_config(tmp_path_factory), **CAPS, tracker_params=jtr.TrackerParams(**PARAMS))
    ts = tsys.VSlamSystem(TConfig.from_dict(_config()), **CAPS,
                          tracker_params=ttr.TrackerParams(**PARAMS), device="cpu")
    assert ts.mode == tsys.SlamMode.STEREO_IMU and ts.tracker.imu_cfg is not None
    jp, tp = _imu_run(js, scene, N_FRAMES), _imu_run(ts, scene, N_FRAMES)
    assert ts.tracker.new_kf_slots == js.tracker.new_kf_slots and len(js.tracker.new_kf_slots) >= 2
    n = js.world.n_keyframes
    np.testing.assert_array_equal(ts.world.kf_frame_idx[:n], js.world.kf_frame_idx[:n])
    assert ts.mapper.ba_count == js.mapper.ba_count >= 1
    assert tp.shape == jp.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=0)
    gt = scene.poses_c2w[:N_FRAMES]
    ate_j = jtraj.ate_rmse(jp, gt, align=False)
    ate_t = ttraj.ate_rmse(tp, gt, align=False)
    assert ate_j < 0.08 and ate_t < 0.08, (ate_j, ate_t)
    np.testing.assert_allclose(ts.tracker.velocity, js.tracker.velocity, atol=1e-3)


def test_stereo_imu_gravity_init_mechanism(scene):
    """One-time gravity init from the first accel sample with the
    reference's EuRoC-mounting axis permutation {a_y, -a_x, a_z}
    (src/VIOSlam.cpp:274), on the first non-empty batch only; then the
    dt rows (first-sample 1/Hz fallback) as the JAX facade cuts them."""
    ts = tsys.VSlamSystem(TConfig.from_dict(_config()), **CAPS,
                          tracker_params=ttr.TrackerParams(**PARAMS), device="cpu")
    assert len(scene.bins[0]) == 0  # frame 0 has no preceding interval
    ts.track_stereo(*scene.frames[0], imu=scene.bins[0])
    assert not ts._gravity_set
    ts.track_stereo(*scene.frames[1], imu=scene.bins[1])
    a = scene.bins[1][0, 4:7]
    assert ts._gravity_set
    np.testing.assert_allclose(ts.tracker.imu_cfg.gravity_w, np.array([a[1], -a[0], a[2]], np.float32), atol=1e-6)
    np.testing.assert_allclose(ts.tracker._imu_const[0].numpy(), ts.tracker.imu_cfg.gravity_w)
    ts.tracker.set_gravity(np.array([0.0, 0.0, -9.81]))
    ts.track_stereo(*scene.frames[2], imu=scene.bins[2])  # a later batch must not re-init
    np.testing.assert_allclose(ts.tracker.imu_cfg.gravity_w, [0.0, 0.0, -9.81], atol=1e-6)
    ts.exit()
    # the dt rows against the JAX facade's cut (no device work)
    conf = dict(_config(), IMU=dict(_config()["IMU"], gravity=[0.0, 0.0, -9.81]))
    ts2 = tsys.VSlamSystem(TConfig.from_dict(conf), **CAPS, tracker_params=ttr.TrackerParams(**PARAMS), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "c.yaml")
        with open(path, "w") as f:
            f.write(yaml.safe_dump(conf))
        js = jsys.VSlamSystem(JConfig(path), **CAPS, tracker_params=jtr.TrackerParams(**PARAMS))
    assert ts2._gravity_set and js._gravity_set  # the config's gravity override
    for f in (1, 2, 3):
        np.testing.assert_array_equal(ts2._imu_to_dt_rows(scene.bins[f]), js._imu_to_dt_rows(scene.bins[f]))
    assert ts2._imu_to_dt_rows(scene.bins[0]) is None


def test_imu_binning_matches_jax(scene):
    bj = jds.bin_imu_per_frame(scene.imu, scene.times)
    bt = tds.bin_imu_per_frame(scene.imu, scene.times)
    assert len(bt) == len(bj) == len(scene.times)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a, b)
    assert sum(len(b) for b in bt[1:]) > 100
    np.testing.assert_array_equal(tds.gravity_from_first_accel(scene.imu), jds.gravity_from_first_accel(scene.imu))
