"""Parity of the port's loop closure (vslam_torch/models/loop_closure.py)
against vslam_tpu's on the CPU: the split-map worlds of
tests/test_loop_closure.py:276-456 (stereo, and mono with a similarity
drift through the Sim(3) graph) built by both packages and closed by both
closers; the map write-back on a map whose merged ids share targets; and,
slow-marked, the live circuit of tests/test_loop_closure.py:458-590
through the port's facade."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_loop_closure import _split_map_world
from vslam_torch.models import convert, loop_closure as tlc
from vslam_torch.utils import synthetic as tsyn
from vslam_tpu.models import loop_closure as jlc

torch.set_num_threads(2)  # xdist runs several workers on one box

CASES = {"stereo": (1.0, 0.12), "mono": (0.9, 0.0)}  # scale_err, baseline
INT_FIELDS = ("lm_desc", "lm_valid", "lm_bitsum", "lm_nobs", "kf_valid", "obs_oct",
              "obs_stereo", "obs_lm", "obs_desc", "obs_valid", "obs_r_oct", "obs_r_lm")


def _worlds(case):
    scale_err, _ = CASES[case]
    jw, true_poses, T_err, K = _split_map_world(scale_err=scale_err)
    if case == "mono":  # as the JAX mono test: no right-camera rows
        jw.arrays = dataclasses.replace(jw.arrays, obs_r_lm=jnp.full_like(jw.arrays.obs_r_lm, -1))
        jw.kf_obs_r_lm[:] = -1
    tw, true_t, T_err_t, K_t = tsyn.split_map_world(scale_err=scale_err, device="cpu")
    np.testing.assert_array_equal(true_t, true_poses)
    np.testing.assert_allclose(T_err_t, T_err, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(K_t, K)
    return jw, tw, true_poses, K


def _assert_maps(jw, tw, pos_tol):
    """Integer and boolean arrays and host tables identical; positions and
    poses within pos_tol."""
    cw = convert.world_from_jax(jw, "cpu")
    for name in INT_FIELDS:
        assert torch.equal(getattr(tw.arrays, name), getattr(cw.arrays, name)), name
    for name in ("lm_pos", "kf_pose", "obs_uv"):
        np.testing.assert_allclose(getattr(tw.arrays, name).numpy(), getattr(cw.arrays, name).numpy(),
                                   atol=pos_tol, rtol=0, err_msg=name)
    for name in ("kf_obs_lm", "kf_obs_r_lm", "kf_frame_idx"):
        np.testing.assert_array_equal(getattr(tw, name), getattr(cw, name), err_msg=name)
    np.testing.assert_allclose(tw.kf_poses_host, cw.kf_poses_host, atol=pos_tol, rtol=0)
    assert (tw.n_keyframes, tw.n_landmarks) == (cw.n_keyframes, cw.n_landmarks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_map_world_equals_jax(case):
    """The port's numpy copy (utils/synthetic.split_map_world, which
    chip_smoke.py uses) builds the JAX test's world: identical tables,
    positions within 1e-6 (the drift T_err comes from each package's
    float32 se3_expmap)."""
    jw, tw, _, _ = _worlds(case)
    _assert_maps(jw, tw, 1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_map_closure_matches_jax(case):
    """Both closers on the same world: the first try_close arms the same
    candidate, the second applies a closure with the same old keyframe,
    the same merge pairs and n_merged, the same persisted edge; after the
    write-back the observation tables, validity and descriptor sums are
    identical and poses and landmarks agree within 2e-5 m (stereo: the
    dense SE(3) graph; mono: the Sim(3) chain, whose Umeyama fit and 30
    GN steps sum in another order). The port meets the JAX test's
    requirements (tests/test_loop_closure.py:374-456)."""
    jw, tw, true_poses, K = _worlds(case)
    baseline = CASES[case][1]
    n = jw.n_keyframes
    jc = jlc.LoopCloser(jw, K, baseline, min_gap=3)
    tc = tlc.LoopCloser(tw, K, baseline, min_gap=3)
    assert jc.try_close(n - 2) is None and tc.try_close(n - 2) is None
    assert tc._last_cand == jc._last_cand and tc._last_cand is not None
    old_kf = jc._last_cand[1]
    assert tc._merge_pairs(n - 1, old_kf) == jc._merge_pairs(n - 1, old_kf)
    pre_err = np.linalg.norm(tw.kf_poses_host[n - 1][:3, 3] - true_poses[n - 1][:3, 3])
    rj, rt = jc.try_close(n - 1), tc.try_close(n - 1)
    assert rt is not None and rj is not None
    assert rt["path"] == ("sim3" if case == "mono" else "dense")
    for k in ("kf_slot", "old_kf", "n_merged"):
        assert rt[k] == rj[k], k
    assert abs(rt["pose_graph_error"] - rj["pose_graph_error"]) <= 1e-4 * rj["pose_graph_error"]
    np.testing.assert_allclose(rt["new_pose"], rj["new_pose"], atol=2e-5, rtol=0)
    assert [e[:2] for e in tc._edges] == [e[:2] for e in jc._edges]
    np.testing.assert_allclose(tc._edges[0][2], jc._edges[0][2], atol=2e-5, rtol=0)
    assert (tc.closures, tc._cooldown_until, tc._last_cand) == (jc.closures, jc._cooldown_until, jc._last_cand)
    _assert_maps(jw, tw, 2e-5 if case == "stereo" else 1e-4)

    assert rt["old_kf"] < n // 2 and rt["n_merged"] > 100
    post_err = np.linalg.norm(tw.kf_poses_host[n - 1][:3, 3] - true_poses[n - 1][:3, 3])
    assert post_err < 0.4 * pre_err, (pre_err, post_err)
    live = tw.kf_obs_lm[:n][tw.kf_obs_lm[:n] >= 0]
    assert tw.arrays.lm_valid.numpy()[live].all()


def test_apply_correction_folds_merges_as_jax():
    """The write-back alone, on a random map whose merged ids share
    targets and carry descriptor sums: every field as JAX's
    _apply_correction writes it (integers identical, positions within
    1e-6), out-of-range keyframe rows (Wg > W) masked as JAX drops them."""
    rng = np.random.default_rng(4)
    P, W, K, Kr, Wg = 64, 6, 10, 3, 8
    arrays = {
        "lm_pos": rng.normal(0, 3, (P, 3)).astype(np.float32),
        "lm_desc": (rng.integers(0, 2, (P, 256)) * 2 - 1).astype(np.int8),
        "lm_maxdist": rng.uniform(1, 2, P).astype(np.float32),
        "lm_mindist": rng.uniform(0, 1, P).astype(np.float32),
        "lm_valid": rng.uniform(size=P) < 0.9,
        "lm_bitsum": rng.integers(-3, 4, (P, 256)).astype(np.int16),
        "lm_nobs": rng.integers(1, 5, P).astype(np.int16),
        "kf_pose": np.tile(np.eye(4, dtype=np.float32), (W, 1, 1)),
        "kf_valid": np.ones(W, bool),
        "obs_uv": rng.uniform(0, 300, (W, K, 3)).astype(np.float32),
        "obs_oct": np.zeros((W, K), np.int32),
        "obs_stereo": np.ones((W, K), bool),
        "obs_lm": rng.integers(-1, P, (W, K)).astype(np.int32),
        "obs_desc": rng.integers(0, 2**32, (W, K, 8), dtype=np.uint64).astype(np.uint32),
        "obs_valid": np.ones((W, K), bool),
        "obs_r_uv": np.zeros((W, Kr, 2), np.float32),
        "obs_r_oct": np.zeros((W, Kr), np.int32),
        "obs_r_lm": rng.integers(-1, P, (W, Kr)).astype(np.int32),
    }
    remap = np.arange(P)
    merged = np.zeros(P, bool)
    for new_id, old_id in ((40, 3), (41, 3), (42, 3), (50, 7), (51, 8), (60, 8)):
        remap[new_id], merged[new_id] = old_id, True
    T = np.stack([np.eye(4, dtype=np.float32)] * Wg)
    T[:, :3, 3] = rng.normal(0, 0.1, (Wg, 3))
    delta = T.copy()
    delta[:, :3, :3] *= 1.05  # a Sim(3)-like delta
    kf_valid = np.arange(Wg) < 5
    anchor = rng.integers(0, 5, P)
    touch = rng.uniform(size=P) < 0.7
    args = (T, kf_valid, delta, anchor, touch, remap, merged)

    from vslam_tpu.models import map_state as jms

    jm = jms.MapArrays(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jm = jlc._apply_correction(jm, *(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in args))
    tm = convert.map_arrays_from_jax(arrays, "cpu")
    tlc._apply_correction(tm, *(torch.from_numpy(a) for a in args))
    ref = convert.map_arrays_from_jax({k: np.asarray(getattr(jm, k)) for k in arrays}, "cpu")
    for k in arrays:
        a, b = getattr(tm, k), getattr(ref, k)
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0, err_msg=k)
        else:
            assert torch.equal(a, b), k


@pytest.mark.slow
def test_live_circuit_loop_closure(tmp_path):
    """tests/test_loop_closure.py:458-590 through the port on the CPU: the
    bench's loop circuit (512x384, 360 frames, 1.2 laps, 1024 features,
    active set 1024, async BA with deterministic latency, loop closure on);
    the same assertions: a closure at the real revisit that moved the
    revisit keyframe toward the truth, an automatic polish that helped (or
    a final ATE < 0.05 m), ATE < 0.06 m, and after global_ba() ATE <
    max(1.1 x live, 0.05) m."""
    from vslam_torch.models import system as system_mod, tracker as tracker_mod
    from vslam_torch.utils import trajectory
    from vslam_torch.utils.config import ConfigFile

    W, H = 512, 384
    n = 360
    scene = tsyn.make_loop_scene(n_frames=n, width=W, height=H, loops=1.2)
    cfg = pathlib.Path(tmp_path) / "c.yaml"
    cfg.write_text(f"""rectified: true
slamMode: 1
dataset: "KITTI"
imagesPath: "/nonexistent"
fileExtension: ".png"
Camera: {{width: {W}, height: {H}, fps: 10.0, bl: 0.12}}
Camera_l: {{fx: 460.0, fy: 460.0, cx: {W/2}, cy: {H/2}}}
Camera_r: {{fx: 460.0, fy: 460.0, cx: {W/2}, cy: {H/2}}}
FE: {{nFeatures: 1024, nLevels: 8, imScale: 1.2, edgeThreshold: 19, maxFastThreshold: 20, minFastThreshold: 7}}
""")
    sys_ = system_mod.VSlamSystem(
        ConfigFile(str(cfg)), async_ba=True, lm_capacity=1 << 15, kf_capacity=256, loop_closure=True,
        tracker_params=tracker_mod.TrackerParams(n_features=1024, n_levels=8, active_size=1024),
        device="cpu",
    )
    sys_.deterministic_ba_latency = True
    events = []
    orig_close = sys_.loop_closer.close

    def close_spy(kf_slot, old_kf, T_loop):
        r = orig_close(kf_slot, old_kf, T_loop)
        if r is not None:
            events.append(dict(r))
        return r

    sys_.loop_closer.close = close_spy
    w = sys_.world

    def kf_ate():
        nk = w.n_keyframes
        fr = w.kf_frame_idx[:nk].astype(int)
        return float(np.sqrt(((w.kf_poses_host[:nk, :3, 3] - scene.poses_c2w[fr][:, :3, 3]) ** 2).sum(1).mean()))

    polish_deltas = []
    orig_global = sys_.mapper.run_global

    def global_spy(*a, **k):
        pre = kf_ate()
        r = orig_global(*a, **k)
        if r is not None:
            polish_deltas.append((pre, kf_ate()))
        return r

    sys_.mapper.run_global = global_spy
    for f in range(n):
        sys_.track_stereo(scene.render(f), scene.render(f, right=True))
    sys_.exit()

    assert sys_.loop_closer.closures >= 1, "no closure fired on a full circuit"
    ev = events[0]
    lap = int(n / 1.2)
    new_frame = int(w.kf_frame_idx[ev["kf_slot"]])
    old_frame = int(w.kf_frame_idx[ev["old_kf"]])
    assert new_frame > lap - 40, (new_frame, lap)
    assert old_frame < lap // 3, (old_frame, lap)
    assert ev["n_merged"] > 0
    gt_t = scene.poses_c2w[new_frame][:3, 3]
    pre = np.linalg.norm(ev["old_pose"][:3, 3] - gt_t)
    post = np.linalg.norm(ev["new_pose"][:3, 3] - gt_t)
    assert post < pre, (pre, post)
    assert polish_deltas, "closure applied but no automatic polish ran"
    poses = sys_.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    assert any(b < a for a, b in polish_deltas) or ate < 0.05, (polish_deltas, ate)
    assert ate < 0.06, ate
    assert sys_.global_ba() is not None
    poses2 = sys_.trajectory()
    ate2 = trajectory.ate_rmse(poses2, scene.poses_c2w[: len(poses2)], align=False)
    assert ate2 < max(1.1 * ate, 0.05), (ate, ate2)
