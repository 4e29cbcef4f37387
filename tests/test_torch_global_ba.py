"""Global BA in the port against vslam_tpu on the CPU: the slab-chunked
Schur reduction (``n_slabs``) on tests/test_ba.py's window, and
``LocalMapper.run_global`` on tests/test_ba.py's corridor map (16
keyframes, 3000 landmarks, 1024 keys each; the port builds it with its own
numpy copy, ``vslam_torch.utils.synthetic.corridor_map``), whole and in
slabs, with its landmark truncation; then ``VSlamSystem.global_ba`` after a
short stereo run."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_torch.models import local_mapper as tlm, system as tsys, tracker as ttr
from vslam_torch.ops import schur as tsch
from vslam_torch.utils import synthetic as tsyn, trajectory as ttraj
from vslam_torch.utils.config import ConfigFile as TConfig
from vslam_tpu.models import local_mapper as jlm, map_state as jms
from vslam_tpu.ops import schur as jsch
from vslam_tpu.utils import synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[460.0, 0, 320.0], [0, 460.0, 240.0], [0, 0, 1.0]], np.float32)
BASELINE = 0.12
N_KF, N_LM = 16, 3000
# the parity runs take tests/test_ba.py:294's 1 + 1 iterations: the
# smooth drift lies in the gauge near-null space (test_ba.py:269-275), and
# past the second iteration f32 sum order moves the poses of both packages
# by ~1e-4 (after 3 iterations each is 6-8e-5 from a float64 solve of the
# same problem, 1.4e-4 from the other); test_ba.py:261's 3 + 5 schedule is
# held on the port alone, to what the map-scale test asks of JAX
ITERS = dict(iters_round1=1, iters_round2=1)
FULL_ITERS = dict(iters_round1=3, iters_round2=5)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problem():
    """tests/test_ba.py:138's window (W=6, L=96, seed 2) as numpy, from
    tests/test_torch_ba.py's copy of its builder."""
    p = _load("test_torch_ba")._build_problem(W=6, L=96, seed=2)[0]
    return {k: np.asarray(v) for k, v in p._asdict().items()}


def test_slabbed_schur_matches_unslabbed_and_jax(problem):
    """local_ba with n_slabs=4 against n_slabs=1 and against the JAX
    package's n_slabs=4: poses within 5e-4, points within 5e-3, errors
    within 1e-3 relative (tests/test_ba.py:141-147's tolerances); the
    2-round schedule slabbed against unslabbed the same way, with the same
    kill mask."""
    from vslam_torch.models import convert

    tp = convert.ba_problem_from_jax(problem, "cpu")
    jp = jsch.BAProblem(**{k: jnp.asarray(v) for k, v in problem.items()})
    a, err_a, _ = tsch.local_ba(tp, iters=6)
    b, err_b, _ = tsch.local_ba(tp, iters=6, n_slabs=4)
    jb, err_jb, _ = jsch.local_ba(jp, iters=6, n_slabs=4)
    for other, err in ((a, err_a), (jb, err_jb)):
        np.testing.assert_allclose(b.poses.numpy(), np.asarray(other.poses), atol=5e-4, rtol=0)
        np.testing.assert_allclose(b.pts.numpy(), np.asarray(other.pts), atol=5e-3, rtol=0)
        assert abs(float(err) - float(err_b)) <= 1e-3 * max(float(err), 1.0)
    c, _, kill_c = tsch.local_ba_two_rounds(tp, n_slabs=4)
    d, _, kill_d = tsch.local_ba_two_rounds(tp)
    np.testing.assert_allclose(c.poses.numpy(), d.poses.numpy(), atol=5e-4, rtol=0)
    assert torch.equal(kill_c, kill_d)
    with pytest.raises(ValueError, match="divide"):
        tsch.local_ba(tp, iters=1, n_slabs=5)


def test_slab_blocks_equal_the_whole_problems(problem):
    """Each of 4 slabs scatters only the valid rows of its own landmarks,
    sorted by landmark in a stable order: its Hll, Hpl and gl blocks are
    exactly the whole problem's slice of them, invalid rows and all."""
    from vslam_torch.models import convert

    tp = convert.ba_problem_from_jax(problem, "cpu")
    valid = tp.obs_valid.clone()
    valid[::7] = False
    tp = tp._replace(obs_valid=valid)
    Hpp, gp, rows = tsch._linearize(tp)
    whole = tsch._slab_system(tp, rows, tsch._slabs(tp, 1)[0])
    slabs = tsch._slabs(tp, 4)
    assert sum(len(s.rows) for s in slabs) == int(valid.sum())
    for s in slabs:
        assert bool((tp.obs_lm[s.rows] // s.n == s.off // s.n).all())
        cut = slice(s.off, s.off + s.n)
        Hll, Hpl, gl = tsch._slab_system(tp, rows, s)
        assert torch.equal(Hll, whole[0][cut]) and torch.equal(gl, whole[2][cut])
        assert torch.equal(Hpl, whole[1][:, cut])


def test_corridor_map_is_test_ba_world():
    """The port's corridor_map is tests/test_ba.py's _build_world_at_scale
    bit for bit."""
    jw, poses, pts = _load("test_ba")._build_world_at_scale(N_KF, N_LM, keys_per_kf=1024)
    c = tsyn.corridor_map(N_KF, N_LM, 1024)
    for name in ("obs_uv", "obs_lm", "obs_valid", "obs_stereo", "obs_oct"):
        np.testing.assert_array_equal(c[name], np.asarray(getattr(jw.arrays, name)), err_msg=name)
    np.testing.assert_array_equal(c["poses"], poses)
    np.testing.assert_array_equal(c["pts"], pts)
    assert c["lm_capacity"] == jw.lm_capacity
    np.testing.assert_array_equal(jw.kf_obs_lm, c["obs_lm"])


def _worlds():
    """The corridor world in both packages, its poses perturbed by the
    smooth accumulated drift of tests/test_ba.py:248-256."""
    tw, c = tsyn.corridor_world(N_KF, N_LM, 1024, device="cpu")
    rng = np.random.default_rng(1)
    drift = np.cumsum(rng.normal(0, 0.004, (N_KF, 3)), axis=0).astype(np.float32)
    drift[0] = 0.0
    pert = c["poses"].copy()
    pert[:, :3, 3] += drift
    tw.arrays.kf_pose.copy_(torch.from_numpy(pert))
    tw.kf_poses_host[:] = pert
    jw = jms.WorldMap(lm_capacity=c["lm_capacity"], kf_capacity=N_KF, keys_per_kf=1024, right_obs_per_kf=8)
    fresh = jw.arrays
    jw.arrays = jms.MapArrays(**{
        f.name: jnp.asarray(getattr(tw.arrays, f.name).numpy().astype(getattr(fresh, f.name).dtype))
        for f in dataclasses.fields(fresh)
    })
    for k in ("kf_obs_lm", "kf_obs_r_lm", "kf_frame_idx", "kf_poses_host"):
        setattr(jw, k, getattr(tw, k).copy())
    jw.n_keyframes, jw.n_landmarks = N_KF, N_LM
    return jw, tw, c, pert


def _mappers(jw, tw, slab_bytes=None):
    jm = jlm.LocalMapper(jw, K, BASELINE, jlm.LocalMapperConfig(**ITERS))
    tm = tlm.LocalMapper(tw, K, BASELINE, tlm.LocalMapperConfig(**ITERS))
    if slab_bytes is not None:
        jm.GLOBAL_SLAB_BYTES = tm.GLOBAL_SLAB_BYTES = slab_bytes
    return jm, tm


@pytest.mark.parametrize("slab_bytes", [None, 1 << 20])
def test_run_global_matches_jax(slab_bytes, capsys):
    """run_global on the converted corridor map, whole and (with a 1 MiB
    slab budget) in 4 landmark slabs in both packages: every keyframe pose
    within 1e-4 m and 1e-4 (rotation entries) of JAX's, keyframe 0 fixed,
    the same window, kills and error within 1e-3 relative; refined
    relative poses better than the perturbed ones."""
    jw, tw, c, pert = _worlds()
    jm, tm = _mappers(jw, tw, slab_bytes)
    rj, rt = jm.run_global(), tm.run_global()
    out = capsys.readouterr().out
    slabs = 4 if slab_bytes else 1
    assert tm.counters.get("global_ba_slabs") == slabs
    assert ("chunked over 4 landmark slabs" in out) == bool(slab_bytes)
    assert rt["window"] == rj["window"] == list(range(N_KF)) and rt["kf_slot"] == N_KF - 1
    assert rt["n_killed"] == rj["n_killed"]
    assert abs(rt["error"] - rj["error"]) <= 1e-3 * max(rj["error"], 1.0)
    pj, pt = jw.kf_poses_host[:N_KF], tw.kf_poses_host[:N_KF]
    np.testing.assert_array_equal(pt[0], pert[0])
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=1e-4, rtol=0)
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tw.arrays.kf_pose.numpy()[:N_KF], pt, atol=1e-6, rtol=0)

    def rel_err(ps):
        d = np.linalg.inv(ps[:-5]) @ ps[5:]
        dg = np.linalg.inv(c["poses"][:-5]) @ c["poses"][5:]
        return np.mean(np.linalg.norm(d[:, :3, 3] - dg[:, :3, 3], axis=1))

    assert rel_err(pt) < rel_err(pert)


@pytest.mark.parametrize("slab_bytes", [None, 1 << 20])
def test_run_global_full_schedule_refines_the_map(slab_bytes):
    """The port alone at tests/test_ba.py:261's 3 + 5 iterations, whole
    and in 4 slabs: error under 0.01 px^2 per observation (test_ba.py:276)
    and a better mean 5-keyframe relative error than the perturbed map
    (test_ba.py's 0.7x factor is a map-scale figure: chip_smoke.py holds
    the 256-keyframe map to it; this 16-keyframe map gets 0.77x), the two
    slab counts within 5e-4 m."""
    _, tw, c, pert = _worlds()
    tm = tlm.LocalMapper(tw, K, BASELINE, tlm.LocalMapperConfig(**FULL_ITERS))
    if slab_bytes:
        tm.GLOBAL_SLAB_BYTES = slab_bytes
    r = tm.run_global()
    pt = tw.kf_poses_host[:N_KF]

    def rel_err(ps):
        d = np.linalg.inv(ps[:-5]) @ ps[5:]
        dg = np.linalg.inv(c["poses"][:-5]) @ c["poses"][5:]
        return np.mean(np.linalg.norm(d[:, :3, 3] - dg[:, :3, 3], axis=1))

    assert r["error"] < 0.01 * int((c["obs_lm"] >= 0).sum()), r["error"]
    assert rel_err(pt) < rel_err(pert), (rel_err(pt), rel_err(pert))
    assert tm.counters.get("lm_iters_round1") == 3
    if slab_bytes:
        _, tw1, _, _ = _worlds()
        tlm.LocalMapper(tw1, K, BASELINE, tlm.LocalMapperConfig(**FULL_ITERS)).run_global()
        np.testing.assert_allclose(pt[:, :3, 3], tw1.kf_poses_host[:N_KF, :3, 3], atol=5e-4, rtol=0)


def test_global_ba_truncation_is_logged_as_jax(capsys):
    """max_landmarks=1024 binds: the same warning line and the same
    truncation count as the JAX package (tests/test_ba.py:286-303), and
    the truncated solves agree within 1e-4 m."""
    jw, tw, c, _ = _worlds()
    jm, tm = _mappers(jw, tw)
    n_observed = len(np.unique(c["obs_lm"][c["obs_lm"] >= 0]))
    assert n_observed > 1024
    rj = jm.run_global(max_landmarks=1024)
    out_j = capsys.readouterr().out
    rt = tm.run_global(max_landmarks=1024)
    out_t = capsys.readouterr().out
    assert rj is not None and rt is not None
    assert "truncating" in out_t and out_t.strip() == out_j.strip()
    assert tm.counters.get("global_lm_truncated") == jm.counters.get("global_lm_truncated") == n_observed - 1024
    np.testing.assert_allclose(tw.kf_poses_host[:N_KF, :3, 3], jw.kf_poses_host[:N_KF, :3, 3], atol=1e-4, rtol=0)


def test_facade_global_ba_after_tracking():
    """VSlamSystem.global_ba after 8 stereo frames of the small system
    scene (tests/test_system.py's, on the CPU): one more BA over every
    keyframe with keyframe 0 fixed, the tracker re-anchored, tracking
    going on after it, and the trajectory still under 0.03 m ATE; fewer
    than 2 keyframes gives None."""
    scene = synthetic.make_scene(n_frames=10, n_points=400, width=320, height=240, fps=10.0, seed=7)
    cam = {"fx": 460.0, "fy": 460.0, "cx": 160.0, "cy": 120.0}
    conf = TConfig.from_dict({
        "rectified": True, "slamMode": 1, "Camera_l": cam, "Camera_r": cam,
        "Camera": {"width": 320, "height": 240, "fps": 10.0, "bl": 0.12},
        "FE": {"nFeatures": 512, "nLevels": 4, "imScale": 1.2},
    })
    params = ttr.TrackerParams(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60)
    sys_ = tsys.VSlamSystem(conf, lm_capacity=8192, kf_capacity=64, tracker_params=params, device="cpu")
    assert sys_.global_ba() is None  # no keyframe yet
    for f in range(8):
        sys_.track_stereo(scene.render(f), scene.render(f, right=True))
    n_ba = sys_.mapper.ba_count
    kf0 = sys_.world.kf_poses_host[0].copy()
    r = sys_.global_ba()
    n_kf = sys_.world.n_keyframes
    assert r is not None and r["window"] == list(range(n_kf)) and n_kf >= 2
    assert sys_.mapper.ba_count == n_ba + 1
    np.testing.assert_array_equal(sys_.world.kf_poses_host[0], kf0)
    np.testing.assert_allclose(r["new_pose"], sys_.world.kf_poses_host[n_kf - 1])
    for f in range(8, 10):
        sys_.track_stereo(scene.render(f), scene.render(f, right=True))
    sys_.exit()
    poses = sys_.trajectory()
    assert poses.shape == (10, 4, 4)
    assert ttraj.ate_rmse(poses, scene.poses_c2w[:10], align=False) < 0.03
