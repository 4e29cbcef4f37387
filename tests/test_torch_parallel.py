"""The port's sharded bundle adjustment (vslam_torch/parallel) against
vslam_tpu's on the CPU: the 2-round BA over an 8-shard CPU mesh against
JAX's sharded_two_rounds on the conftest's 8-device mesh and against the
port's single-device solve (tests/test_parallel.py's problems and
tolerances), the live-size smoke, the facade with shards=2 against the
unsharded one, the global BA taking the composed sharded + slabbed path,
and the batch driver."""

import numpy as np
import pytest
import torch

from tests.test_ba import _build_problem
from vslam_torch import run_batch, run_synthetic
from vslam_torch.geometry import se3 as tse3
from vslam_torch.models import convert, local_mapper as tlm, system as tsys, tracker as ttr
from vslam_torch.ops import schur as tsch
from vslam_torch.parallel import mesh as tmesh, sharded_ba as tsba
from vslam_torch.utils.config import ConfigFile
from vslam_tpu.parallel import mesh as jmesh, sharded_ba as jsba
from vslam_tpu.utils import synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

N_DEV = 8
POSE_LOG_TOL = 1e-3  # tests/test_parallel.py:40
GT_LOG_TOL = 2e-3  # :46
PT_TOL = 1e-3  # :48-50
ERR_REL = 1e-2  # :53
FACADE_TOL_M = 1e-3
N_FRAMES = 10


def _torch_problem(p) -> tsch.BAProblem:
    return convert.ba_problem_from_jax({k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")


def _pose_log(a, b) -> float:
    """max |log(a^-1 b)| over the poses."""
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return float(tse3.se3_logmap(torch.linalg.inv(a) @ b).abs().max())


def _agree(sol, ref):
    """tests/test_parallel.py:36-54's checks of one (p, err, kill) against
    another."""
    (ps, es, ks), (pr, er, kr) = sol, ref
    assert _pose_log(pr.poses, ps.poses) < POSE_LOG_TOL
    np.testing.assert_allclose(np.asarray(ps.pts), np.asarray(pr.pts), rtol=PT_TOL, atol=PT_TOL)
    np.testing.assert_array_equal(np.asarray(ks), np.asarray(kr))
    assert abs(float(es) - float(er)) <= ERR_REL * max(float(er), 1.0)


@pytest.mark.parametrize("seed, n_slabs", [(1, 1), (5, 4)], ids=["plain", "slabbed"])
def test_sharded_two_rounds_matches_jax_and_single_device(seed, n_slabs):
    """tests/test_parallel.py:27-54 (plain) and :91-118 (the composed
    sharded + slabbed path; L=128 over 4 slabs x 8 shards): the port's
    8-shard solve against JAX's 8-device one, the port's single-device
    solve (plain and, for the slabbed case, slabbed) and the ground truth."""
    p, poses_gt, _ = _build_problem(W=8, L=128, seed=seed)
    tp = _torch_problem(p)
    step = tsba.sharded_two_rounds(tmesh.make_mesh(N_DEV, device="cpu"),
                                   iters1=5, iters2=10, n_slabs=n_slabs)
    sharded = tsba.run_problem(step, tp)
    jstep = jsba.sharded_two_rounds(jmesh.make_mesh(N_DEV, axis=jsba.AXIS), iters1=5, iters2=10,
                                    n_slabs=n_slabs)
    _agree(sharded, jsba.run_problem(jstep, p))
    _agree(sharded, tsch.local_ba_two_rounds(tp, iters1=5, iters2=10))
    if n_slabs > 1:
        _agree(sharded, tsch.local_ba_two_rounds(tp, iters1=5, iters2=10, n_slabs=n_slabs))
    assert _pose_log(poses_gt, sharded[0].poses) < GT_LOG_TOL
    assert not np.asarray(sharded[2]).any()  # exact observations: none killed


def test_sharded_two_rounds_live_size_runs():
    """tests/test_parallel.py:57-88: the live problem shape (WTOT pose
    slots, 4096 landmark slots, WTOT x (1024 + 256) observation rows) over
    the 8-shard mesh; finite results."""
    Wb, L = tlm.WTOT, tlm.LM_SLOTS
    O = Wb * (1024 + 256)
    p, _, _ = _build_problem(W=Wb, L=64, seed=3)
    n = len(np.asarray(p.obs_kf))
    idx = np.tile(np.arange(n), O // n + 1)[:O]
    pts = np.zeros((L, 3), np.float32)
    pts[:64] = np.asarray(p.pts)
    pt_valid = np.zeros(L, bool)
    pt_valid[:64] = True
    big = {k: np.asarray(v) for k, v in p._asdict().items()}
    big.update(pts=pts, pt_valid=pt_valid)
    for k in ("obs_kf", "obs_lm", "obs_uv", "obs_stereo", "obs_right", "obs_w", "obs_valid"):
        big[k] = big[k][idx]
    tp = convert.ba_problem_from_jax(big, "cpu")
    step = tsba.sharded_two_rounds(tmesh.make_mesh(N_DEV, device="cpu"), iters1=2, iters2=2)
    p2, err, kill = tsba.run_problem(step, tp)
    assert torch.isfinite(p2.poses).all() and np.isfinite(float(err))
    assert kill.shape == (O,)


def _conf() -> ConfigFile:
    c = run_synthetic.config(320, 240, 10.0, 512, 1)
    c["FE"]["nLevels"] = 4
    return ConfigFile.from_dict(c)


@pytest.fixture(scope="module")
def facade_runs():
    """VSlamSystem on the CPU, unsharded and with shards=2, over the same
    10 frames of tests/test_system.py's scene (seed 7)."""
    scene = synthetic.make_scene(n_frames=N_FRAMES, n_points=400, width=320, height=240, fps=10.0, seed=7)
    frames = [(scene.render(f), scene.render(f, right=True)) for f in range(N_FRAMES)]
    params = ttr.TrackerParams(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256,
                               kf_min_stereo=60)
    out = {}
    for shards in (None, 2):
        sys_ = tsys.VSlamSystem(_conf(), lm_capacity=8192, kf_capacity=64, tracker_params=params,
                                device="cpu", shards=shards)
        for left, right in frames:
            sys_.track_stereo(left, right)
        sys_.exit()
        out[shards] = sys_
    return scene, out


def test_system_shards_matches_unsharded(facade_runs):
    """VSlamSystem(shards=2) on the CPU against the unsharded facade: the
    same keyframes and BA runs, poses within 1e-3 m."""
    scene, runs = facade_runs
    one, two = runs[None], runs[2]
    assert two.mapper.mesh.size == 2 and one.mapper.mesh is None
    assert two.tracker.new_kf_slots == one.tracker.new_kf_slots
    assert two.mapper.ba_count == one.mapper.ba_count > 0
    a, b = one.trajectory(), two.trajectory()
    assert a.shape == b.shape == (N_FRAMES, 4, 4)
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() < FACADE_TOL_M


def test_global_ba_uses_mesh_when_slabbed(facade_runs, monkeypatch, capsys):
    """tests/test_parallel.py:121-160: run_global with a mesh and a
    slab-chunked reduction takes the composed sharded + slabbed solve (the
    global_ba_slabs counter grows by n_slabs > 1 and the mapper reports
    the reduction sharded over the mesh); its error is finite and agrees
    with the unsharded mapper's slabbed global BA on the same map."""
    _, runs = facade_runs
    results, slabs, printed = [], [], []
    for sys_ in (runs[2], runs[None]):
        m = sys_.mapper
        monkeypatch.setattr(m, "GLOBAL_SLAB_BYTES", 1 << 10)
        monkeypatch.setattr(m, "GLOBAL_MIN_SLAB", 128)
        before = m.counters.get("global_ba_slabs")
        results.append(m.run_global())
        slabs.append(m.counters.get("global_ba_slabs") - before)
        printed.append(capsys.readouterr().out)
    assert slabs[0] == slabs[1] > 1, slabs
    assert f"chunked over {slabs[0]} landmark slabs" in printed[0]
    assert "sharded over 2 devices" in printed[0] and "sharded over" not in printed[1]
    (rs, r1) = results
    assert np.isfinite(rs["error"]) and rs["window"] == r1["window"]
    assert abs(rs["error"] - r1["error"]) <= ERR_REL * max(r1["error"], 1.0)
    np.testing.assert_allclose(rs["new_pose"], r1["new_pose"], atol=FACADE_TOL_M, rtol=0)


def test_run_batch_main_two_sequences(capsys):
    """python -m vslam_torch.run_batch 2 4 --device cpu: per-sequence ATE
    lines, the aggregate rate and the [result] line."""
    r = run_batch.main(["2", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("seq ") == 2 and "[result] 2 sequences x 4 frames" in out
    assert r["n_seqs"] == 2 and r["frames"] == 4 and r["aggregate_fps"] > 0
    assert all(a < 0.04 for a in r["ate_m"]), r["ate_m"]


def test_make_mesh_devices():
    """Virtual CPU shards, an explicit device list, and CUDA meshes that
    need more cards than there are."""
    m = tmesh.make_mesh(4, device="cpu")
    assert m.size == 4 and m.local == [(g, torch.device("cpu")) for g in range(4)]
    assert tmesh.make_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="cards"):
        tmesh.make_mesh(torch.cuda.device_count() + 1, device="cuda")
    parts = [torch.arange(8.0) * (g + 1) for g in range(4)]
    assert torch.equal(m.psum(parts), torch.arange(8.0) * 10)
    chunks = m.psum_scatter(parts, 0)
    assert torch.equal(torch.cat(chunks), torch.arange(8.0) * 10)
    assert torch.equal(m.all_gather(chunks), torch.arange(8.0) * 10)
    assert tmesh.initialize_distributed(num_processes=1) is None
