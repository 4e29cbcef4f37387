"""The port's multi-device dry run (vslam_torch/dryrun.py) on the CPU, the
counterpart of tests/test_parallel.py::test_dryrun_multichip_entrypoint:
the dry run's BA problem against the JAX package's construction (rebuilt
here from vslam_tpu functions), part (a) on 8 virtual CPU shards against
JAX's sharded solve on the conftest's 8-device mesh and against the port's
unsharded solve, part (b) against the unsharded slabbed solve, part (c)
(the frontend split over 4 shards) against one batch and against each
sequence's solo run, the frame-step entry on one frame, the multi-process
run over gloo, and the guards: too few cards raise, and NCCL ranks open
their communicator on their own card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vslam_torch import dryrun
from vslam_torch.models import convert, map_state as tms, tracker as ttr
from vslam_torch.ops import patches, schur as tsch
from vslam_torch.parallel import mesh as tmesh
from vslam_torch.utils import synthetic as tsyn
from vslam_tpu.geometry import se3 as jse3
from vslam_tpu.ops import schur as jsch
from vslam_tpu.parallel import mesh as jmesh, sharded_ba as jsba

torch.set_num_threads(2)  # xdist runs several workers on one box

N_DEV = 8  # tests/test_torch_parallel.py:25
N_SEQ = 4
# JAX's se3_expmap and the port's round the drive's rotation terms
# differently in float32: pose 8 (0.08 rad) is 1.2e-6 apart, each side
# ~6e-7 from a float64 evaluation (the cancellation of (1 - cos) / t^2
# and (t - sin) / t^3; ROADMAP.md, queue C)
POSE_TOL = 2e-6
ENTRY_GATE_M = 0.05
SOLO_TOL_M = 1e-6  # tests/test_torch_multi_seq.py:34


def _jax_problem(n: int):
    """The JAX package's dry-run problem, built as its dry run builds it."""
    rng = np.random.default_rng(0)
    Wn, L, obs_per_lm = 20, 4096, 6
    O = (L * obs_per_lm // n) * n
    K = jnp.asarray([[460.0, 0, 376.0], [0, 460.0, 240.0], [0, 0, 1.0]], jnp.float32)
    poses = []
    for i in range(Wn):
        xi = np.array([0.0, 0.01 * i, 0.0, 0.2 * i, 0.0, 0.0], np.float32)
        poses.append(np.asarray(jse3.se3_expmap(jnp.asarray(xi))))
    poses = jnp.asarray(np.stack(poses))
    pts = jnp.asarray(
        np.stack([rng.uniform(-5, 5, L), rng.uniform(-3, 3, L), rng.uniform(6, 30, L)], -1).astype(np.float32)
    )
    obs_lm = np.tile(np.arange(L), obs_per_lm)[:O]
    obs_kf = ((obs_lm + np.arange(O) % obs_per_lm) % Wn).astype(np.int32)
    Tcw = np.linalg.inv(np.asarray(poses))
    pc = np.einsum("oij,oj->oi", Tcw[obs_kf][:, :3, :3], np.asarray(pts)[obs_lm]) + Tcw[obs_kf][:, :3, 3]
    u = 460.0 * pc[:, 0] / pc[:, 2] + 376.0
    v = 460.0 * pc[:, 1] / pc[:, 2] + 240.0
    ur = 460.0 * (pc[:, 0] - 0.12) / pc[:, 2] + 376.0
    fixed = np.zeros(Wn, bool)
    fixed[0] = True
    fixed[12:] = True
    return jsch.BAProblem(
        poses=poses, fixed=jnp.asarray(fixed), pose_valid=jnp.ones(Wn, dtype=bool), pts=pts,
        pt_valid=jnp.ones(L, dtype=bool), obs_kf=jnp.asarray(obs_kf),
        obs_lm=jnp.asarray(obs_lm.astype(np.int32)),
        obs_uv=jnp.asarray(np.stack([u, v, ur], -1).astype(np.float32)),
        obs_stereo=jnp.asarray(np.arange(O) % 2 == 0), obs_right=jnp.asarray(np.arange(O) % 7 == 3),
        obs_w=jnp.ones(O, jnp.float32), obs_valid=jnp.asarray(pc[:, 2] > 0.1), K=K,
        baseline=jnp.float32(0.12),
        odo_rel=jnp.asarray(
            np.stack([Tcw[i] @ np.asarray(poses)[i + 1] for i in range(Wn - 1)]).astype(np.float32)
        ),
        odo_valid=jnp.asarray(np.arange(Wn - 1) < 11),
    )


@pytest.fixture(scope="module")
def jax_problem():
    return _jax_problem(N_DEV)


@pytest.fixture(scope="module")
def multichip():
    return dryrun.dryrun_multichip(N_DEV, device="cpu")


@pytest.fixture(scope="module")
def single_device():
    return dryrun.unsharded(dryrun.dryrun_problem(N_DEV, "cpu"))


def _result(p, err, kill) -> dict:
    return {"poses": torch.as_tensor(np.asarray(p.poses)), "pts": torch.as_tensor(np.asarray(p.pts)),
            "err": torch.as_tensor(np.asarray(err)), "kill": torch.as_tensor(np.asarray(kill))}


def test_dryrun_problem_is_the_jax_construction(jax_problem):
    """Built on JAX's drive, every field equals JAX's exactly; built on the
    port's own se3_expmap, the drive is within float32 rounding of JAX's."""
    jp = {k: np.asarray(v) for k, v in jax_problem._asdict().items()}
    tp = dryrun.dryrun_problem(N_DEV, "cpu", poses=jp["poses"])
    for k, v in tp._asdict().items():
        np.testing.assert_array_equal(v.numpy(), jp[k], err_msg=k)
    assert tp.obs_kf.shape == (N_DEV * (4096 * 6 // N_DEV),)
    own = dryrun.dryrun_problem(N_DEV, "cpu").poses.numpy()
    np.testing.assert_allclose(own, jp["poses"], rtol=0, atol=POSE_TOL)


def test_part_a_matches_jax_sharded_and_unsharded(multichip, single_device, jax_problem):
    """Part (a), 2 + 2 LM iterations over 8 virtual CPU shards, against
    JAX's sharded_two_rounds on its 8-device mesh (on JAX's problem, carried
    across) and against the port's unsharded solve, with
    tests/test_torch_parallel.py's _agree tolerances."""
    a = multichip["a"]
    assert multichip["mesh"] == ["cpu"] * N_DEV and a["iters"] == [2, 2]
    jstep = jsba.sharded_two_rounds(jmesh.make_mesh(N_DEV, axis=jsba.AXIS), iters1=2, iters2=2)
    jres = _result(*jsba.run_problem(jstep, jax_problem))
    assert dryrun.compare(a, jres)["within"], dryrun.compare(a, jres)
    assert dryrun.compare(a, single_device["a"])["within"], dryrun.compare(a, single_device["a"])
    # the port on JAX's own drive: the same tolerances
    tp = convert.ba_problem_from_jax({k: np.asarray(v) for k, v in jax_problem._asdict().items()}, "cpu")
    assert dryrun.compare(_result(*tsch.local_ba_two_rounds(tp, 2, 2)), jres)["within"]


def test_part_b_matches_unsharded_slabbed_solve(multichip, single_device):
    """Part (b), 4 landmark slabs x 8 shards, 1 + 1 iterations, against the
    port's unsharded n_slabs=4 solve and the unsharded unslabbed one."""
    b = multichip["b"]
    assert b["iters"] == [1, 1]
    assert dryrun.compare(b, single_device["b"])["within"], dryrun.compare(b, single_device["b"])
    p = dryrun.dryrun_problem(N_DEV, "cpu")
    assert dryrun.compare(b, _result(*tsch.local_ba_two_rounds(p, 1, 1)))["within"]


def _solo(s: int) -> np.ndarray:
    """Sequence s of part (c) through its own tracker's track()."""
    scene = tsyn.make_scene(n_frames=2, n_points=120, width=dryrun.SEQ_W, height=dryrun.SEQ_H, fps=10.0,
                            seed=3 + s)
    world = tms.WorldMap(**dryrun.SEQ_WORLD, device="cpu")
    t = ttr.StereoTracker(scene.K.astype(np.float32), scene.baseline, dryrun.SEQ_W, dryrun.SEQ_H, world,
                          ttr.TrackerParams(**dryrun.SEQ_PARAMS), device="cpu")
    for f in range(2):
        t.track(scene.render(f).astype(np.uint8), scene.render(f, right=True).astype(np.uint8))
    t.flush()
    return t.trajectory()


def test_part_c_split_equals_one_batch_and_solo_runs(multichip):
    """Part (c) over 4 virtual CPU shards (one frontend per shard) equals
    one BatchedStereoFrontend over the 4 sequences, and each sequence its
    solo run; each shard's window call equals its plain version (the plain
    version itself on the CPU: no launch)."""
    split = dryrun.dryrun_frontend(["cpu"] * N_SEQ)
    one = dryrun.dryrun_frontend(["cpu"] * N_SEQ, split=False)
    assert split["devices"] == ["cpu"] * N_SEQ and one["devices"] == ["cpu"]
    np.testing.assert_array_equal(split["poses"], one["poses"])
    assert np.isfinite(split["poses"]).all() and split["poses"].shape == (N_SEQ, 2, 4, 4)
    for s in range(N_SEQ):
        np.testing.assert_allclose(split["poses"][s], _solo(s), atol=SOLO_TOL_M, rtol=0)
    assert split["launches"] == [0] * N_SEQ
    assert len(split["windows"]) == N_SEQ and all(w["equal"] for w in split["windows"])
    assert split["windows"][0]["shape"] == [2, 128, 31, 31]
    # the dry run's own part (c): 8 sequences, the first 4 as above
    c = multichip["c"]
    assert c["poses"].shape == (N_DEV, 2, 4, 4)
    np.testing.assert_array_equal(c["poses"][:N_SEQ], split["poses"])


def test_entry_tracks_frame_one():
    """One call of the entry's frame step on the CPU: a finite pose within
    ENTRY_GATE_M of the scene's frame-1 truth, no kernel launch."""
    fn, args = dryrun.entry("cpu")
    n0 = patches.LAUNCHES
    state, outputs = fn(*args)
    assert patches.LAUNCHES == n0
    pose = outputs["blob"][:16].reshape(4, 4).numpy()
    scene = tsyn.make_scene(n_frames=2, n_points=600, width=752, height=480, fps=20.0, seed=3)
    assert np.isfinite(pose).all()
    assert np.linalg.norm(pose[:3, 3] - scene.poses_c2w[1][:3, 3]) < ENTRY_GATE_M
    assert set(state) == set(args[1])


def test_two_processes_equal_the_single_process_mesh():
    """python -m vslam_torch.dryrun --devices 2 --processes 2 --device cpu:
    two gloo ranks, one shard each, both bit for bit the single-process
    2-shard solve (a sum of two partials is the same in either order)."""
    out = dryrun.main(["--devices", "2", "--processes", "2", "--device", "cpu"])
    assert [r["rank"] for r in out["ranks"]] == [0, 1]
    for r in out["ranks"]:
        assert r["iters"] == [2, 2]
        assert r["vs_single_process"]["bit_equal"], r


def test_too_few_cards_raise_and_name_the_count(monkeypatch):
    """Four shards on a machine with one card: the entry raises before any
    work, naming both counts; so do four processes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="4 cards; 1 visible"):
        dryrun.main(["--devices", "4"])
    with pytest.raises(ValueError, match="need 4 cards, one each; 1 visible"):
        dryrun.main(["--devices", "4", "--processes", "4"])


def test_nccl_ranks_take_their_own_card_before_the_group(monkeypatch):
    """Under NCCL, initialize_distributed makes rank r's card (r modulo the
    cards) current and names it to init_process_group, with the collective
    timeout; gloo gets neither."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", torch.device(d))))
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    tmesh.initialize_distributed("127.0.0.1:1", 4, 3, backend="nccl", timeout_s=30)
    assert calls[0] == ("set_device", torch.device("cuda", 1))
    backend, kw = calls[1]
    assert backend == "nccl" and kw["device_id"] == torch.device("cuda", 1)
    assert kw["rank"] == 3 and kw["world_size"] == 4 and kw["timeout"].total_seconds() == 30
    calls.clear()
    tmesh.initialize_distributed("127.0.0.1:1", 2, 1)
    assert calls == [("gloo", {"init_method": "tcp://127.0.0.1:1", "world_size": 2, "rank": 1})]
