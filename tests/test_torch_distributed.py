"""The port's sharded BA across two OS processes (the counterpart of
tests/test_distributed.py): torch.distributed with the gloo backend on the
CPU, each process holding one shard of a 2-shard mesh
(vslam_torch.parallel.mesh.initialize_distributed + make_mesh(group=...)),
so the psum, reduce-scatter and all_gather ride the inter-process backend.
Each process builds the same (replicated) problem; both must return the
same solve, which must match the single-device solve in this process
(tests/test_parallel.py:36-54's tolerances). NCCL refuses two ranks on one
card, so this path is checked with gloo only."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

from tests.test_ba import _build_problem
from vslam_torch.geometry import se3
from vslam_torch.models import convert
from vslam_torch.ops import schur

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np, torch
    torch.set_num_threads(1)
    from tests.test_ba import _build_problem
    from vslam_torch.models import convert
    from vslam_torch.parallel import mesh as mesh_mod, sharded_ba

    pid, out_path = int(sys.argv[1]), sys.argv[2]
    group = mesh_mod.initialize_distributed(
        coordinator="127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    mesh = mesh_mod.make_mesh(device="cpu", group=group)
    assert mesh.size == 2 and mesh.local == [(pid, torch.device("cpu"))]
    p, _, _ = _build_problem(W=6, L=96, seed=2)
    tp = convert.ba_problem_from_jax({{k: np.asarray(v) for k, v in p._asdict().items()}}, "cpu")
    p2, err, kill = sharded_ba.run_problem(sharded_ba.sharded_two_rounds(mesh, 3, 3), tp)
    np.savez(out_path, poses=p2.poses.numpy(), pts=p2.pts.numpy(), err=float(err), kill=kill.numpy())
    torch.distributed.destroy_process_group()
    print("worker", pid, "err", float(err), flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_ba_matches_single_device(tmp_path):
    code = _WORKER.format(repo=REPO, port=_free_port())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = [str(tmp_path / f"out_{i}.npz") for i in range(2)]
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(i), outs[i]], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path))
        for i in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    res = [np.load(o) for o in outs]
    for k in ("poses", "pts", "kill"):
        np.testing.assert_array_equal(res[0][k], res[1][k])  # replicated results

    p, _, _ = _build_problem(W=6, L=96, seed=2)
    tp = convert.ba_problem_from_jax({k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    p_d, err_d, kill_d = schur.local_ba_two_rounds(tp, iters1=3, iters2=3)
    rel = torch.linalg.inv(p_d.poses) @ torch.from_numpy(res[0]["poses"])
    assert float(se3.se3_logmap(rel).abs().max()) < 1e-3
    np.testing.assert_allclose(res[0]["pts"], p_d.pts.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(res[0]["kill"], kill_d.numpy())
    assert abs(float(res[0]["err"]) - float(err_d)) <= 1e-2 * max(float(err_d), 1.0)
