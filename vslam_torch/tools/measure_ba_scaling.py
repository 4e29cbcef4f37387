"""LM iterations/s of the sharded local BA: the port of the JAX repo's
tools/measure_ba_scaling.py.

    python -m vslam_torch.tools.measure_ba_scaling [--device cpu]

Times the solve the live mapper runs (``schur.local_ba`` with a ``mesh``:
observation rows sharded, landmark blocks reduce-scattered, the reduced
system summed) with ``rel_tol=0`` (no early exit), per LM iteration as
(t(21 iterations) - t(1)) / 20, on 1, 2, 4 and 8 shards:
- the live local window: 20 pose slots, 4096 landmark slots, 24,576
  observation rows (the JAX tool's size);
- the grown global window: 64 pose slots, 16,384 landmarks;
- per-shard compute: the unsharded solve at the slab size L/n each shard
  of an n-shard mesh holds.

On the card the shards are virtual shards on one card
(``make_mesh(devices=["cuda:0"] * n)``): one card measures what sharding
costs (its extra launches and collectives), not how it scales across
cards. ``--device cpu`` runs them as virtual CPU shards, as the JAX tool
did. ``--cards`` runs the live and the global window on meshes of 1, 2
and 4 distinct cards (``make_mesh(n)``; it raises with fewer cards) next
to virtual shards at the same sizes, and adds each mesh's kernel
launches and each card's device busy per LM iteration (profiled: (a
5-iteration solve - a 1-iteration one) / 4). Prints one line per mesh and
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vslam_torch.geometry import se3
from vslam_torch.ops import schur
from vslam_torch.parallel import mesh as mesh_mod
from vslam_torch.tools import _common
from vslam_torch.utils import metrics

SHARDS = (1, 2, 4, 8)
CARDS = (1, 2, 4)


def build_problem(Wn: int = 20, L: int = 4096, obs_per_lm: int = 6, seed: int = 0, device="cuda") -> schur.BAProblem:
    """The JAX tool's synthetic window (tools/measure_ba_scaling.py:40-96):
    Wn poses along a drive, L landmarks seen `obs_per_lm` times each, pixel
    noise and perturbed points so every LM iteration has work; keyframes 0
    and 12.. fixed, odometry on the first 11 links."""
    rng = np.random.default_rng(seed)
    O = L * obs_per_lm
    xi = np.array([[0.002 * i, 0.01 * i, 0.001 * i, 0.2 * i, 0.01 * i, 0.0] for i in range(Wn)], np.float32)
    poses = se3.se3_expmap(torch.from_numpy(xi)).numpy()
    pts = np.stack([rng.uniform(-5, 5, L), rng.uniform(-3, 3, L), rng.uniform(6, 30, L)], -1).astype(np.float32)
    obs_lm = np.tile(np.arange(L), obs_per_lm)
    obs_kf = (obs_lm + np.arange(O) % obs_per_lm) % Wn
    Tcw = np.linalg.inv(poses)
    pc = np.einsum("oij,oj->oi", Tcw[obs_kf][:, :3, :3], pts[obs_lm]) + Tcw[obs_kf][:, :3, 3]
    u = 460.0 * pc[:, 0] / pc[:, 2] + 376.0
    v = 460.0 * pc[:, 1] / pc[:, 2] + 240.0
    ur = 460.0 * (pc[:, 0] - 0.12) / pc[:, 2] + 376.0
    u += rng.normal(0, 0.5, O)
    v += rng.normal(0, 0.5, O)
    fixed = np.zeros(Wn, bool)
    fixed[0] = True
    fixed[12:] = True
    dev = torch.device(device)
    t = lambda a, dtype=None: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731
    return schur.BAProblem(
        poses=t(poses, torch.float32), fixed=t(fixed), pose_valid=t(np.ones(Wn, bool)),
        pts=t(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)), pt_valid=t(np.ones(L, bool)),
        obs_kf=t(obs_kf, torch.int64), obs_lm=t(obs_lm, torch.int64),
        obs_uv=t(np.stack([u, v, ur], -1), torch.float32), obs_stereo=t(np.arange(O) % 2 == 0),
        obs_right=t(np.zeros(O, bool)), obs_w=t(np.ones(O), torch.float32), obs_valid=t(pc[:, 2] > 0.1),
        K=t([[460.0, 0, 376.0], [0, 460.0, 240.0], [0, 0, 1.0]], torch.float32),
        baseline=t(0.12, torch.float32),
        odo_rel=t(np.stack([Tcw[i] @ poses[i + 1] for i in range(Wn - 1)]), torch.float32),
        odo_valid=t(np.arange(Wn - 1) < 11),
    )


def _mesh(n: int, device, cards: bool = False):
    """n virtual shards on `device`, or (`cards`) n distinct cards."""
    dev = torch.device(device)
    if cards:
        return mesh_mod.make_mesh(n)
    if dev.type == "cuda":
        return mesh_mod.make_mesh(devices=[dev] * n)
    return mesh_mod.make_mesh(n, device="cpu")


def _sync(device):
    """Wait for every card (a mesh's shards may hold work on any)."""
    if torch.device(device).type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def time_solve(p: schur.BAProblem, mesh, iters: int, n: int = 3) -> float:
    """Seconds per solve of `iters` LM iterations, after one untimed."""
    dev = p.poses.device
    schur.local_ba(p, iters=iters, rel_tol=0.0, mesh=mesh)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        schur.local_ba(p, iters=iters, rel_tol=0.0, mesh=mesh)
        _sync(dev)
    return (time.perf_counter() - t0) / n


def ms_per_iter(p: schur.BAProblem, mesh, reps: int = 3) -> float:
    return (time_solve(p, mesh, 21, reps) - time_solve(p, mesh, 1, reps)) / 20.0 * 1e3


def iteration_profile(p: schur.BAProblem, mesh, n_slabs: int = 1) -> dict:
    """Kernel launches, copy calls (the peer copies between cards among
    them) and each card's device busy per LM iteration: (a 5-iteration
    solve - a 1-iteration one) / 4, each profiled once; and, with a mesh,
    the wall of one ``schur._shards`` call (the copy of every problem field
    to every shard, made twice an iteration: for the step and for the
    trial error), the median of 5."""
    dev = p.poses.device

    def profile(iters):
        return metrics.profile_counts(
            lambda: (schur.local_ba(p, iters=iters, rel_tol=0.0, mesh=mesh, n_slabs=n_slabs), _sync(dev)),
            by_card=True)

    one, five = profile(1), profile(5)
    b1, b5 = one["device_busy_ms_by_card"], five["device_busy_ms_by_card"]
    out = {"launches_per_iter": (five["kernel_launches"] - one["kernel_launches"]) / 4,
           "memcpy_per_iter": (five["memcpy_calls"] - one["memcpy_calls"]) / 4,
           "device_busy_ms_per_iter_by_card": {k: (b5.get(k, 0.0) - b1.get(k, 0.0)) / 4
                                               for k in sorted(set(b1) | set(b5))}}
    if mesh is not None:
        walls = []
        for _ in range(5):
            _sync(dev)
            t0 = time.perf_counter()
            schur._shards(p, mesh)
            _sync(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        out["shards_copy_ms"] = sorted(walls)[2]
    return out


def run_suite(name: str, p: schur.BAProblem, device, shards=SHARDS, reps: int = 3, cards: bool = False) -> list:
    """ms per LM iteration on each mesh size; `cards`: meshes of distinct
    cards, with each one's iteration profile."""
    kind = "cards" if cards else "shards"
    print(f"[{name}] W={p.poses.shape[0]} L={p.pts.shape[0]} O={p.obs_kf.shape[0]} ({kind})", flush=True)
    rows, base = [], None
    for n in shards:
        mesh = None if n == 1 else _mesh(n, device, cards)
        ms = ms_per_iter(p, mesh, reps)
        base = base or ms
        row = {"suite": name, kind: n, "ms_per_lm_iter": ms, "iters_per_s": 1e3 / ms, f"vs_1_{kind[:-1]}": base / ms}
        if cards:
            row.update(iteration_profile(p, mesh))
        rows.append(row)
        print(f"  {kind}={n}: {ms:.2f} ms/LM-iter -> {1e3 / ms:.1f} iters/s (vs 1: {base / ms:.2f}x)", flush=True)
    return rows


def run_slab_compute(name: str, Wn: int, L_full: int, device, shards=SHARDS, reps: int = 3) -> list:
    """The unsharded solve at L_full / n landmarks: the compute each shard
    of an n-shard mesh performs."""
    print(f"[{name}] W={Wn} L_full={L_full}", flush=True)
    rows, base = [], None
    for n in shards:
        ms = ms_per_iter(build_problem(Wn=Wn, L=L_full // n, device=device), None, reps)
        base = base or ms
        rows.append({"suite": name, "shards": n, "landmarks": L_full // n, "ms_per_lm_iter": ms,
                     "vs_full": base / ms})
        print(f"  slab L/{n}={L_full // n}: {ms:.2f} ms/LM-iter (vs full: {base / ms:.2f}x)", flush=True)
    return rows


def run(device="cuda", reps: int = 3, cards: bool = False) -> list:
    """The virtual-shard suites and the slab compute; `cards`: the live and
    the global window on 1, 2 and 4 virtual shards and on as many
    distinct cards (which it needs: it raises with fewer)."""
    if torch.device(device).type == "cuda":
        _common.require_card("measure_ba_scaling")
    problems = {"local window": build_problem(device=device),
                "global window": build_problem(Wn=64, L=16384, device=device)}
    if cards:
        if torch.cuda.device_count() < max(CARDS):
            raise ValueError(f"--cards needs {max(CARDS)} cards; {torch.cuda.device_count()} visible")
        rows = []
        for name, p in problems.items():
            rows += run_suite(name, p, device, CARDS, reps)
            rows += run_suite(name, p, device, CARDS, reps, cards=True)
        return rows
    rows = []
    for name, p in problems.items():
        rows += run_suite(name, p, device, reps=reps)
    rows += run_slab_compute("global window slab compute", 64, 16384, device, reps=reps)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (virtual shards on one card) or cpu")
    ap.add_argument("--cards", action="store_true", help="also meshes of 1, 2 and 4 distinct cards")
    args = ap.parse_args(argv)
    if args.cards and torch.device(args.device).type != "cuda":
        raise ValueError("--cards measures meshes of CUDA cards")
    rows = run(args.device, cards=args.cards)
    if torch.device(args.device).type == "cuda":
        mesh = ("virtual shards on cuda:0 (shards) and distinct cards (cards)" if args.cards else
                "virtual shards on one card: the cost of sharding, not scaling across cards")
        return _common.emit("measure_ba_scaling", rows, mesh=mesh, cards_visible=torch.cuda.device_count())
    line = {"tool": "measure_ba_scaling", "device": {"name": "cpu"}, "mesh": "virtual CPU shards", "rows": rows}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
