"""The JAX package's multi-device dry run and its frame-step entry, on the
port.

    python -m vslam_torch.dryrun --devices N [--processes P] [--device cuda|cpu]

:func:`entry` returns the tracker's per-frame program at the bench's shapes
(752x480, 1024 features, 8 levels, 4096 active slots) with frame 1's
inputs: the state seeded by the tracker's own frame-0 map init. One call
makes exactly one ``extract_windows`` launch on the card.

:func:`dryrun_multichip` runs, over a mesh of N shards (N distinct cards on
CUDA unless `devices` lists them, N virtual shards on the CPU):

(a) the sharded two-round local BA at the live size
    (:func:`dryrun_problem`: 20 pose slots, 4096 landmark slots, 6
    observations per landmark), 2 + 2 LM iterations;
(b) the same problem with the Schur reduction also in 4 landmark slabs
    (the map-scale composition), 1 + 1 iterations;
(c) the batched frontend with the sequence axis split over the shards:
    N sequences at 160x120, sequence s on shard s's device, one
    :class:`~vslam_torch.parallel.multi_seq.BatchedStereoFrontend` per
    shard stepped in shard order; each shard's ``extract_windows`` call
    held against its plain version on the same device.

The module prints one JSON line per part, the agreement of (a) and (b)
with the unsharded solve (and, across distinct cards, with N virtual
shards on the first card, and for (c) the one-device batch and each card's
kernel table), then the card's name and power limit.

With ``--processes P`` (P = N) it starts P worker processes, one shard
each: NCCL on CUDA (process r on card r), gloo on the CPU. Each builds the
same replicated problem and runs part (a) over the process group; the
parent then holds every rank's result against the single-process N-shard
solve. With fewer cards than asked for it raises; nothing falls back to
fewer shards or to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vslam_torch.geometry import se3
from vslam_torch.models import map_state, tracker
from vslam_torch.ops import patches, schur
from vslam_torch.parallel import mesh as mesh_mod, multi_seq, sharded_ba
from vslam_torch.utils import metrics, synthetic

# the live local-BA problem (the mapper's WTOT pose slots and LM_SLOTS
# landmark slots; 6 observations per landmark)
WINDOW, LANDMARKS, OBS_PER_LM = 20, 4096, 6
SLABS = 4
# part (c): tiny frames, one sequence per shard
SEQ_W, SEQ_H = 160, 120
SEQ_PARAMS = dict(n_features=128, n_levels=3, active_size=256, spawn_per_kf=128)
SEQ_WORLD = dict(lm_capacity=1024, kf_capacity=8, keys_per_kf=128)
# the card tolerances of a sharded solve against the unsharded one
# (tests/test_parallel.py:36-54)
POSE_LOG_TOL, PT_TOL, ERR_REL = 1e-3, 1e-3, 1e-2
# the multi-process run: a collective that does not return fails after
# COLLECTIVE_TIMEOUT_S; a worker that outlives WORKER_LIMIT_S is killed
COLLECTIVE_TIMEOUT_S, WORKER_LIMIT_S = 120.0, 300.0


def entry(device="cuda"):
    """(fn, args): fn(*args) is ``tracker._track_step``, the program the
    tracker dispatches per frame (batched L+R extraction, stereo matching,
    the radius attempts of projection matching and motion-only LM, right
    camera matching, the failure gate, landmark aging), at the bench's
    shapes, on frame 1 of scene seed 3 (600 points) with the state that
    the tracker's frame-0 map init built. `args` = (frame 1's L+R, the
    state, None): the stereo step takes no IMU rows."""
    dev = torch.device(device)
    scene = synthetic.make_scene(n_frames=2, n_points=600, width=752, height=480, fps=20.0, seed=3)
    params = tracker.TrackerParams(n_features=1024, n_levels=8, active_size=4096)
    world = map_state.WorldMap(lm_capacity=1 << 14, kf_capacity=64, keys_per_kf=params.n_features,
                               device=dev)
    trk = tracker.StereoTracker(scene.K.astype(np.float32), scene.baseline, scene.width,
                                scene.height, world, params, device=dev)
    trk.track(scene.render(0).astype(np.uint8), scene.render(0, right=True).astype(np.uint8))
    LR = torch.as_tensor(
        np.stack([scene.render(1), scene.render(1, right=True)]).astype(np.uint8)
    ).to(dev, torch.float32)
    p = trk.params

    def frame_step(LR, state, imu=None):
        return tracker._track_step(
            LR, state, trk._radii, p.refine_radius, trk._desc_thr, trk._ratio, trk.K,
            trk.baseline, trk.scale_factors, p, trk.width, trk.height, imu=imu,
        )

    return frame_step, (LR, trk._state, None)


def dryrun_problem(n_devices: int, device="cuda", poses: np.ndarray | None = None) -> schur.BAProblem:
    """The dry run's BA problem: WINDOW poses along a drive (keyframes 0
    and 12.. fixed, odometry on the first 11 links), LANDMARKS points each
    seen OBS_PER_LM times, the observation rows cut to a multiple of
    `n_devices`, exact pixels (no noise), every 7th row a right-camera
    one. The same numpy construction as the JAX package's dry run.
    `poses`: the (WINDOW, 4, 4) float32 drive to build it on (default:
    se3_expmap of each step)."""
    rng = np.random.default_rng(0)
    Wn, L = WINDOW, LANDMARKS
    O = (L * OBS_PER_LM // n_devices) * n_devices
    if poses is None:
        xi = np.array([[0.0, 0.01 * i, 0.0, 0.2 * i, 0.0, 0.0] for i in range(Wn)], np.float32)
        poses = np.stack([se3.se3_expmap(torch.from_numpy(x)).numpy() for x in xi])
    pts = np.stack(
        [rng.uniform(-5, 5, L), rng.uniform(-3, 3, L), rng.uniform(6, 30, L)], -1
    ).astype(np.float32)
    obs_lm = np.tile(np.arange(L), OBS_PER_LM)[:O]
    obs_kf = (obs_lm + np.arange(O) % OBS_PER_LM) % Wn
    Tcw = np.linalg.inv(poses)
    pc = np.einsum("oij,oj->oi", Tcw[obs_kf][:, :3, :3], pts[obs_lm]) + Tcw[obs_kf][:, :3, 3]
    u = 460.0 * pc[:, 0] / pc[:, 2] + 376.0
    v = 460.0 * pc[:, 1] / pc[:, 2] + 240.0
    ur = 460.0 * (pc[:, 0] - 0.12) / pc[:, 2] + 376.0
    fixed = np.zeros(Wn, bool)
    fixed[0] = True
    fixed[12:] = True  # the anchor block is gauge-fixed
    dev = torch.device(device)
    t = lambda a, dtype=None: torch.as_tensor(np.array(a), dtype=dtype, device=dev)  # noqa: E731
    return schur.BAProblem(
        poses=t(poses), fixed=t(fixed), pose_valid=t(np.ones(Wn, bool)), pts=t(pts),
        pt_valid=t(np.ones(L, bool)), obs_kf=t(obs_kf, torch.int64), obs_lm=t(obs_lm, torch.int64),
        obs_uv=t(np.stack([u, v, ur], -1).astype(np.float32)), obs_stereo=t(np.arange(O) % 2 == 0),
        obs_right=t(np.arange(O) % 7 == 3), obs_w=t(np.ones(O, np.float32)),
        obs_valid=t(pc[:, 2] > 0.1),
        K=t([[460.0, 0, 376.0], [0, 460.0, 240.0], [0, 0, 1.0]], torch.float32),
        baseline=t(0.12, torch.float32),
        odo_rel=t(np.stack([Tcw[i] @ poses[i + 1] for i in range(Wn - 1)]).astype(np.float32)),
        odo_valid=t(np.arange(Wn - 1) < 11),
    )


def _sync(devices):
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _solve(p: schur.BAProblem, mesh, iters1: int, iters2: int, n_slabs: int = 1) -> dict:
    """A two-round solve, sharded over `mesh` (None: unsharded): its
    results, LM iterations per round and wall seconds."""
    devices = mesh.devices if mesh is not None else [p.poses.device]
    _sync(devices)
    stats: list = []
    t0 = time.perf_counter()
    if mesh is None:
        q, err, kill = schur.local_ba_two_rounds(p, iters1, iters2, n_slabs=n_slabs, stats=stats)
    else:
        step = sharded_ba.sharded_two_rounds(mesh, iters1, iters2, n_slabs=n_slabs)
        q, err, kill = sharded_ba.run_problem(step, p, stats=stats)
    _sync(devices)
    return {"poses": q.poses, "pts": q.pts, "err": err, "kill": kill, "iters": stats,
            "wall_s": time.perf_counter() - t0}


@contextlib.contextmanager
def _window_calls():
    """Record (arguments, output) of every extract_windows_levels call made
    while the block runs."""
    calls, kernel = [], patches.extract_windows_levels

    def recorded(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    patches.extract_windows_levels = recorded
    try:
        yield calls
    finally:
        patches.extract_windows_levels = kernel


def dryrun_frontend(devices: list, split: bool = True) -> dict:
    """Part (c): len(devices) sequences (scene seeds 3 + s, 160x120),
    sequence s's tracker on devices[s]; frame 0 through each tracker's
    own track, frame 1 batched. `split`: one BatchedStereoFrontend per
    shard, stepped in shard order; else one over every sequence (they
    must share a device). Returns each sequence's trajectory (S, 2, 4, 4),
    the window kernel's launches per shard in the batched frame, and each
    shard's batched window call held against its plain version."""
    S = len(devices)
    params = tracker.TrackerParams(**SEQ_PARAMS)
    trackers, frames = [], []
    for s, d in enumerate(devices):
        scene = synthetic.make_scene(n_frames=2, n_points=120, width=SEQ_W, height=SEQ_H, fps=10.0,
                                     seed=3 + s)
        world = map_state.WorldMap(**SEQ_WORLD, device=d)
        trackers.append(tracker.StereoTracker(scene.K.astype(np.float32), scene.baseline, SEQ_W, SEQ_H,
                                              world, params, device=d))
        frames.append([(scene.render(f).astype(np.uint8), scene.render(f, right=True).astype(np.uint8))
                       for f in range(2)])
    groups = [[s] for s in range(S)] if split else [list(range(S))]
    fronts = [multi_seq.BatchedStereoFrontend([trackers[s] for s in g]) for g in groups]
    _sync(devices)
    t0 = time.perf_counter()
    for front, g in zip(fronts, groups):
        front.track([frames[s][0] for s in g])
    launches, windows = [], []
    with _window_calls() as calls:
        for front, g in zip(fronts, groups):
            n0 = patches.LAUNCHES
            front.track([frames[s][1] for s in g])
            launches.append(patches.LAUNCHES - n0)
    for front in fronts:
        front.flush()
    _sync(devices)
    wall = time.perf_counter() - t0
    for args, out in calls:
        ref = patches.extract_windows_levels_ref(*args)
        windows.append({"device": str(out.device), "shape": list(out.shape), "equal": bool(torch.equal(out, ref)),
                        "max_abs_err": float((out - ref).abs().max()) if out.numel() else 0.0})
    return {"poses": np.stack([t.trajectory() for t in trackers]), "launches": launches, "windows": windows,
            "calls": [args for args, _ in calls], "devices": [str(front.device) for front in fronts],
            "wall_s": wall}


def dryrun_multichip(n_devices: int, devices=None, device="cuda") -> dict:
    """Parts (a), (b) and (c) over a mesh of `n_devices` shards: `devices`
    lists them (e.g. ``["cuda:0"] * 4``: virtual shards on one card), else
    distinct cards on CUDA (raising with fewer) or virtual shards on the
    CPU. Returns every result: "a" and "b" (poses, pts, err, kill, LM
    iterations per round, wall seconds), "c" (:func:`dryrun_frontend`),
    "mesh" (the shard devices)."""
    mesh = mesh_mod.make_mesh(n_devices, devices=devices, device=device)
    p = dryrun_problem(n_devices, mesh.devices[0])
    out = {"mesh": [str(d) for d in mesh.devices]}
    out["a"] = _solve(p, mesh, 2, 2)
    out["b"] = _solve(p, mesh, 1, 1, n_slabs=SLABS)
    out["c"] = dryrun_frontend(mesh.devices)
    for part in ("a", "b"):
        r = out[part]
        if not (torch.isfinite(r["poses"]).all() and torch.isfinite(r["err"])):
            raise AssertionError(f"dry run part ({part}): a non-finite solve")
    if not np.isfinite(out["c"]["poses"]).all():
        raise AssertionError("dry run part (c): a non-finite pose")
    return out


def unsharded(p: schur.BAProblem) -> dict:
    """Parts (a) and (b)'s solves of `p` on one device, unsharded."""
    return {"a": _solve(p, None, 2, 2), "b": _solve(p, None, 1, 1, n_slabs=SLABS)}


def compare(sol: dict, ref: dict) -> dict:
    """One solve against another: the max pose log |log(ref^-1 sol)|, the
    max point gap, kills equal, the error gap relative to max(err, 1), and
    whether every result is bit-identical; `within` holds the card
    tolerances (tests/test_parallel.py:36-54)."""
    d = torch.device("cpu")
    a = {k: sol[k].to(d) for k in ("poses", "pts", "err", "kill")}
    b = {k: ref[k].to(d) for k in ("poses", "pts", "err", "kill")}
    log = float(se3.se3_logmap(torch.linalg.inv(b["poses"]) @ a["poses"]).abs().max())
    dpt = float((a["pts"] - b["pts"]).abs().max())
    pts_ok = bool(torch.all((a["pts"] - b["pts"]).abs() <= PT_TOL + PT_TOL * b["pts"].abs()))
    kills = bool(torch.equal(a["kill"], b["kill"]))
    derr = abs(float(a["err"]) - float(b["err"])) / max(float(b["err"]), 1.0)
    return {"max_pose_log": log, "max_dpt": dpt, "kills_equal": kills, "err_rel": derr,
            "bit_equal": all(bool(torch.equal(a[k], b[k])) for k in a),
            "within": log < POSE_LOG_TOL and pts_ok and kills and derr <= ERR_REL}


def _part_line(part: str, r: dict) -> dict:
    return {"part": part, "wall_s": r["wall_s"], "iters": r["iters"], "err": float(r["err"]),
            "kills": int(r["kill"].sum()), "finite": bool(torch.isfinite(r["poses"]).all())}


def emit(line: dict):
    print(json.dumps(line), flush=True)


def window_tables(calls) -> list:
    """Each recorded window call of part (c) timed on its own card
    (``kernels/timing.window_table``)."""
    from vslam_torch.kernels import timing

    return [{"device": str(x0.device), "B": int(x0.shape[0]), "keys": int(x0.shape[1]),
             **timing.window_table(levels, counts, x0, y0, P)} for levels, counts, x0, y0, P, _ in calls]


def run(n_devices: int, device="cuda") -> dict:
    """The whole dry run in this process: the entry's one frame, parts
    (a)-(c), their agreement with the unsharded solve and, across distinct
    cards, with virtual shards on the first card and the one-device batch;
    each card's window table. Prints a JSON line per part."""
    dev = torch.device(device)
    mesh = mesh_mod.make_mesh(n_devices, device=device)  # raises first with too few cards
    n0 = patches.LAUNCHES
    fn, args = entry(mesh.devices[0])
    n_entry = patches.LAUNCHES
    t0 = time.perf_counter()
    _, outputs = fn(*args)
    blob = outputs["blob"].cpu().numpy()
    wall = time.perf_counter() - t0
    emit({"part": "entry", "launches": patches.LAUNCHES - n_entry, "init_launches": n_entry - n0,
          "wall_s": wall, "pose": blob[:16].tolist(), "finite": bool(np.isfinite(blob[:16]).all())})
    if dev.type == "cuda":  # a card's first solve pays the libraries' set-up: time the second
        dryrun_multichip(n_devices, device=device)
    res = dryrun_multichip(n_devices, device=device)
    ref = unsharded(dryrun_problem(n_devices, mesh.devices[0]))
    distinct = len(set(res["mesh"])) > 1 and dev.type == "cuda"
    virt = dryrun_multichip(n_devices, devices=[mesh.devices[0]] * n_devices) if distinct else None
    out = {"mesh": res["mesh"]}
    for part in ("a", "b"):
        line = _part_line(part, res[part]) | {"vs_unsharded": compare(res[part], ref[part])}
        if virt is not None:
            line["vs_virtual"] = compare(res[part], virt[part])
            line["virtual_wall_s"] = virt[part]["wall_s"]
        line["unsharded_wall_s"] = ref[part]["wall_s"]
        out[part] = line
        emit(line)
    c = res["c"]
    batch = dryrun_frontend([mesh.devices[0]] * n_devices, split=False)
    line = {"part": "c", "wall_s": c["wall_s"], "devices": c["devices"], "launches": c["launches"],
            "windows": c["windows"], "finite": bool(np.isfinite(c["poses"]).all()),
            "vs_one_batch_max_dt_m": float(np.abs(c["poses"][..., :3, 3] - batch["poses"][..., :3, 3]).max())}
    if virt is not None:
        line["vs_virtual_equal"] = bool(np.array_equal(c["poses"], virt["c"]["poses"]))
    if dev.type == "cuda":
        line["tables"] = window_tables(c["calls"])
    out["c"] = line
    emit(line)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(n: int, device="cuda") -> dict:
    """Part (a) over `n` worker processes, one shard each, against the
    single-process n-shard solve. Prints one line per rank (held against
    the single process) and the single process's own line."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"{n} processes need {n} cards, one each; {torch.cuda.device_count()} visible")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    coord = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(n)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "vslam_torch.dryrun", "--worker", str(r), "--coordinator", coord,
             "--processes", str(n), "--device", dev.type, "--out", outs[r],
             "--threads", str(torch.get_num_threads())],
            env=env, cwd=root, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n)]
        try:
            _wait_all(procs, logs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        ranks = [dict(np.load(o)) for o in outs]
    p, mesh = dryrun_problem(n, "cpu" if dev.type == "cpu" else "cuda:0"), mesh_mod.make_mesh(n, device=device)
    first = _solve(p, mesh, 2, 2)  # as in each worker: the second solve is timed
    single = _solve(p, mesh, 2, 2)
    iteration = _profile_iteration(p, mesh)
    lines = []
    for r, res in enumerate(ranks):
        res_t = {k: torch.from_numpy(np.asarray(res[k])) for k in ("poses", "pts", "err", "kill")}
        line = {"part": "a", "processes": n, "rank": r, "wall_s": float(res["wall_s"]),
                "first_wall_s": float(res["first_wall_s"]), "iteration": json.loads(str(res["iteration"])),
                "iters": res["iters"].tolist(), "vs_single_process": compare(res_t, single)}
        lines.append(line)
        emit(line)
    emit({"part": "a", "processes": 1, "mesh": [str(d) for d in mesh.devices], "wall_s": single["wall_s"],
          "first_wall_s": first["wall_s"], "iters": single["iters"], "iteration": iteration})
    return {"ranks": lines, "single_process_wall_s": single["wall_s"], "single_process_first_wall_s": first["wall_s"],
            "results": ranks}


def _wait_all(procs, logs):
    """Wait for every worker; when one fails or the wall limit passes, the
    others are killed and the failure raised with its output."""
    t_end = time.monotonic() + WORKER_LIMIT_S
    while any(p.poll() is None for p in procs):
        for r, p in enumerate(procs):
            if p.poll() not in (None, 0):
                logs[r].seek(0)
                raise RuntimeError(f"dry run worker {r} exited with {p.returncode}:\n{logs[r].read()[-4000:]}")
        if time.monotonic() > t_end:
            raise TimeoutError(f"dry run workers still running after {WORKER_LIMIT_S} s")
        time.sleep(0.2)
    for r, p in enumerate(procs):
        if p.returncode:
            logs[r].seek(0)
            raise RuntimeError(f"dry run worker {r} exited with {p.returncode}:\n{logs[r].read()[-4000:]}")


def _profile_iteration(p: schur.BAProblem, mesh) -> dict:
    """One LM iteration of part (a)'s problem over `mesh` (with its first
    trial error) under the profiler: kernel launches, copy calls, device
    busy and the kernels with the most device time (on CUDA, NCCL's
    all-reduce and all-gather among them)."""
    devices = mesh.devices
    _sync(devices)
    return metrics.profile_counts(
        lambda: (schur.local_ba(p, iters=1, rel_tol=0.0, mesh=mesh), _sync(devices)), top=6)


def _worker(args):
    """One rank of the multi-process run: part (a) over the process group,
    its results written to args.out."""
    torch.set_num_threads(args.threads)
    cuda = args.device == "cuda"
    group = mesh_mod.initialize_distributed(args.coordinator, args.processes, args.worker,
                                            backend="nccl" if cuda else "gloo",
                                            timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        mesh = mesh_mod.make_mesh(device=args.device, group=group)
        p = dryrun_problem(mesh.size, mesh.devices[0])
        first = _solve(p, mesh, 2, 2)  # the first pays the card's library set-up
        r = _solve(p, mesh, 2, 2)
        np.savez(args.out, poses=r["poses"].cpu().numpy(), pts=r["pts"].cpu().numpy(),
                 err=r["err"].cpu().numpy(), kill=r["kill"].cpu().numpy(), iters=np.asarray(r["iters"]),
                 wall_s=r["wall_s"], first_wall_s=first["wall_s"],
                 iteration=json.dumps(_profile_iteration(p, mesh)))
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: every visible card; 8 virtual shards on the CPU)")
    ap.add_argument("--processes", type=int, default=1, help="worker processes, one shard each (= --devices)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        _worker(args)
        return {}
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("vslam_torch.dryrun runs on CUDA cards, and none is available")
    n = args.devices or (torch.cuda.device_count() if cuda else 8)
    if args.processes > 1:
        if args.processes != n:
            raise ValueError(f"--processes {args.processes} must equal --devices {n} (one shard a process)")
        out = run_processes(n, args.device)
    else:
        out = run(n, args.device)
    if cuda:
        from vslam_torch import bench

        out["card"] = bench.card()
        emit({"card": out["card"], "cards_visible": torch.cuda.device_count()})
    else:
        emit({"card": {"name": "cpu"}})
    return out


if __name__ == "__main__":
    main()
