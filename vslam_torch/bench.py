"""Time the port end to end on the card: the counterpart of the JAX
package's ``bench.py``, with its scenes, depths, sections and metric
names, run through vslam_torch on one CUDA device.

    python -m vslam_torch.bench

Sections, in bench.py's order, each started only while the wall-clock
budget (``BENCH_BUDGET_S``, seconds) has room for it:

1. euroc: the EuRoC-geometry stereo pipeline (752x480, seed 3, 80 frames,
   12 of warm-up; 1024 features, 8 levels, 4096 active landmarks) with
   the staged async local BA, up to 3 runs, the median fps the metric;
2. ba_solves: back-to-back synchronous local-BA solves on the newest
   keyframe of the last euroc run;
3. loop: the closed circuit (512x384, 360 frames, 1.2 laps) through
   VSlamSystem with async BA and loop closure, then one global BA;
4. kitti: the KITTI-geometry pipeline (1248x384, seed 5, 2048 features,
   40 frames, 10 of warm-up);
5. mono: monocular-inertial tracking on the lateral scene (seed 11, 60
   frames, 12 of warm-up).

Frames are rendered before each timed window (in parallel processes,
cached under ``vslam_torch/_bench_cache/`` by a key that names every
scene parameter) and staged on the card. Each timed window ends after a
device synchronize. Prints one JSON line last: ``metric``, ``value``,
``unit``, ``vs_baseline`` (against 20 fps) and ``extra``, whose keys are
bench.py's plus ``device`` (the card's name and power limit, as
nvidia-smi gives them). Unlike bench.py, a section that raises puts its
error in ``extra`` and makes the exit code 1. Needs a CUDA card: with
none, ``main()`` raises and nothing runs.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from vslam_torch.models import local_mapper, map_state, system as system_mod, tracker
from vslam_torch.utils import datasets, synthetic, trajectory
from vslam_torch.utils.config import ConfigFile

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_bench_cache")
BASELINE_FPS = 20.0  # EuRoC's 20 fps capture (bench.py:397-398)
# The wall-clock budget and the headroom each later section needs to
# start, from the section walls of two runs on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md section 6): cold (renders and kernel build
# included) euroc 121.3 s for 3 runs, ba_solves 2.2, loop 165.6, kitti
# 34.0, mono 51.0, 374.0 s in all; warm 108.7 / 2.2 / 153.7 / 17.7 / 29.5,
# 311.9 s. Each headroom is 1.5x the cold walls of the sections it guards
# (hosts differ by 30-40% in section walls), the budget 1.5x the cold
# run, rounded up: a warm or a cold run runs every section, and a slower
# host first drops a euroc repeat. bench.py's 330 / 190 / 120 / 60 / 45 s
# were TPU walls.
BUDGET_S = 600.0
EUROC_RESERVE_S = 450.0  # another euroc run + ba_solves, loop, kitti, mono
HEADROOM_S = {"loop": 380.0, "kitti": 130.0, "mono": 80.0}


def _render_chunk(scene, frames) -> list:
    return [np.stack([scene.render(f), scene.render(f, right=True)]).astype(np.uint8)
            for f in frames]


def _render_frames(scene, n_frames: int, cache_key: str) -> list:
    """The scene's first `n_frames` L+R pairs as (2, H, W) uint8 arrays, a
    camera's feed. Rendered by one process per core (the renderer is a
    numpy loop, one core a view) and cached in CACHE_DIR under
    `cache_key`, which must name every scene parameter."""
    path = os.path.join(CACHE_DIR, f"{cache_key}.npz")
    if os.path.exists(path):
        stack = np.load(path)["frames"]
        if stack.shape[0] == n_frames:
            return list(stack)
    chunks = [c for c in np.array_split(np.arange(n_frames), min(n_frames, os.cpu_count() or 1))
              if len(c)]
    with concurrent.futures.ProcessPoolExecutor(
        len(chunks), mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        frames = [fr for part in pool.map(_render_chunk, [scene] * len(chunks), chunks) for fr in part]
    os.makedirs(CACHE_DIR, exist_ok=True)
    np.savez_compressed(path, frames=np.stack(frames))
    return frames


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_pipeline(scene, params: tracker.TrackerParams, n_frames: int, warmup: int, cache_key: str,
                 device="cuda", frame_log: list | None = None):
    """Tracking with the staged async local BA (bench.py:65-156); returns
    (fps, ATE without alignment, tracker, mapper). `frame_log`, when
    given, receives per timed frame (frame, wall, consume, track, BA
    stages, keyframe?) in seconds (vslam_torch.tools.profile_bench)."""
    dev = torch.device(device)
    K = scene.K.astype(np.float32)
    world = map_state.WorldMap(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=params.n_features,
                               device=dev)
    trk = tracker.StereoTracker(K, scene.baseline, scene.width, scene.height, world, params,
                                device=dev)
    mapper = local_mapper.LocalMapper(
        world, K, scene.baseline,
        local_mapper.LocalMapperConfig(n_levels=params.n_levels, scale=params.scale),
    )
    # every frame staged on the card before the loop
    frames = [torch.from_numpy(fr).to(dev) for fr in _render_frames(scene, n_frames, cache_key)]

    # the mapping pipeline is dispatched at the keyframe and consumed at
    # least BA_LATENCY frames later, at most BA_MAX_LATENCY while the
    # worker's solve is not ready (VSlamSystem's schedule)
    pending_ba = [None, -10]  # (handle, dispatch frame)
    BA_LATENCY = 2
    BA_MAX_LATENCY = 8

    def consume_ba(f, force=False):
        if pending_ba[0] is None:
            return
        if not force:
            age = f - pending_ba[1]
            if age < BA_LATENCY:
                return
            # publish the triangulated landmarks early
            trk.add_active(mapper.consume_triangulation(pending_ba[0]))
            if age < BA_MAX_LATENCY and not local_mapper.pending_ready(pending_ba[0]):
                return
        r = mapper.finish(pending_ba[0])
        pending_ba[0] = None
        trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        trk.add_active(r["new_lm_ids"])

    def step(f):
        t0 = time.perf_counter()
        consume_ba(f)
        t1 = time.perf_counter()
        n_kf = len(trk.new_kf_slots)
        trk.track(frames[f])
        t2 = time.perf_counter()
        if pending_ba[0] is not None:
            # the next phase of a staged BA, behind this frame's step
            pending_ba[0] = mapper.advance(pending_ba[0])
        is_kf = len(trk.new_kf_slots) > n_kf
        if is_kf and trk.new_kf_slots[-1] > 0:
            consume_ba(f, force=True)  # at most one BA in flight
            pending_ba[0] = mapper.run_async_staged(trk.new_kf_slots[-1])
            pending_ba[1] = f
        if frame_log is not None:
            t3 = time.perf_counter()
            frame_log.append((f, t3 - t0, t1 - t0, t2 - t1, t3 - t2, is_kf))

    for f in range(warmup):
        n_kf = len(trk.new_kf_slots)
        trk.track(frames[f])
        # the warm-up maps synchronously, as bench.py does
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])

    _sync(dev)
    t0 = time.perf_counter()
    for f in range(warmup, n_frames):
        step(f)
    trk.flush()
    consume_ba(n_frames, force=True)
    _sync(dev)
    dt = time.perf_counter() - t0
    mapper.close()
    fps = (n_frames - warmup) / dt

    poses = trk.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    return fps, float(ate), trk, mapper


def measure_ba_solves(trk: tracker.StereoTracker, mapper: local_mapper.LocalMapper, n: int = 6) -> float:
    """Local-BA solves/s (bench.py:159-172): back-to-back synchronous
    mapper.run on the newest keyframe (triangulation, window assembly, the
    2-round Schur BA, write-back, host fetch), one untimed run first."""
    slots = [s for s in trk.new_kf_slots if s > 0]
    if not slots:
        return 0.0
    slot = slots[-1]
    dev = trk.world.device
    mapper.run(slot)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        mapper.run(slot)
    _sync(dev)
    return n / (time.perf_counter() - t0)


def run_mono_pipeline(n_frames: int = 60, warmup: int = 12, device="cuda"):
    """Monocular-inertial tracking (bench.py:175-241) on the lateral scene;
    returns (fps, ATE without alignment, tracker). The left views are
    staged on the card before the loop."""
    dev = torch.device(device)
    scene = synthetic.make_scene(
        n_frames=n_frames, n_points=900, width=752, height=480, fps=20.0,
        seed=11, texture="distinct", motion="lateral",
    )
    K = scene.K.astype(np.float32)
    world = map_state.WorldMap(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024, device=dev)
    params = tracker.TrackerParams(n_features=1024, n_levels=8, active_size=4096)
    imu_cfg = tracker.ImuConfig(
        gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3,
        hz=200.0, T_bc=np.eye(4, dtype=np.float32),
        gravity_w=synthetic.GRAVITY_W.astype(np.float32),
    )
    trk = tracker.MonoTracker(K, scene.width, scene.height, world, params, imu_cfg=imu_cfg,
                              device=dev)
    trk.velocity = scene.velocities[0].astype(np.float32)
    mapper = local_mapper.LocalMapper(
        world, K, 0.0,
        local_mapper.LocalMapperConfig(n_levels=params.n_levels, scale=params.scale),
    )
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)

    def dt_rows(f):
        rows = bins[f]
        if rows is None or len(rows) == 0:
            return None
        t = rows[:, 0]
        dts = np.diff(np.concatenate([[t[0] - 1.0 / 200.0], t]))
        return np.concatenate(
            [np.maximum(dts, 0)[:, None], rows[:, 1:7]], axis=1
        ).astype(np.float32)

    pairs = _render_frames(scene, n_frames, f"mono_752x480_s11_p900_f{n_frames}_lat_distinct")
    frames = [torch.from_numpy(fr[0]).to(dev) for fr in pairs]

    def step(f):
        nk = len(trk.new_kf_slots)
        trk.track(frames[f], imu=dt_rows(f))
        if trk.needs_init_triangulation:
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            trk.add_active(ids)
            trk.needs_init_triangulation = False
            trk.last_kf_tracked = max(len(ids), 1)
        elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
            trk.add_active(mapper.find_new_points(trk.new_kf_slots[-1], mono=True))

    for f in range(warmup):
        step(f)
    _sync(dev)
    t0 = time.perf_counter()
    for f in range(warmup, n_frames):
        step(f)
    trk.flush()
    _sync(dev)
    fps = (n_frames - warmup) / (time.perf_counter() - t0)
    poses = trk.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    return fps, float(ate), trk


def run_loop_circuit(n_frames: int = 360, device="cuda"):
    """The closed circuit through the facade with loop closure on
    (bench.py:244-309); returns (closures, live ATE, ATE after one global
    BA). The config is bench.py's YAML as a dict (the card's machine is not
    promised PyYAML)."""
    W, H = 512, 384
    loops, wall_radius = 1.2, 10.0
    scene = synthetic.make_loop_scene(
        n_frames=n_frames, width=W, height=H, loops=loops, wall_radius=wall_radius,
    )
    cache_key = f"loop_{W}x{H}_s0_f{n_frames}_l{int(loops * 10)}_wr{int(wall_radius)}"
    cam = {"fx": 460.0, "fy": 460.0, "cx": W / 2, "cy": H / 2}
    conf = ConfigFile.from_dict({
        "rectified": True, "slamMode": 1, "dataset": "KITTI", "imagesPath": "/x",
        "fileExtension": ".png",
        "Camera": {"width": W, "height": H, "fps": 10.0, "bl": 0.12},
        "Camera_l": dict(cam), "Camera_r": dict(cam),
        "FE": {"nFeatures": 1024, "nLevels": 8, "imScale": 1.2, "edgeThreshold": 19,
               "maxFastThreshold": 20, "minFastThreshold": 7},
    })
    # an active set smaller than the map forces the loop-closure path
    sys_ = system_mod.VSlamSystem(
        conf, async_ba=True, lm_capacity=1 << 15, kf_capacity=256, loop_closure=True,
        tracker_params=tracker.TrackerParams(n_features=1024, n_levels=8, active_size=1024),
        device=device,
    )
    # the section reports ATE: consume at a fixed latency, reproducibly
    sys_.deterministic_ba_latency = True
    dev = torch.device(device)
    frames = [torch.from_numpy(fr).to(dev) for fr in _render_frames(scene, n_frames, cache_key)]
    for fr in frames:
        sys_.track_stereo(fr[0], fr[1])
    sys_.exit()
    poses = sys_.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    # run_synthetic's --global-ba: one full-map polish, reported beside the live number
    sys_.global_ba()
    poses2 = sys_.trajectory()
    ate_gba = trajectory.ate_rmse(poses2, scene.poses_c2w[: len(poses2)], align=False)
    return int(sys_.loop_closer.closures), float(ate), float(ate_gba)


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def main() -> int:
    """Run the sections and print the JSON line; returns the exit code (1
    when a section after euroc raised)."""
    if not torch.cuda.is_available():
        raise RuntimeError("vslam_torch.bench times the port on a CUDA card, and none is available")
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", BUDGET_S))
    section_wall = {}
    last_mark = [t_start]

    def mark(name):
        now = time.perf_counter()
        section_wall[name] = now - last_mark[0]
        last_mark[0] = now

    def elapsed():
        return time.perf_counter() - t_start

    card_info = card()
    n_frames, warmup = 80, 12
    scene = synthetic.make_scene(
        n_frames=n_frames, n_points=900, width=752, height=480, fps=20.0, seed=3
    )
    params = tracker.TrackerParams(n_features=1024, n_levels=8, active_size=4096)
    runs = []
    for _ in range(3):
        runs.append(run_pipeline(scene, params, n_frames, warmup, "euroc_752x480_s3_p900_f80"))
        if elapsed() > budget_s - EUROC_RESERVE_S:
            break
    mark("euroc")
    fps_samples = sorted(r[0] for r in runs)
    fps = fps_samples[len(fps_samples) // 2]  # median
    ate, trk, mapper = runs[-1][1], runs[-1][2], runs[-1][3]
    extra = {
        "fps_samples": fps_samples,
        "ate_rmse_m_synthetic": ate,
        "n_keyframes": trk.world.n_keyframes,
        "n_landmarks": trk.world.n_landmarks,
        "ba_runs": mapper.ba_count,
    }
    failed = False
    try:
        extra["local_ba_solves_per_s"] = measure_ba_solves(trk, mapper)
        track_stats = trk.metrics.summary().get("track", {})
        extra["track_ms_p50"] = track_stats.get("p50_ms")
        extra["track_ms_p90"] = track_stats.get("p90_ms")
        mark("ba_solves")

        if elapsed() < budget_s - HEADROOM_S["loop"]:
            closures, ate_lc, ate_lc_gba = run_loop_circuit()
            extra["loop_closures"] = closures
            extra["loop_circuit_ate_rmse_m"] = ate_lc
            extra["loop_circuit_ate_post_gba_m"] = ate_lc_gba
            mark("loop")
        else:
            extra["loop_skipped"] = "over time budget"

        if elapsed() < budget_s - HEADROOM_S["kitti"]:
            nk, wk = 40, 10
            scene_k = synthetic.make_scene(
                n_frames=nk, n_points=900, width=1248, height=384, fps=10.0, seed=5
            )
            params_k = tracker.TrackerParams(n_features=2048, n_levels=8, active_size=4096)
            fps_kitti, ate_kitti, _, _ = run_pipeline(
                scene_k, params_k, nk, wk, "kitti_1248x384_s5_p900_f40"
            )
            extra["kitti_2048feat_fps"] = fps_kitti
            extra["kitti_vs_10fps_target"] = fps_kitti / 10.0
            extra["kitti_ate_rmse_m"] = ate_kitti
            mark("kitti")
        else:
            extra["kitti_skipped"] = "over time budget"

        if elapsed() < budget_s - HEADROOM_S["mono"]:
            fps_m, ate_m, _ = run_mono_pipeline()
            extra["mono_imu_fps"] = fps_m
            extra["mono_imu_ate_rmse_m"] = ate_m
            extra["mono_ate_gate_0p05"] = bool(ate_m <= 0.05)
            mark("mono")
        else:
            extra["mono_skipped"] = "over time budget"
    except Exception as e:  # the line still prints, and the exit code says it failed
        traceback.print_exc()
        extra["optional_section_error"] = repr(e)[:200]
        failed = True

    extra["section_wall_s"] = section_wall
    extra["wall_s"] = elapsed()
    extra["device"] = card_info
    print(json.dumps({
        "metric": "tracked_frames_per_s_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / BASELINE_FPS,
        "extra": extra,
    }), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
