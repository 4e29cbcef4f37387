#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vslam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (nvcc). It exits non-zero, and prints no result, when there is no
CUDA device or the port cannot be imported. Phases, each printed on its
own line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel under vslam_torch/kernels/csrc, compiled with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card
   (torch.equal required): extract_windows at every bench level shape, at
   an odd shape and with out-of-range corners, and extract_windows_levels
   on frame 0's full 8-level table, as the main path calls it, for the
   bench configuration, for the KITTI one (1248x384, 2048 features,
   seed 5; the synthetic driver's table), for the mono one (one view,
   752x480, 1024 features, frame 0 of phase 13's scene), for the loop
   circuit (512x384, 1024 features, frame 0 of phase 16's scene) and for
   KITTI 00's published camera (1241x376, 2048 features, seed 6, every
   level an odd width; phase 17's table). Then each table's
   one launch is
   timed: device time on a primed stream and host time per call
   (vslam_torch/kernels/timing.py), against the plain version, one
   advanced-indexing call per level (the library yardstick) and the bound
   from the bytes the frame must move;
4. main path: StereoTracker (no mapper) over 16 frames of the synthetic
   EuRoC-geometry scene at the bench configuration (752x480, seed 3,
   1024 features, 8 levels, 4096 active landmarks) on the card; kernel
   launch counts (one per frame), fps, keyframes, landmarks, ATE against
   exact ground truth (must be <= 0.05 m);
5. card vs CPU: the first 8 frames again on the card and on the CPU (the
   plain versions); keyframe slots must be equal, per-frame poses within
   1e-3 m / 1e-3 rad;
6. system: VSlamSystem (tracker + the synchronous local mapper at every
   keyframe: triangulation, the 2-round Schur BA, the write-back) on the
   card over the first 40 frames of the bench's 80-frame scene (752x480,
   seed 3, 900 points, 20 fps; the bench's tracker parameters and map
   capacities), frames
   staged on the card: fps, per-frame and per-BA wall p50/p90, LM
   iterations, keyframes, landmarks, killed observations, ATE (must be
   <= 0.05 m; phase 4's tracker-only ATE beside it), extract_windows
   launches (one per frame, 40) and plain calls on the card (0), peak
   device memory; then the same run again, which must give the same
   trajectory bit for bit;
7. BA: the last window that phase 6 solved, as a BAProblem, solved twice
   on the card (results must be bit-identical) and once on the CPU (poses
   within 1e-4 m / 1e-4 rad, the kill mask identical except rows whose
   chi2 lies within 1e-3 relative of the threshold on both sides, which
   are printed); wall time per solve, LM iterations per round, and the
   kernel launches, stream syncs and device busy time of one solve and
   of each piece of an LM iteration (torch.profiler); then the same for
   one whole LocalMapper.run on the final map and for the
   triangulation's batched eigh alone;
8. system card vs CPU: the first 12 frames through the facade on the card
   and on the CPU; the same keyframe slots and BA count, poses within
   1e-3 m / 1e-3 rad;
9. async system: phase 6's scene, capacities and tracker parameters
   through VSlamSystem(async_ba=True) with deterministic_ba_latency (the
   BA solved on the mapper's worker thread and side stream): fps beside
   phase 6's, tracker frame p50/p90, the seconds the main thread was
   blocked joining the worker and the worker's wall per BA, BA runs,
   keyframes, landmarks, ATE (must be <= 0.05 m), extract_windows
   launches (40) and plain calls (0); then the same run again, which must
   give the same trajectory bit for bit, and one readiness-polled run
   (deterministic_ba_latency off), which must complete with its ATE <=
   0.05 m and nothing pending after exit();
10. async card vs CPU: the first 12 frames through the async facade on
   the card and on the CPU; the same keyframe slots and BA count, poses
   within 1e-3 m / 1e-3 rad;
11. STEREO_IMU: the same 40 frames with slamMode 0, the IMU block of
   examples/run_synthetic.py, the scene's gravity and initial velocity
   and its IMU samples binned per frame, with the sync mapper: fps, ATE
   (must be <= 0.08 m), keyframes, BA runs, extract_windows launches
   (40), the 15-dof solves per frame and the kernel launches and stream
   syncs of one solve and of one preintegration (torch.profiler); then 8
   frames on the card and on the CPU, the same keyframe slots, poses
   within 1e-3 m / 1e-3 rad;
12. driver: python -m vslam_torch.run_synthetic --scene kitti --global-ba
   --frames 20 (1248x384, 2048 features, async BA, then one
   BA over the whole map) and --scene mono --frames 24 on the card: their
   [result] fields, ATE <= 0.05 m (before and after the global BA),
   extract_windows launches (20; mono: bootstrap views + tracked frames)
   and plain calls (0);
13. mono: VSlamSystem in slamMode 2 (MonoTracker: the IMU bootstrap, the
   init triangulation, mono triangulation at every keyframe) on the card
   over the bench's lateral mono scene (752x480, seed 11, 900 points,
   20 fps, the first 40 of its 60 frames, distinct texture;
   bench.py:175-241), frames staged on
   the card: fps, frame p50/p90, bootstrap views and gates, the landmark
   count of every mono triangulation and the init's own (the call made
   while needs_init_triangulation is set), keyframes, landmarks, ATE (must be <= 0.05 m, bench.py:418's
   gate), extract_windows launches (bootstrap views + tracked frames) and
   plain calls (0); the same run again, bit for bit; then card vs CPU on
   the first 16 frames (the same slots, poses within 1e-3 m / 1e-3 rad);
14. recovery: StereoTracker on the bench scene at 752x480: frames 0-7, 6
   black frames, frames 0-7 again must relocalize once, the last 3 poses
   within 0.15 m of the truth; the retrieval's votes and slot, and the
   launches, syncs and wall of one retrieve; then seed 3, 3 black frames,
   seed 23 must re-seed, the relative motion after it within 0.15 m;
15. global BA: VSlamSystem.global_ba after phase 6's run (wall, LM
   iterations, ATE before and after; launches, syncs and device busy of a
   second run_global), then run_global on a 256-keyframe, 50,000-landmark
   corridor map (1024 keys per keyframe; utils/synthetic.corridor_map)
   with drifted poses, which must take 8 landmark slabs and meet
   tests/test_ba.py:264-283 (error < 0.01 per observation, relative error
   < 0.7x the drifted one): wall, peak memory, and the launches of one
   slabbed LM iteration. Phase 7 also solves its window with the Schur
   reduction in 4 slabs against 1 (poses within 5e-4, points within 5e-3
   over the landmarks whose 3x3 block is conditioned, errors within 1e-3
   relative, the same kill mask; the worst landmark's rows, block
   eigenvalues and move against its ray printed);
16. loop: the bench's loop circuit (bench.py:244-309: make_loop_scene at
   512x384, 360 frames, 1.2 laps, wall radius 10 m; 1024 features, active
   set 1024, 32768 landmark and 256 keyframe slots, async BA at a fixed
   latency, loop closure on), frames staged on the card: fps, frame
   p50/p90, keyframes, landmarks, each applied closure (slots, frames,
   pose-graph path, merges, error, wall of its close), the detections'
   and the polishes' walls, closures (>= 1), ATE live (< 0.06 m) and after
   global_ba() (< max(1.1 x live, 0.05) m; tests/test_loop_closure.py:583,
   587), extract_windows launches (360) and plain calls (0); the first
   applied closure replayed twice from a copy of the map taken before it
   (the written maps bit-identical); the split-map closures of
   tests/test_loop_closure.py:374-456 (stereo, and mono through the
   Sim(3) graph) on the card and on the CPU (the same candidate, merge
   pairs and n_merged, poses within 1e-4 m / 1e-4 rad); one
   optimize_chain on the 2048-pose chain of tests/test_loop_closure.py:224
   (wall, iterations, launches and syncs per iteration, the drift it
   recovers: > 90%);
17. dataset: python -m vslam_torch.run_dataset (main called in-process) on
   frames written as uint8 PNGs. KITTI layout at KITTI 00's 1241x376
   (40 frames, seed 6, 900 points, 10 fps; config_kitti_00.yaml's FE block,
   the scene's intrinsics and baseline): run (a) with async BA, global BA,
   the live viewer every 5 keyframes, the PLY, overlays every 10 frames
   and a checkpoint every 5 keyframes (ATE <= 0.08 m, 40 launches, 0 plain
   calls, the outputs present; the last checkpoint loaded into a CPU world
   torch.equal to the card's map when it was written); run (b) to frame
   20 with a checkpoint, then --resume to frame 40 (within 0.05 m of run
   (a)); the native reader against PIL on 12 frames (identical
   trajectories). EuRoC layout, STEREO_IMU (752x480, seed 3, 30 frames
   from rest, MH_01's FE and IMU blocks, an unrectified identity rig, the
   scene's gravity): the host uint8 remap of the native reader and the
   device remap (ATE <= 0.08 m each, 30 launches). Where the machine has
   no g++ or no png.h, the native reader cannot build: the runs take
   --no-prefetch, the build error is printed and the native-only checks
   are skipped.

Frames are rendered on the host by 8 processes forked at start-up,
before CUDA is initialized, and stopped at the end.

The second-to-last line is the kernel report {"kernels": [...]}, the last
line {"ok": true, "device": {...}}. Nothing is caught: any failure raises.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vslam_torch import kernels, native, run_dataset, run_synthetic
from vslam_torch.geometry import se3, triangulate
from vslam_torch.kernels import timing
from vslam_torch.models import local_mapper, loop_closure, map_state, pose_graph, reloc, system, tracker
from vslam_torch.ops import extract, imu, lm, patches, pyramid, schur
from vslam_torch.utils import checkpoint as ckpt_io, datasets, synthetic, trajectory
from vslam_torch.utils.config import ConfigFile

# the bench configuration (bench.py:341-345) and its scene
# phase 4 runs 16 frames: with phase 16 the whole script took 1372 s of
# its 1200 s limit at 40 (PERF.md section 4)
WIDTH, HEIGHT, SEED, N_FRAMES = 752, 480, 3, 16
PARAMS = dict(n_features=1024, n_levels=8, active_size=4096)
WORLD = dict(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)
PATCH = 31
ATE_GATE_M = 0.05
CPU_FRAMES = 8
POSE_TOL_M, POSE_TOL_RAD = 1e-3, 1e-3
# the system phases: the bench's scene and map capacities (bench.py:65-72, 341-345)
# phases 6, 9 and 11 run the first 40 of the 80-frame scene, phase 13 the
# first 40 of its 60 and phase 12's KITTI driver 20 frames: with phase 17
# the whole script took 1265 s of its 1200 s limit (PERF.md section 4)
SYS_SCENE_FRAMES, SYS_FRAMES, SYS_CPU_FRAMES = 80, 40, 12
SYS_CAPS = dict(lm_capacity=1 << 15, kf_capacity=128)
BA_TOL_M, BA_TOL_RAD, CHI2_BAND = 1e-4, 1e-4, 1e-3
# the STEREO_IMU phase: tests/test_system.py:229's gate, 8 frames card vs CPU
IMU_ATE_GATE_M, IMU_CPU_FRAMES = 0.08, 8
# the synthetic driver's KITTI scene (vslam_torch/run_synthetic.py)
KITTI_W, KITTI_H, KITTI_SEED, KITTI_FEATURES, KITTI_FRAMES = 1248, 384, 5, 2048, 20
# the bench's mono-IMU scene (bench.py:175-241) and its gate (bench.py:418)
MONO_SEED, MONO_FRAMES, MONO_CPU_FRAMES, MONO_DRIVER_FRAMES = 11, 40, 16, 24
MONO_SCENE = dict(n_frames=60, n_points=900, width=WIDTH, height=HEIGHT, fps=20.0, seed=MONO_SEED,
                  texture="distinct", motion="lateral")
# recovery (tests/test_tracking.py:323-409's sequences on the bench scene)
RECOVERY_GATE_M = 0.15
# map-scale global BA (tests/test_ba.py:231-283)
MAP_KF, MAP_LM, MAP_SLABS = 256, 50_000, 8
# the bench's loop circuit (bench.py:244-309) and its gates
# (tests/test_loop_closure.py:583, 587)
LOOP_W, LOOP_H, LOOP_FRAMES = 512, 384, 360
LOOP_SCENE = dict(n_frames=LOOP_FRAMES, width=LOOP_W, height=LOOP_H, loops=1.2, wall_radius=10.0)
LOOP_PARAMS = dict(n_features=1024, n_levels=8, active_size=1024)
LOOP_CAPS = dict(lm_capacity=1 << 15, kf_capacity=256)
LOOP_ATE_GATE_M, LOOP_GBA_FLOOR_M = 0.06, 0.05
# the split-map closures (tests/test_loop_closure.py:374-456): scale_err, baseline
SPLIT_CASES = {"stereo": (1.0, 0.12), "mono": (0.9, 0.0)}
# the 2048-pose chain (tests/test_loop_closure.py:224-271)
CHAIN_P = 2048
# phase 17: the dataset driver (vslam_torch/run_dataset.py) on frames written
# as uint8 PNGs in the KITTI and EuRoC layouts. KITTI 00's published camera
# and FE block (configs/config_kitti_00.yaml:33-45); the EuRoC layout gets
# MH_01's FE and IMU blocks (configs/config_MH_01.yaml:9-15, 96-102). Seed
# 6: on seed 5's 8-bit frames at this shape both packages lose track at
# frame 25 (tests/test_torch_run_dataset.py::test_kitti00_shape_against_jax)
DS_KITTI_W, DS_KITTI_H, DS_KITTI_SEED, DS_KITTI_FRAMES = 1241, 376, 6, 40
DS_KITTI_FE = dict(nFeatures=2000, nLevels=8, imScale=1.2, edgeThreshold=19,
                   maxFastThreshold=20, minFastThreshold=7)
# the EuRoC run starts from rest (synthetic.make_scene's ramp_tau, as the
# on-disk EuRoC drives of tests/test_fullscale.py do): the driver, like the
# reference's, starts the IMU solve at zero velocity, as a real EuRoC
# capture does; a scene at full speed from frame 0 leaves STEREO_IMU stuck
DS_EUROC_FRAMES, DS_EUROC_RAMP_TAU = 30, 0.5
DS_EUROC_FE = dict(nFeatures=1000, nLevels=8, imScale=1.2, edgeThreshold=19,
                   maxFastThreshold=20, minFastThreshold=7)
DS_EUROC_IMU = dict(Hz=200, gyroscope_noise_density=1.6968e-04, gyroscope_random_walk=1.9393e-05,
                    accelerometer_noise_density=2.0e-3, accelerometer_random_walk=3.0e-3)
DS_RESUME_AT, DS_DECODE_FRAMES = 20, 12
DS_ATE_GATE_M = 0.08  # tests/test_driver.py:118's gate for uint8 PNG input
DS_RESUME_GAP_M = 0.05  # tests/test_driver.py:150


T0 = time.perf_counter()


def say(phase: str, **fields):
    """One phase's line; `t_s` is the script's elapsed wall time."""
    print(f"[{phase}] " + json.dumps({**fields, "t_s": time.perf_counter() - T0}), flush=True)


RENDER_WORKERS = 8  # processes that render frames (the chip machine has 8 cores)
_POOL = None  # the renderers, forked at start-up, before CUDA is initialized


def _render_frames(scene, frames, stereo: bool) -> list:
    return [np.stack([scene.render(f), scene.render(f, right=True)]) if stereo else scene.render(f)
            for f in frames]


def _render(scene, n: int, stereo: bool = True) -> list:
    """Frames 0..n-1 of `scene` ((2, H, W) L+R pairs, or (H, W) views),
    rendered by the pool (the renderer is a Python loop over patches, one
    core per view)."""
    chunks = [c for c in np.array_split(np.arange(n), 4 * RENDER_WORKERS) if len(c)]
    parts = _POOL.map(_render_frames, [scene] * len(chunks), chunks, [stereo] * len(chunks))
    return [v for part in parts for v in part]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    path, seconds = kernels.build()
    kernels.library()
    say("build", library=str(path.relative_to(path.parents[3])), nvcc_seconds=round(seconds, 3))


def _level_inputs(scene, dev, height=HEIGHT, width=WIDTH, n_features=PARAMS["n_features"],
                  seed=SEED, mono=False):
    """The main path's inputs to extract_windows for frame 0: every level's
    blurred L+R image (the left one alone with `mono`), the level quota of
    keys, corners from a seeded generator including the extreme corners."""
    views = [scene.render(0)] if mono else [scene.render(0), scene.render(0, right=True)]
    imgs = torch.from_numpy(np.stack(views)).to(dev)
    B = imgs.shape[0]
    shapes = pyramid.level_shapes(height, width, PARAMS["n_levels"], 1.2)
    quotas = extract.level_quotas(n_features, PARAMS["n_levels"], 1.2)
    rng = np.random.default_rng(seed)
    cur, cases = imgs, []
    for lvl, ((h, w), q) in enumerate(zip(shapes, quotas)):
        if lvl:
            cur = pyramid.resize_bilinear_batch(cur, h, w)
        if q <= 0:
            continue
        x0 = rng.integers(0, w - PATCH + 1, size=(B, q)).astype(np.int32)
        y0 = rng.integers(0, h - PATCH + 1, size=(B, q)).astype(np.int32)
        x0[:, :2], y0[:, :2] = [0, w - PATCH], [0, h - PATCH]
        cases.append((f"L{lvl} {h}x{w} q={q}", pyramid.gaussian_blur_batch(cur).contiguous(),
                      torch.from_numpy(x0).to(dev), torch.from_numpy(y0).to(dev), PATCH, PATCH))
    return cases


def _out_of_range(x0, y0):
    """Corners with entries far outside the image on both sides."""
    xb, yb = x0.clone(), y0.clone()
    xb[0, 0], yb[0, 0] = 100_000, -7
    xb[-1, -1], yb[-1, -1] = -50, 1_000_000
    return xb, yb


def phase_kernels(scene, dev, smi) -> dict:
    cases = _level_inputs(scene, dev)
    # one odd shape: q not a multiple of anything, a non-square window
    rng = np.random.default_rng(SEED + 1)
    img = torch.rand((2, HEIGHT, WIDTH), device=dev) * 255.0
    x0 = torch.from_numpy(rng.integers(0, WIDTH - 21 + 1, size=(2, 37)).astype(np.int32)).to(dev)
    y0 = torch.from_numpy(rng.integers(0, HEIGHT - 11 + 1, size=(2, 37)).astype(np.int32)).to(dev)
    x0[:, 0], y0[:, 0] = WIDTH - 21, HEIGHT - 11
    odd = ("odd 480x752 q=37 11x21", img, x0, y0, 11, 21)
    agree, errs = _agreement()
    for name, img, x0, y0, P, Pw in cases + [odd]:
        agree(name, patches.extract_windows(img, x0, y0, P, Pw),
              patches.extract_windows_ref(img, x0, y0, P, Pw))
        xb, yb = _out_of_range(x0, y0)
        agree(name + " clamped", patches.extract_windows(img, xb, yb, P, Pw),
              patches.extract_windows_ref(img, xb, yb, P, Pw))
        say("kernel", name="extract_windows", shape=name, equal=True, clamped_equal=True)
    t = _table(cases, agree, smi, "frame 0, 8 levels, L+R, one launch")
    return {"max_abs_err": max(errs), **t}


def phase_kernels_kitti(dev, smi) -> dict:
    """extract_windows_levels on frame 0's table of the driver's KITTI scene."""
    scene = synthetic.make_scene(n_frames=1, n_points=900, width=KITTI_W, height=KITTI_H,
                                 fps=10.0, seed=KITTI_SEED)
    cases = _level_inputs(scene, dev, KITTI_H, KITTI_W, KITTI_FEATURES, KITTI_SEED)
    agree, errs = _agreement()
    t = _table(cases, agree, smi, f"KITTI {KITTI_W}x{KITTI_H}, {KITTI_FEATURES} keys, frame 0, "
                                  "8 levels, L+R, one launch")
    return {"max_abs_err": max(errs), **t}


def phase_kernels_kitti00(dev, smi) -> dict:
    """extract_windows_levels on frame 0's table of phase 17's KITTI run at
    KITTI 00's published 1241x376 (odd widths at every level)."""
    scene = synthetic.make_scene(n_frames=1, n_points=900, width=DS_KITTI_W, height=DS_KITTI_H,
                                 fps=10.0, seed=DS_KITTI_SEED)
    cases = _level_inputs(scene, dev, DS_KITTI_H, DS_KITTI_W, KITTI_FEATURES, DS_KITTI_SEED)
    agree, errs = _agreement()
    t = _table(cases, agree, smi, f"KITTI 00 {DS_KITTI_W}x{DS_KITTI_H}, {KITTI_FEATURES} keys, "
                                  "frame 0, 8 levels, L+R, one launch")
    return {"max_abs_err": max(errs), **t}


def phase_kernels_mono(dev, smi) -> dict:
    """extract_windows_levels on frame 0's one-view table of the mono scene."""
    scene = synthetic.make_scene(**{**MONO_SCENE, "n_frames": 1})
    cases = _level_inputs(scene, dev, seed=MONO_SEED, mono=True)
    agree, errs = _agreement()
    t = _table(cases, agree, smi, f"mono {WIDTH}x{HEIGHT}, {PARAMS['n_features']} keys, frame 0, "
                                  "8 levels, one view (B=1), one launch")
    return {"max_abs_err": max(errs), **t}


def phase_kernels_loop(scene, dev, smi) -> dict:
    """extract_windows_levels on frame 0's table of the loop circuit."""
    cases = _level_inputs(scene, dev, LOOP_H, LOOP_W, LOOP_PARAMS["n_features"], seed=0)
    agree, errs = _agreement()
    t = _table(cases, agree, smi, f"loop circuit {LOOP_W}x{LOOP_H}, {LOOP_PARAMS['n_features']} keys, "
                                  "frame 0, 8 levels, L+R, one launch")
    return {"max_abs_err": max(errs), **t}


def _agreement():
    """A check that a kernel's output is torch.equal to its plain version,
    and the list of the max abs errors it has seen."""
    errs = [0.0]

    def agree(name, out, ref):
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"extract_windows != plain version at {name}")
        errs.append(float((out - ref).abs().max()))

    return agree, errs


def _table(cases, agree, smi, shape) -> dict:
    """Frame 0's full table, as extract_batch calls it (one launch): held
    to the plain version (also with out-of-range corners), then timed."""
    P = PATCH
    levels = [c[1] for c in cases]
    counts = [c[2].shape[1] for c in cases]
    x0 = torch.cat([c[2] for c in cases], 1)
    y0 = torch.cat([c[3] for c in cases], 1)
    xb, yb = _out_of_range(x0, y0)
    for tag, (xc, yc) in (("", (x0, y0)), (" clamped", (xb, yb))):
        agree("8-level table" + tag, patches.extract_windows_levels(levels, counts, xc, yc, P, P),
              patches.extract_windows_levels_ref(levels, counts, xc, yc, P, P))

    n0 = patches.LAUNCHES
    patches.extract_windows_levels(levels, counts, x0, y0, P, P)
    launches_per_frame = patches.LAUNCHES - n0
    idx = timing.gather_index(levels, counts, x0, y0, P)
    frame_bytes, covered = timing.window_bytes(idx, x0, P)
    bound_ms = frame_bytes / timing.HBM_BYTES_PER_S * 1e3

    def stage():
        patches.extract_windows_levels(levels, counts, x0, y0, P, P)

    def plain():
        patches.extract_windows_levels_ref(levels, counts, x0, y0, P, P)

    def library():
        for img, ix in idx:
            img[ix]

    t = {
        "launches_per_frame": launches_per_frame,
        "device_ms": timing.primed_device_ms(stage),
        "host_ms_per_call": timing.host_ms_per_call(stage),
        "plain_ms": timing.primed_device_ms(plain, reps=4),
        "library_ms": timing.primed_device_ms(library, reps=8),
        "bound_ms": bound_ms,
    }
    say("kernel", name="extract_windows", shape=shape, card=smi, frame_bytes=frame_bytes,
        covered_pixels=covered, equal=True, clamped_equal=True, **t)
    return t


def _run_tracker(scene, frames, device):
    world = map_state.WorldMap(**WORLD, device=device)
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, WIDTH, HEIGHT, world,
        tracker.TrackerParams(**PARAMS), device=device,
    )
    for fr in frames:
        trk.track(fr)
    poses = trk.trajectory()
    return trk, poses


def phase_main_path(scene) -> tuple[int, list, float]:
    t0 = time.perf_counter()
    pairs = _render(scene, N_FRAMES)
    render_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    # stage every frame pair on the card ahead of the loop, as bench.py does
    frames = [torch.from_numpy(p).to(dev) for p in pairs]
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    with _plain_calls() as plain_devices:
        patches.LAUNCHES = 0
        t0 = time.perf_counter()
        trk, poses = _run_tracker(scene, frames, dev)
        torch.cuda.synchronize()
        track_s = time.perf_counter() - t0
        launches, plain_calls = patches.LAUNCHES, len(plain_devices)

    want = N_FRAMES  # one launch per stereo frame, every level
    if launches != want:
        raise AssertionError(f"extract_windows launched {launches} times, want {want}")
    if plain_calls:
        raise AssertionError(f"the plain window gather ran {plain_calls} times ({plain_devices})")
    if poses.shape != (N_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory {poses.shape}")
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:N_FRAMES], align=False)
    stages = trk.metrics.summary()
    say("main_path", frames=N_FRAMES, fps=N_FRAMES / track_s, track_s=track_s,
        render_s=render_s, keyframes=len(trk.new_kf_slots), landmarks=trk.world.n_landmarks,
        ate_m=ate, extract_windows_launches=launches, plain_calls_on_card=plain_calls,
        track_p50_ms=stages["track"]["p50_ms"], track_p90_ms=stages["track"]["p90_ms"],
        peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    if not ate <= ATE_GATE_M:
        raise AssertionError(f"ATE {ate} m > {ATE_GATE_M} m")
    return launches, pairs, ate


def _pose_diff(a: np.ndarray, b: np.ndarray):
    """Per-pose translation distance and relative rotation angle (from the
    skew part and the trace: arccos of the trace alone cannot resolve
    angles below ~3e-4 rad in float32)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    R = np.einsum("fji,fjk->fik", a[:, :3, :3], b[:, :3, :3])
    skew = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    ang = np.arctan2(0.5 * np.linalg.norm(skew, axis=1), 0.5 * (np.trace(R, axis1=1, axis2=2) - 1.0))
    return dt, ang


def phase_card_vs_cpu(scene, pairs):
    sub = pairs[:CPU_FRAMES]
    t_gpu, p_gpu = _run_tracker(scene, [torch.from_numpy(p).cuda() for p in sub], "cuda")
    t_cpu, p_cpu = _run_tracker(scene, [torch.from_numpy(p) for p in sub], "cpu")
    if t_gpu.new_kf_slots != t_cpu.new_kf_slots:
        raise AssertionError(f"keyframes differ: card {t_gpu.new_kf_slots} cpu {t_cpu.new_kf_slots}")
    n = t_gpu.world.n_keyframes
    if not np.array_equal(t_gpu.world.kf_frame_idx[:n], t_cpu.world.kf_frame_idx[:n]):
        raise AssertionError("keyframes fired at different frames on card and CPU")
    dt, ang = _pose_diff(p_gpu, p_cpu)
    say("card_vs_cpu", frames=CPU_FRAMES, keyframes=t_gpu.new_kf_slots,
        max_dt_m=float(dt.max()), max_drot_rad=float(ang.max()))
    if dt.max() > POSE_TOL_M or ang.max() > POSE_TOL_RAD:
        raise AssertionError(f"card and CPU poses differ: {dt.max()} m, {ang.max()} rad")


def _system(scene, device, async_ba=False, imu=False):
    """The facade at the bench configuration, from a config in the
    reference's schema (a rectified rig matching the scene). `async_ba`:
    the async mapper with deterministic_ba_latency. `imu`: STEREO_IMU with
    the IMU block of examples/run_synthetic.py, the scene's gravity and its
    initial velocity."""
    K = scene.K
    cam = {"fx": float(K[0, 0]), "fy": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2])}
    cfg = {
        "rectified": True, "slamMode": 0 if imu else 1, "Camera_l": dict(cam), "Camera_r": dict(cam),
        "Camera": {"width": WIDTH, "height": HEIGHT, "fps": 20.0, "bl": float(scene.baseline)},
        "FE": {"nFeatures": PARAMS["n_features"], "nLevels": PARAMS["n_levels"], "imScale": 1.2},
    }
    if imu:
        cfg["IMU"] = run_synthetic.config(WIDTH, HEIGHT, 20.0, PARAMS["n_features"], 0)["IMU"]
    sys_ = system.VSlamSystem(
        ConfigFile.from_dict(cfg), async_ba=async_ba, **SYS_CAPS,
        tracker_params=tracker.TrackerParams(**PARAMS), device=device,
    )
    sys_.deterministic_ba_latency = True
    if imu:
        sys_.tracker.set_gravity(synthetic.GRAVITY_W.astype(np.float32))
        sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
    return sys_


def _run_system(sys_, frames, imu_bins=None):
    for f, fr in enumerate(frames):
        sys_.track_stereo(fr[0], fr[1], imu=None if imu_bins is None else imu_bins[f])
    sys_.exit()
    return sys_.trajectory()


@contextlib.contextmanager
def _plain_calls():
    """Count every call of the window gather's plain versions (the device
    of the corners each got) while the block runs: on the card the main
    path must never reach them."""
    plain = {n: getattr(patches, n) for n in ("extract_windows_ref", "extract_windows_levels_ref")}
    devices = []

    def counted(fn):
        def run(*args):
            devices.append(args[2].device.type)
            return fn(*args)
        return run

    for n, fn in plain.items():
        setattr(patches, n, counted(fn))
    try:
        yield devices
    finally:
        for n, fn in plain.items():
            setattr(patches, n, fn)


def phase_system(scene, tracker_ate) -> tuple[int, list, schur.BAProblem, system.VSlamSystem, float]:
    t0 = time.perf_counter()
    pairs = _render(scene, SYS_FRAMES)
    render_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    frames = [torch.from_numpy(p).to(dev) for p in pairs]
    torch.cuda.synchronize()
    # keep the last window the mapper solved (phase 7 solves it again)
    solve = local_mapper.schur.local_ba_two_rounds
    windows = []

    def recording(p, *args, **kwargs):
        windows.append(p)
        return solve(p, *args, **kwargs)

    sys_ = _system(scene, dev)
    torch.cuda.reset_peak_memory_stats()
    local_mapper.schur.local_ba_two_rounds = recording
    try:
        with _plain_calls() as plain_devices:
            patches.LAUNCHES = 0
            t0 = time.perf_counter()
            poses = _run_system(sys_, frames)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches, plain_calls = patches.LAUNCHES, len(plain_devices)
    finally:
        local_mapper.schur.local_ba_two_rounds = solve

    if launches != SYS_FRAMES:
        raise AssertionError(f"extract_windows launched {launches} times, want {SYS_FRAMES}")
    if plain_calls:
        raise AssertionError(f"the plain window gather ran {plain_calls} times ({plain_devices})")
    if poses.shape != (SYS_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory {poses.shape}")
    m = sys_.mapper
    if m.ba_count < 2 or len(windows) != m.ba_count:
        raise AssertionError(f"{m.ba_count} local-BA runs, {len(windows)} windows recorded")
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:SYS_FRAMES], align=False)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # the same run again: the card must reproduce it bit for bit
    repeat = _run_system(_system(scene, dev), frames)
    trk_st, ba_st = sys_.tracker.metrics.summary(), m.metrics.summary()
    c = m.counters
    say("system", frames=SYS_FRAMES, fps=SYS_FRAMES / run_s, run_s=run_s, render_s=render_s,
        frame_p50_ms=trk_st["track"]["p50_ms"], frame_p90_ms=trk_st["track"]["p90_ms"],
        **{f"frame_p50_ms_first{N_FRAMES}": 1e3 * float(np.median(sys_.tracker.metrics.samples("track")[:N_FRAMES]))},
        ba_runs=m.ba_count, ba_p50_ms=ba_st["run"]["p50_ms"], ba_p90_ms=ba_st["run"]["p90_ms"],
        ba_total_s=ba_st["run"]["total_s"],
        lm_iters_round1=c.get("lm_iters_round1"), lm_iters_round2=c.get("lm_iters_round2"),
        keyframes=len(sys_.tracker.new_kf_slots), landmarks=sys_.world.n_landmarks,
        killed_obs=c.get("obs_killed"), obs_rows_truncated=c.get("obs_rows_truncated"),
        ate_m=ate, tracker_only_ate_m_phase4=tracker_ate,
        extract_windows_launches=launches, plain_calls_on_card=plain_calls,
        peak_mem_mb=peak_mb, repeat_bit_identical=bool(np.array_equal(poses, repeat)))
    if not ate <= ATE_GATE_M:
        raise AssertionError(f"system ATE {ate} m > {ATE_GATE_M} m")
    if not np.array_equal(poses, repeat):
        raise AssertionError("a second system run on the card gave another trajectory")
    return launches, pairs, windows[-1], sys_, SYS_FRAMES / run_s


def _solve(p: schur.BAProblem, stats=None):
    out = schur.local_ba_two_rounds(p, stats=stats)
    if out[0].poses.is_cuda:
        torch.cuda.synchronize()
    return out


def _profile_counts(fn, top: int = 0) -> dict:
    """Kernel launches, stream syncs and memcpy calls of one call of fn()
    (which must end with a synchronize), from the profiler's runtime-API
    events; the device busy time is the sum of the kernels' own times, the
    wall time is taken with the profiler on; `top`: the kernels with the
    most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    counts = {e.key: e.count for e in events}
    launch = sum(v for k, v in counts.items() if k in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    sync = sum(v for k, v in counts.items() if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    out = {"kernel_launches": launch, "stream_syncs": sync,
           "memcpy_calls": counts.get("cudaMemcpyAsync", 0),
           "device_busy_ms": busy_us / 1e3, "profiled_wall_ms": wall_ms}
    if top:
        dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        dev.sort(key=lambda e: -getattr(e, "self_device_time_total", 0))
        out["top_kernels"] = [{"name": e.key[:80], "count": e.count,
                               "ms": getattr(e, "self_device_time_total", 0) / 1e3} for e in dev[:top]]
    return out


# a landmark's 3x3 block beyond this condition number has no depth that
# f32 can resolve (the 24 km landmark of phase 7's window, PERF.md)
LM_COND_MAX = 1e6


def _slab_agreement(a, sl, p: schur.BAProblem) -> dict:
    """Two solves of one window, unslabbed (a) and slabbed (sl): the
    largest pose difference, the errors and kills, and the largest point
    difference over the landmarks whose undamped 3x3 block has a condition
    number under LM_COND_MAX (the gate) and over the others. A landmark
    whose depth is unobserved (one seen at ~infinity: its stereo row has no
    disparity left) moves along its ray under any change of the step,
    which leaves its residual as it was. The worst landmark is printed
    with its rows, its block's eigenvalues and the cosine of its move to
    its ray."""
    q = a[0]
    L = p.pts.shape[0]
    n_rows = torch.bincount(q.obs_lm[q.obs_valid], minlength=L)
    n_stereo = torch.bincount(q.obs_lm[q.obs_valid & q.obs_stereo], minlength=L)
    ev = torch.linalg.eigvalsh(schur._assemble(q)[1].double())
    placed = p.pt_valid & (n_rows > 0) & (ev[:, 0] * LM_COND_MAX > ev[:, 2])
    loose = p.pt_valid & ~placed
    d = sl[0].pts - q.pts
    dl = torch.where(p.pt_valid, d.abs().amax(dim=1), 0.0)
    worst = int(torch.argmax(dl))
    rows = (q.obs_lm == worst) & q.obs_valid
    ray = q.pts[worst] - q.poses[q.obs_kf[rows], :3, 3].mean(dim=0)
    cos = float(torch.abs(torch.dot(d[worst], ray)) / (d[worst].norm() * ray.norm()).clamp(min=1e-30))
    return {
        "max_dpose": float((sl[0].poses - q.poses).abs().max()),
        "max_dpt_conditioned": float(dl[placed].max()), "landmarks_conditioned": int(placed.sum()),
        "max_dpt_other": float(dl[loose].max()) if bool(loose.any()) else 0.0,
        "landmarks_other": int(loose.sum()),
        "worst": {"slot": worst, "dpt": float(dl[worst]), "rows": int(n_rows[worst]),
                  "stereo_rows": int(n_stereo[worst]), "cos_move_ray": cos,
                  "hll_eigenvalues": ev[worst].tolist(), "range_m": float(ray.norm())},
        "err_slabbed": float(sl[1]), "err_unslabbed": float(a[1]),
        "kills_slabbed": int(sl[2].sum()), "kills_unslabbed": int(a[2].sum()),
        "same_kills": bool(torch.equal(sl[2], a[2])),
    }


def phase_ba(p: schur.BAProblem, sys_: system.VSlamSystem):
    cpu = torch.device("cpu")
    p_cpu = schur.BAProblem(*(t.to(cpu) for t in p))
    _solve(p)  # warm-up
    it1, it2 = [], []
    t0 = time.perf_counter()
    a = _solve(p, it1)
    ms_a = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    b = _solve(p, it2)
    ms_b = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(x, y) for x, y in ((a[0].poses, b[0].poses), (a[0].pts, b[0].pts),
                                               (a[1], b[1]), (a[2], b[2]), (a[0].obs_valid, b[0].obs_valid)))
    if not same:
        raise AssertionError("two solves of one BA problem on the card differ")
    prof = _profile_counts(lambda: _solve(p))
    t0 = time.perf_counter()
    c = _solve(p_cpu)
    ms_cpu = (time.perf_counter() - t0) * 1e3
    dt, ang = _pose_diff(a[0].poses.cpu().numpy(), c[0].poses.numpy())
    valid = p.pose_valid.cpu().numpy()
    dt, ang = dt[valid], ang[valid]
    kill_g, kill_c = a[2].cpu().numpy(), c[2].numpy()
    chi_g = schur.obs_chi2(a[0]).cpu().numpy()
    chi_c = schur.obs_chi2(c[0]).numpy()
    differ = np.nonzero(kill_g != kill_c)[0]
    thr = schur.CHI2_THR
    rows = [{"row": int(i), "chi2_card": float(chi_g[i]), "chi2_cpu": float(chi_c[i])} for i in differ]
    near = all(abs(r["chi2_card"] - thr) <= CHI2_BAND * thr and abs(r["chi2_cpu"] - thr) <= CHI2_BAND * thr
               for r in rows)
    say("ba", window_poses=int(valid.sum()), obs_rows=int(p.obs_valid.sum()),
        landmarks=int(p.pt_valid.sum()), bit_identical_on_card=same,
        lm_iters=it1, card_ms=[ms_a, ms_b], cpu_ms=ms_cpu, **prof,
        max_dt_m=float(dt.max()), max_drot_rad=float(ang.max()),
        kills_card=int(kill_g.sum()), kills_cpu=int(kill_c.sum()), kill_rows_differ=rows)
    if dt.max() > BA_TOL_M or ang.max() > BA_TOL_RAD:
        raise AssertionError(f"card and CPU BA poses differ: {dt.max()} m, {ang.max()} rad")
    if not near:
        raise AssertionError(f"kill masks differ away from the chi2 threshold: {rows}")
    # the Schur reduction in 4 landmark slabs against 1 (tests/test_ba.py:141-147)
    t0 = time.perf_counter()
    sl = schur.local_ba_two_rounds(p, n_slabs=4)
    torch.cuda.synchronize()
    ms_slab = (time.perf_counter() - t0) * 1e3
    slab = _slab_agreement(a, sl, p)
    say("ba_slabbed", n_slabs=4, card_ms=ms_slab, unslabbed_card_ms=ms_a, **slab)
    if (slab["max_dpose"] > 5e-4 or slab["max_dpt_conditioned"] > 5e-3
            or abs(slab["err_slabbed"] - slab["err_unslabbed"]) > 1e-3 * max(slab["err_unslabbed"], 1.0)
            or slab["kills_slabbed"] != slab["kills_unslabbed"] or not slab["same_kills"]):
        raise AssertionError(f"slabbed BA differs: {slab}")

    # the pieces of one LM iteration, each alone
    lam = p.poses.new_tensor(1e-4)
    pieces = {
        "obs_residual_jacobians": lambda: schur._obs_residual_and_jacobians(p),
        "odometry_residual_jacobians": lambda: schur._odometry_residual_and_jacobians(p),
        "assemble": lambda: schur._assemble(p),
        "schur_step": lambda: schur._schur_step(p, lam, schur._slabs(p, 1)),
        "ba_error": lambda: schur.ba_error(p),
        "obs_chi2": lambda: schur.obs_chi2(p),
    }
    say("ba_breakdown", **{name: _profile_counts(lambda fn=fn: (fn(), torch.cuda.synchronize()))
                           for name, fn in pieces.items()})

    # one whole LocalMapper.run (triangulation, assembly, BA, write-back,
    # host bookkeeping) on phase 6's final map, and the DLT's batched eigh
    # alone at the mapper's shape (1024 candidates, 13 views)
    slot = sys_.tracker.new_kf_slots[-1]
    run = _profile_counts(lambda: (sys_.mapper.run(slot), torch.cuda.synchronize()))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    Pv = torch.randn((13, 3, 4), device="cuda", generator=g)
    uv = torch.rand((PARAMS["n_features"], 13, 2), device="cuda", generator=g) * WIDTH
    mask = torch.ones((PARAMS["n_features"], 13), dtype=torch.bool, device="cuda")
    dlt = _profile_counts(lambda: (triangulate.triangulate_dlt(Pv, uv, mask), torch.cuda.synchronize()))
    say("mapper_run", kf_slot=slot, **run, dlt_kernel_launches=dlt["kernel_launches"],
        dlt_stream_syncs=dlt["stream_syncs"] - 1)
    return prof


def phase_system_card_vs_cpu(scene, pairs, phase="system_card_vs_cpu", n=SYS_CPU_FRAMES,
                             imu_bins=None, **kw):
    """The facade (`kw` as for _system) over the first `n` frames on the
    card and on the CPU: the same keyframes and BA runs, poses within
    POSE_TOL."""
    sub = pairs[:n]
    g = _system(scene, "cuda", **kw)
    pg = _run_system(g, [torch.from_numpy(p).cuda() for p in sub], imu_bins)
    c = _system(scene, "cpu", **kw)
    pc = _run_system(c, [torch.from_numpy(p) for p in sub], imu_bins)
    if g.tracker.new_kf_slots != c.tracker.new_kf_slots or g.mapper.ba_count != c.mapper.ba_count:
        raise AssertionError(
            f"{phase}: keyframes/BA differ: card {g.tracker.new_kf_slots} {g.mapper.ba_count}, "
            f"cpu {c.tracker.new_kf_slots} {c.mapper.ba_count}")
    dt, ang = _pose_diff(pg, pc)
    say(phase, frames=n, keyframes=g.tracker.new_kf_slots, ba_runs=g.mapper.ba_count,
        max_dt_m=float(dt.max()), max_drot_rad=float(ang.max()))
    if dt.max() > POSE_TOL_M or ang.max() > POSE_TOL_RAD:
        raise AssertionError(f"{phase}: card and CPU poses differ: {dt.max()} m, {ang.max()} rad")


def _stage(pairs):
    frames = [torch.from_numpy(p).to("cuda") for p in pairs]
    torch.cuda.synchronize()
    return frames


def phase_async(scene, pairs, sync_fps) -> int:
    frames = _stage(pairs)
    sys_ = _system(scene, "cuda", async_ba=True)
    torch.cuda.reset_peak_memory_stats()
    with _plain_calls() as plain_devices:
        patches.LAUNCHES = 0
        t0 = time.perf_counter()
        poses = _run_system(sys_, frames)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = patches.LAUNCHES
    if launches != SYS_FRAMES:
        raise AssertionError(f"extract_windows launched {launches} times, want {SYS_FRAMES}")
    if plain_devices:
        raise AssertionError(f"the plain window gather ran {len(plain_devices)} times")
    if poses.shape != (SYS_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory {poses.shape}")
    gt = scene.poses_c2w[:SYS_FRAMES]
    ate = trajectory.ate_rmse(poses, gt, align=False)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    repeat = _run_system(_system(scene, "cuda", async_ba=True), frames)
    # readiness-polled consumes: the trajectory may depend on thread timing
    polled = _system(scene, "cuda", async_ba=True)
    polled.deterministic_ba_latency = False
    t0 = time.perf_counter()
    p_poses = _run_system(polled, frames)
    torch.cuda.synchronize()
    polled_s = time.perf_counter() - t0
    p_ate = trajectory.ate_rmse(p_poses, gt, align=False)
    m, trk = sys_.mapper.metrics.summary(), sys_.tracker.metrics.summary()
    c = sys_.mapper.counters
    say("async_system", frames=SYS_FRAMES, fps=SYS_FRAMES / run_s, sync_fps_phase6=sync_fps,
        run_s=run_s, frame_p50_ms=trk["track"]["p50_ms"], frame_p90_ms=trk["track"]["p90_ms"],
        join_blocked_s=m["ba_join"]["total_s"], join_p50_ms=m["ba_join"]["p50_ms"],
        join_p90_ms=m["ba_join"]["p90_ms"], worker_wall_p50_ms=m["ba_worker"]["p50_ms"],
        worker_wall_p90_ms=m["ba_worker"]["p90_ms"], worker_wall_total_s=m["ba_worker"]["total_s"],
        ba_runs=sys_.mapper.ba_count, lm_iters_round1=c.get("lm_iters_round1"),
        lm_iters_round2=c.get("lm_iters_round2"), keyframes=len(sys_.tracker.new_kf_slots),
        landmarks=sys_.world.n_landmarks, ate_m=ate, extract_windows_launches=launches,
        plain_calls_on_card=len(plain_devices), peak_mem_mb=peak_mb,
        repeat_bit_identical=bool(np.array_equal(poses, repeat)),
        polled_fps=SYS_FRAMES / polled_s, polled_ate_m=p_ate, polled_ba_runs=polled.mapper.ba_count,
        polled_pending_after_exit=polled._pending_ba is not None)
    if not ate <= ATE_GATE_M:
        raise AssertionError(f"async system ATE {ate} m > {ATE_GATE_M} m")
    if not np.array_equal(poses, repeat):
        raise AssertionError("a second async system run on the card gave another trajectory")
    if not p_ate <= ATE_GATE_M or polled._pending_ba is not None:
        raise AssertionError(f"readiness-polled run: ATE {p_ate} m, pending {polled._pending_ba}")
    return launches


def phase_imu(scene, pairs, bins) -> int:
    """STEREO_IMU with the sync mapper over the 40 frames, then the 15-dof
    solve and the preintegration alone (the last of each the run made)."""
    frames = _stage(pairs)
    sys_ = _system(scene, "cuda", imu=True)
    last, n_calls = {}, {"motion_only_ba_imu": 0, "preintegrate": 0}

    def recording(mod, name):
        fn = getattr(mod, name)

        def run(*args, **kwargs):
            last[name] = (fn, args, kwargs)
            n_calls[name] += 1
            return fn(*args, **kwargs)
        return run

    originals = [(lm, "motion_only_ba_imu"), (imu, "preintegrate")]
    saved = [getattr(mod, name) for mod, name in originals]
    for mod, name in originals:
        setattr(mod, name, recording(mod, name))
    try:
        with _plain_calls() as plain_devices:
            patches.LAUNCHES = 0
            t0 = time.perf_counter()
            poses = _run_system(sys_, frames, bins)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = patches.LAUNCHES
    finally:
        for (mod, name), fn in zip(originals, saved):
            setattr(mod, name, fn)
    if launches != SYS_FRAMES or plain_devices:
        raise AssertionError(f"extract_windows launched {launches} times, plain {len(plain_devices)}")
    if poses.shape != (SYS_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory {poses.shape}")
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:SYS_FRAMES], align=False)
    prof = {}
    for name, (fn, args, kwargs) in last.items():
        prof[name] = _profile_counts(lambda: (fn(*args, **kwargs), torch.cuda.synchronize()))
    tracked = SYS_FRAMES - 1
    per_frame = n_calls["motion_only_ba_imu"] / tracked
    trk = sys_.tracker.metrics.summary()
    say("stereo_imu", frames=SYS_FRAMES, fps=SYS_FRAMES / run_s, run_s=run_s,
        frame_p50_ms=trk["track"]["p50_ms"], frame_p90_ms=trk["track"]["p90_ms"], ate_m=ate,
        keyframes=len(sys_.tracker.new_kf_slots), ba_runs=sys_.mapper.ba_count,
        landmarks=sys_.world.n_landmarks, extract_windows_launches=launches,
        plain_calls_on_card=len(plain_devices), imu_solves_per_frame=per_frame,
        imu_solve=prof["motion_only_ba_imu"],
        imu_solve_launches_per_frame=per_frame * prof["motion_only_ba_imu"]["kernel_launches"],
        imu_solve_syncs_per_frame=per_frame * prof["motion_only_ba_imu"]["stream_syncs"],
        preintegrate=prof["preintegrate"], preintegrate_rows=len(last["preintegrate"][1][0]))
    if not ate <= IMU_ATE_GATE_M:
        raise AssertionError(f"STEREO_IMU ATE {ate} m > {IMU_ATE_GATE_M} m")
    phase_system_card_vs_cpu(scene, pairs, "stereo_imu_card_vs_cpu", IMU_CPU_FRAMES, bins, imu=True)
    return launches


def _driver(argv) -> tuple[dict, int]:
    with _plain_calls() as plain_devices:
        patches.LAUNCHES = 0
        r = run_synthetic.main(argv)
        torch.cuda.synchronize()
        launches = patches.LAUNCHES
    say("driver", argv=argv, **r, extract_windows_launches=launches,
        plain_calls_on_card=len(plain_devices))
    if plain_devices:
        raise AssertionError(f"driver {argv}: {len(plain_devices)} plain calls")
    if not r["ate_m"] <= ATE_GATE_M:
        raise AssertionError(f"driver {argv}: ATE {r['ate_m']} m > {ATE_GATE_M} m")
    return r, launches


def phase_driver() -> tuple[int, int]:
    """The driver's KITTI scene with a global BA after it, then its mono
    scene for 24 frames."""
    r, launches = _driver(["--scene", "kitti", "--global-ba", "--frames", str(KITTI_FRAMES)])
    if r["frames"] != KITTI_FRAMES or launches != KITTI_FRAMES:
        raise AssertionError(f"driver: {r['frames']} frames, {launches} launches")
    if not (r["ate_before_global_ba_m"] <= ATE_GATE_M and np.isfinite(r["global_ba_error"])):
        raise AssertionError(f"driver global BA: {r}")
    m, launches_mono = _driver(["--scene", "mono", "--frames", str(MONO_DRIVER_FRAMES)])
    want = m["bootstrap_views"] + MONO_DRIVER_FRAMES - 1 - m["init_frame"]
    if launches_mono != want:
        raise AssertionError(f"driver mono: {launches_mono} launches, want {want}")
    return launches, launches_mono


def _mono_system(scene, device):
    """The facade in slamMode 2 at the bench's mono configuration: the IMU
    block of the driver's config (with the scene's gravity) and the scene's
    initial velocity."""
    cfg = run_synthetic.config(WIDTH, HEIGHT, 20.0, PARAMS["n_features"], 2)
    cam = {"fx": float(scene.K[0, 0]), "fy": float(scene.K[1, 1]),
           "cx": float(scene.K[0, 2]), "cy": float(scene.K[1, 2])}
    cfg.update(Camera_l=dict(cam), Camera_r=dict(cam))
    sys_ = system.VSlamSystem(ConfigFile.from_dict(cfg), **SYS_CAPS,
                              tracker_params=tracker.TrackerParams(**PARAMS), device=device)
    sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
    return sys_


def _run_mono(sys_, frames, bins):
    """track_mono_imu over the frames; returns (trajectory, the landmark
    count of each mono triangulation and whether it is the init's: the
    call made while needs_init_triangulation is set; the facade also
    triangulates bootstrap keyframes before it)."""
    found = sys_.mapper.find_new_points
    counts = []

    def counted(kf_slot, mono=False):
        ids = found(kf_slot, mono=mono)
        counts.append((len(ids), bool(sys_.tracker.needs_init_triangulation)))
        return ids

    sys_.mapper.find_new_points = counted
    for f, fr in enumerate(frames):
        sys_.track_mono_imu(fr, imu=bins[f])
    sys_.exit()
    return sys_.trajectory(), counts


def phase_mono() -> int:
    scene = synthetic.make_scene(**MONO_SCENE)
    t0 = time.perf_counter()
    imgs = _render(scene, MONO_FRAMES, stereo=False)
    render_s = time.perf_counter() - t0
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    frames = [torch.from_numpy(i).to("cuda") for i in imgs]
    torch.cuda.synchronize()
    sys_ = _mono_system(scene, "cuda")
    torch.cuda.reset_peak_memory_stats()
    with _plain_calls() as plain_devices:
        patches.LAUNCHES = 0
        t0 = time.perf_counter()
        poses, tri = _run_mono(sys_, frames, bins)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = patches.LAUNCHES
    trk = sys_.tracker
    if not trk.initialized or poses.shape != (MONO_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"mono: initialized {trk.initialized}, trajectory {poses.shape}")
    init_frame = int(sys_.world.kf_frame_idx[trk.bootstrap_slots[-1]])
    tracked = MONO_FRAMES - 1 - init_frame
    want = len(trk.bootstrap_slots) + tracked
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:MONO_FRAMES], align=False)
    repeat, _ = _run_mono(_mono_system(scene, "cuda"), frames, bins)
    init = [c for c, is_init in tri if is_init]
    st = trk.metrics.summary()
    say("mono", frames=MONO_FRAMES, fps=MONO_FRAMES / run_s, run_s=run_s, render_s=render_s,
        frame_p50_ms=st["track"]["p50_ms"], frame_p90_ms=st["track"]["p90_ms"],
        bootstrap_views=len(trk.bootstrap_slots), bootstrap_gates=len(trk.gate_slots),
        init_frame=init_frame, init_landmarks=init[0] if len(init) == 1 else init,
        triangulation_counts=[c for c, _ in tri], triangulations=len(tri),
        keyframes=len(trk.new_kf_slots), landmarks=sys_.world.n_landmarks, ate_m=ate,
        extract_windows_launches=launches, want_launches=want, tracked_frames=tracked,
        plain_calls_on_card=len(plain_devices), relocalizations=trk.counters.get("relocalizations"),
        peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
        repeat_bit_identical=bool(np.array_equal(poses, repeat)))
    if launches != want or plain_devices:
        raise AssertionError(f"mono: {launches} launches, want {want}; {len(plain_devices)} plain")
    if len(init) != 1:
        raise AssertionError(f"mono: {len(init)} init triangulations")
    if not ate <= ATE_GATE_M:
        raise AssertionError(f"mono ATE {ate} m > {ATE_GATE_M} m")
    if not np.array_equal(poses, repeat):
        raise AssertionError("a second mono run on the card gave another trajectory")

    n = MONO_CPU_FRAMES
    g, c = _mono_system(scene, "cuda"), _mono_system(scene, "cpu")
    pg, _ = _run_mono(g, frames[:n], bins)
    pc, _ = _run_mono(c, [torch.from_numpy(i) for i in imgs[:n]], bins)
    same = (g.tracker.bootstrap_slots == c.tracker.bootstrap_slots
            and g.tracker.new_kf_slots == c.tracker.new_kf_slots)
    dt, ang = _pose_diff(pg, pc)
    say("mono_card_vs_cpu", frames=n, keyframes=g.tracker.new_kf_slots,
        bootstrap_slots=g.tracker.bootstrap_slots, same_slots=same,
        landmarks_card=g.world.n_landmarks, landmarks_cpu=c.world.n_landmarks,
        max_dt_m=float(dt.max()), max_drot_rad=float(ang.max()))
    if not same or dt.max() > POSE_TOL_M or ang.max() > POSE_TOL_RAD:
        raise AssertionError(f"mono card vs CPU: slots {same}, {dt.max()} m, {ang.max()} rad")
    return launches


def _recording_retrieve():
    """Wrap reloc.retrieve to keep each call's arguments and result."""
    calls = []
    fn = reloc.retrieve

    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    reloc.retrieve = run
    return calls, fn


def phase_recovery() -> int:
    """tests/test_tracking.py's relocalization and re-seed sequences at the
    bench configuration on the card."""
    scene = synthetic.make_scene(n_frames=8, n_points=900, width=WIDTH, height=HEIGHT, fps=20.0,
                                 seed=SEED)
    black = torch.zeros((2, HEIGHT, WIDTH), device="cuda")
    pairs = [torch.from_numpy(np.stack([scene.render(f), scene.render(f, right=True)])).cuda()
             for f in range(8)]
    calls, retrieve = _recording_retrieve()
    try:
        with _plain_calls() as plain_devices:
            patches.LAUNCHES = 0
            t0 = time.perf_counter()
            trk, poses = _run_tracker(scene, pairs + [black] * 6 + pairs, "cuda")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = patches.LAUNCHES
    finally:
        reloc.retrieve = retrieve
    errs = np.linalg.norm(poses[-3:, :3, 3] - scene.poses_c2w[5:8, :3, 3], axis=1)
    accepted = [c for c in calls if c[2][0] >= 0]
    one = {}
    if accepted:
        args, kwargs, _ = accepted[0]
        t0 = time.perf_counter()
        reloc.retrieve(*args, **kwargs)
        one = {"retrieve_wall_ms": (time.perf_counter() - t0) * 1e3,
               "retrieve": _profile_counts(lambda: (reloc.retrieve(*args, **kwargs), torch.cuda.synchronize()))}
    say("relocalization", frames=len(poses), run_s=run_s, relocalizations=trk.counters.get("relocalizations"),
        retrievals=[{"slot": c[2][0], "votes": c[2][1]} for c in calls], tail_err_m=errs.tolist(),
        n_inliers_last=trk.last_stats["n_inliers"], extract_windows_launches=launches,
        plain_calls_on_card=len(plain_devices), **one)
    if trk.counters.get("relocalizations") != 1 or not errs.max() < RECOVERY_GATE_M:
        raise AssertionError(f"relocalization: {trk.counters.get('relocalizations')}, tail {errs}")
    if launches != len(poses) or plain_devices:
        raise AssertionError(f"relocalization: {launches} launches for {len(poses)} frames")

    s1 = synthetic.make_scene(n_frames=6, n_points=900, width=WIDTH, height=HEIGHT, fps=20.0, seed=SEED)
    s2 = synthetic.make_scene(n_frames=10, n_points=900, width=WIDTH, height=HEIGHT, fps=20.0, seed=23)
    seq = [torch.from_numpy(np.stack([s.render(f), s.render(f, right=True)])).cuda()
           for s, n in ((s1, 6), (s2, 10)) for f in range(n)]
    seq = seq[:6] + [black] * 3 + seq[6:]
    reseeds = []
    world = map_state.WorldMap(**WORLD, device="cuda")
    trk = tracker.StereoTracker(s1.K.astype(np.float32), s1.baseline, WIDTH, HEIGHT, world,
                                tracker.TrackerParams(**PARAMS), device="cuda")
    insert = trk._insert_keyframe

    def logged(frame_idx, *args, reseed=False, **kwargs):
        if reseed:
            reseeds.append(frame_idx)
        return insert(frame_idx, *args, reseed=reseed, **kwargs)

    trk._insert_keyframe = logged
    for fr in seq:
        trk.track(fr)
    poses = trk.trajectory()
    rec0 = 6 + 3 + 6
    est = np.linalg.inv(poses[rec0]) @ poses[-1]
    gt = np.linalg.inv(s2.poses_c2w[rec0 - 9]) @ s2.poses_c2w[9]
    rel_err = float(np.linalg.norm(est[:3, 3] - gt[:3, 3]))
    say("reseed", frames=len(seq), reseed_frames=reseeds,
        relocalizations=trk.counters.get("relocalizations"), rel_err_m=rel_err,
        n_inliers_last=trk.last_stats["n_inliers"], keyframes=len(trk.new_kf_slots))
    if not reseeds or not rel_err < RECOVERY_GATE_M:
        raise AssertionError(f"re-seed: {reseeds}, relative error {rel_err} m")
    return launches


def phase_global_ba(sys_, scene):
    """VSlamSystem.global_ba after phase 6's run, then the map-scale
    corridor map."""
    m = sys_.mapper
    gt = scene.poses_c2w[:SYS_FRAMES]
    ate0 = trajectory.ate_rmse(sys_.trajectory(), gt, align=False)
    i1, i2 = m.counters.get("lm_iters_round1"), m.counters.get("lm_iters_round2")
    t0 = time.perf_counter()
    r = sys_.global_ba()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ate1 = trajectory.ate_rmse(sys_.trajectory(), gt, align=False)
    iters = [m.counters.get("lm_iters_round1") - i1, m.counters.get("lm_iters_round2") - i2]
    prof = _profile_counts(lambda: (m.run_global(), torch.cuda.synchronize()))
    say("global_ba", keyframes=len(r["window"]), wall_s=wall, lm_iters=iters, error=r["error"],
        ate_before_m=ate0, ate_after_m=ate1, second_run=prof)
    if not (np.isfinite(r["error"]) and ate1 <= ATE_GATE_M):
        raise AssertionError(f"global BA: error {r['error']}, ATE {ate0} -> {ate1} m")

    world, c = synthetic.corridor_world(MAP_KF, MAP_LM, PARAMS["n_features"], device="cuda")
    rng = np.random.default_rng(1)
    drift = np.cumsum(rng.normal(0, 0.004, (MAP_KF, 3)), axis=0).astype(np.float32)
    drift[0] = 0.0
    pert = c["poses"].copy()
    pert[:, :3, 3] += drift
    world.arrays.kf_pose.copy_(torch.from_numpy(pert))
    world.kf_poses_host[:] = pert
    mapper = local_mapper.LocalMapper(
        world, c["K"], c["baseline"], local_mapper.LocalMapperConfig(iters_round1=3, iters_round2=5)
    )
    solve = local_mapper.schur.local_ba_two_rounds
    problems = []

    def recording(p, *args, **kwargs):
        problems.append((p, kwargs.get("n_slabs", 1)))
        return solve(p, *args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    local_mapper.schur.local_ba_two_rounds = recording
    try:
        t0 = time.perf_counter()
        r = mapper.run_global(max_landmarks=1 << 17)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        local_mapper.schur.local_ba_two_rounds = solve
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n_obs = int((c["obs_lm"] >= 0).sum())
    new = world.kf_poses_host[:MAP_KF]

    def rel_err(ps):
        d = np.linalg.inv(ps[:-5]) @ ps[5:]
        dg = np.linalg.inv(c["poses"][:-5]) @ c["poses"][5:]
        return float(np.mean(np.linalg.norm(d[:, :3, 3] - dg[:, :3, 3], axis=1)))

    p, n_slabs = problems[-1]
    it = _profile_counts(lambda: (schur.local_ba(p, iters=1, n_slabs=n_slabs), torch.cuda.synchronize()),
                         top=8)
    say("global_ba_map_scale", keyframes=MAP_KF, landmarks=MAP_LM, obs=n_obs,
        landmark_slots=int(p.pts.shape[0]), obs_rows=int(p.obs_kf.shape[0]), n_slabs=n_slabs,
        wall_s=wall, peak_mem_mb=peak_mb, error=r["error"], error_per_obs=r["error"] / n_obs,
        lm_iters=[mapper.counters.get("lm_iters_round1"), mapper.counters.get("lm_iters_round2")],
        rel_err_before=rel_err(pert), rel_err_after=rel_err(new),
        one_iteration_with_error=it)
    if not (r is not None and len(r["window"]) == MAP_KF and n_slabs == MAP_SLABS
            and np.isfinite(r["error"]) and np.isfinite(new).all()):
        raise AssertionError(f"map-scale global BA: slabs {n_slabs}, result {r}")
    if not (r["error"] < 0.01 * n_obs and rel_err(new) < 0.7 * rel_err(pert)):
        raise AssertionError(f"map-scale global BA: error {r['error']} for {n_obs} obs, "
                             f"relative error {rel_err(pert)} -> {rel_err(new)}")


def _loop_system(device):
    """The bench's loop-circuit facade (bench.py:244-309): stereo, the
    driver's rectified rig (fx = fy = 460, baseline 0.12, 10 fps), 1024
    features, an active set of 1024, async BA at a fixed latency, loop
    closure on."""
    cfg = run_synthetic.config(LOOP_W, LOOP_H, 10.0, LOOP_PARAMS["n_features"], 1)
    sys_ = system.VSlamSystem(ConfigFile.from_dict(cfg), async_ba=True, loop_closure=True, **LOOP_CAPS,
                              tracker_params=tracker.TrackerParams(**LOOP_PARAMS), device=device)
    sys_.deterministic_ba_latency = True
    return sys_


def _map_snapshot(w) -> tuple:
    """Copies of every map array and host mirror of a WorldMap."""
    arrays = {k: v.clone() for k, v in vars(w.arrays).items()}
    host = {k: getattr(w, k).copy() for k in ("kf_obs_lm", "kf_obs_r_lm", "kf_frame_idx", "kf_poses_host")}
    return arrays, host


def _same_map(a, b) -> bool:
    return (all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and all(np.array_equal(a[1][k], b[1][k]) for k in a[1]))


def _spy(obj, name, calls):
    """Wrap obj.name to append (wall seconds with the card synchronized,
    result) to `calls`; returns a function that restores it."""
    fn = getattr(obj, name)

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, out))
        return out

    setattr(obj, name, run)
    return lambda: setattr(obj, name, fn)


def phase_loop(scene) -> int:
    """Phase 16: the bench's loop circuit through the facade on the card,
    then the first applied closure replayed twice from a copy of the map
    taken just before it."""
    t0 = time.perf_counter()
    frames = _stage(_render(scene, LOOP_FRAMES))
    render_s = time.perf_counter() - t0
    sys_ = _loop_system("cuda")
    closer = sys_.loop_closer
    detects, polishes, written = [], [], {}
    closes = []
    close = closer.close

    def timed_close(kf_slot, old_kf, T_loop):
        # until a closure is applied, a copy of the map and of the closer's
        # edges is taken before each close (outside its wall time)
        snap = None if written else (copy.deepcopy(closer.world), copy.deepcopy(closer._edges))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = close(kf_slot, old_kf, T_loop)
        torch.cuda.synchronize()
        closes.append((time.perf_counter() - t0, r))
        if r is not None and not written:
            written.update(args=(kf_slot, old_kf, T_loop), map=_map_snapshot(closer.world),
                           world=snap[0], edges=snap[1])
        return r

    closer.close = timed_close
    restore = [lambda: setattr(closer, "close", close), _spy(closer, "detect", detects),
               _spy(sys_.mapper, "run_global", polishes)]
    try:
        with _plain_calls() as plain_devices:
            patches.LAUNCHES = 0
            t0 = time.perf_counter()
            poses = _run_system(sys_, frames)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = patches.LAUNCHES
    finally:
        for r in restore:
            r()
    gt = scene.poses_c2w[:LOOP_FRAMES]
    ate = trajectory.ate_rmse(poses, gt, align=False)
    t0 = time.perf_counter()
    g = sys_.global_ba()
    torch.cuda.synchronize()
    gba_s = time.perf_counter() - t0
    ate2 = trajectory.ate_rmse(sys_.trajectory(), gt, align=False)
    applied = [(wall, r) for wall, r in closes if r is not None]
    trk = sys_.tracker.metrics.summary()
    w = sys_.world
    say("loop", frames=LOOP_FRAMES, fps=LOOP_FRAMES / run_s, run_s=run_s, render_s=render_s,
        frame_p50_ms=trk["track"]["p50_ms"], frame_p90_ms=trk["track"]["p90_ms"],
        keyframes=w.n_keyframes, landmarks=w.n_landmarks, ba_runs=sys_.mapper.ba_count,
        closures=closer.closures, close_calls=len(closes),
        applied=[{"kf_slot": r["kf_slot"], "old_kf": r["old_kf"], "path": r["path"],
                  "n_merged": r["n_merged"], "pose_graph_error": r["pose_graph_error"],
                  "kf_frame": int(w.kf_frame_idx[r["kf_slot"]]),
                  "old_kf_frame": int(w.kf_frame_idx[r["old_kf"]]), "close_wall_ms": wall * 1e3}
                 for wall, r in applied],
        detect_calls=len(detects), detect_total_s=sum(c[0] for c in detects),
        detect_p50_ms=1e3 * float(np.median([c[0] for c in detects])) if detects else None,
        polishes=len(polishes), polish_wall_s=[c[0] for c in polishes],
        ate_live_m=ate, ate_after_global_ba_m=ate2, global_ba_s=gba_s,
        global_ba_error=None if g is None else g["error"],
        extract_windows_launches=launches, plain_calls_on_card=len(plain_devices))
    if launches != LOOP_FRAMES or plain_devices:
        raise AssertionError(f"loop: {launches} launches, {len(plain_devices)} plain calls")
    if poses.shape != (LOOP_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"loop: bad trajectory {poses.shape}")
    if closer.closures < 1 or not written:
        raise AssertionError("loop: no closure fired on the circuit")
    if not ate < LOOP_ATE_GATE_M:
        raise AssertionError(f"loop: live ATE {ate} m >= {LOOP_ATE_GATE_M} m")
    if not ate2 < max(1.1 * ate, LOOP_GBA_FLOOR_M):
        raise AssertionError(f"loop: ATE after global BA {ate2} m (live {ate} m)")

    # the first applied closure, replayed twice from the map copied just
    # before it: the written map must be the same bit for bit
    K = closer.K.cpu().numpy()
    replays = []
    for _ in range(2):
        w = copy.deepcopy(written["world"])
        c = loop_closure.LoopCloser(w, K, closer.baseline)
        c._edges = copy.deepcopy(written["edges"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = c.close(*written["args"])
        torch.cuda.synchronize()
        replays.append((_map_snapshot(w), (time.perf_counter() - t0) * 1e3, r is not None))
    same = _same_map(replays[0][0], replays[1][0])
    say("loop_closure_repeat", kf_slot=written["args"][0], old_kf=written["args"][1],
        applied=[r[2] for r in replays], replay_wall_ms=[r[1] for r in replays],
        replays_bit_identical=same, equal_to_live_write=_same_map(replays[0][0], written["map"]))
    if not (same and all(r[2] for r in replays)):
        raise AssertionError("loop: two replays of one closure on the card wrote different maps")
    return launches


def phase_loop_card_vs_cpu():
    """The split-map closures of tests/test_loop_closure.py:374-456 on the
    card and on the CPU (utils/synthetic.split_map_world): the same
    detection, merge pairs and n_merged, poses within 1e-4 m / 1e-4 rad."""
    for case, (scale_err, baseline) in SPLIT_CASES.items():
        out = {}
        for dev in ("cuda", "cpu"):
            w, _, _, K = synthetic.split_map_world(scale_err=scale_err, device=dev)
            n = w.n_keyframes
            c = loop_closure.LoopCloser(w, K, baseline, min_gap=3)
            first = c.try_close(n - 2)
            cand = c._last_cand
            pairs = c._merge_pairs(n - 1, cand[1]) if cand else None
            t0 = time.perf_counter()
            r = c.try_close(n - 1)
            wall = time.perf_counter() - t0
            out[dev] = (first, cand, pairs, r, w.kf_poses_host[:n].copy(), wall)
        g, p = out["cuda"], out["cpu"]
        fields = ("old_kf", "n_merged", "path")
        ok = g[0] is None and p[0] is None and g[3] is not None and p[3] is not None
        same = ok and g[1] == p[1] and g[2] == p[2] and all(g[3][k] == p[3][k] for k in fields)
        dt, ang = _pose_diff(g[4], p[4])
        say("loop_card_vs_cpu", case=case, candidate=g[1], pairs=len(g[2] or ()),
            **({k: g[3][k] for k in fields + ("pose_graph_error",)} if g[3] else {}),
            pose_graph_error_cpu=p[3]["pose_graph_error"] if p[3] else None,
            same_detection_pairs_merges=same, max_dt_m=float(dt.max()), max_drot_rad=float(ang.max()),
            try_close_wall_ms_card=g[5] * 1e3, try_close_wall_ms_cpu=p[5] * 1e3)
        if not same or dt.max() > BA_TOL_M or ang.max() > BA_TOL_RAD:
            raise AssertionError(f"loop card vs CPU ({case}): same {same}, {dt.max()} m, {ang.max()} rad")


def _chain_problem():
    """tests/test_loop_closure.py:224-271's 2048-pose chain: biased odometry
    and 3 true loop edges (0-680, 0-1360, 0-2047) in 4 slots."""
    def expm(xi):
        return se3.se3_expmap(torch.tensor(xi, dtype=torch.float32)).numpy()

    step = expm([0.0, 0.02, 0.0, 0.0, 0.0, 0.3])
    small = expm([2e-5, 0.0201, 0.0, 2e-4, 1e-4, 0.30004])
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(1, CHAIN_P):
        gt.append(gt[-1] @ step)
        est.append(est[-1] @ small)
    gt, est = np.stack(gt), np.stack(est)
    L = loop_closure.LOOP_EDGES
    li, lj = np.zeros(L, np.int64), np.zeros(L, np.int64)
    lrel, lw = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1)), np.zeros(L, np.float32)
    for k, b in enumerate((680, 1360, CHAIN_P - 1)):
        li[k], lj[k], lrel[k], lw[k] = 0, b, np.linalg.inv(gt[0]) @ gt[b], 100.0
    args = (est, np.ones(CHAIN_P, bool), np.tile(small, (CHAIN_P - 1, 1, 1)),
            np.full(CHAIN_P - 1, 100.0, np.float32), li, lj, lrel, lw)
    return gt, est, args


def phase_pose_graph():
    """One optimize_chain at P = 2048 on the card: wall, iterations, the
    launches and syncs of one iteration, the drift it recovers; the same
    call on the CPU for the difference."""
    gt, est, args = _chain_problem()
    dev_args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args]
    pose_graph.optimize_chain(*dev_args, iters=25)  # warm-up
    it = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, err = pose_graph.optimize_chain(*dev_args, iters=25, stats=it)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # one iteration's launches and syncs: the difference of two profiled
    # calls of 4 and 8 iterations (the chain takes all 25, so neither stops
    # early)
    p4, p8 = (_profile_counts(lambda k=k: (pose_graph.optimize_chain(*dev_args, iters=k), torch.cuda.synchronize()))
              for k in (4, 8))
    t0 = time.perf_counter()
    pc, _ = pose_graph.optimize_chain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), iters=25)
    cpu_s = time.perf_counter() - t0
    ps = ps.cpu().numpy()
    pre = float(np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3]))
    post = float(np.linalg.norm(ps[-1, :3, 3] - gt[-1, :3, 3]))
    errs = np.linalg.norm(ps[:, :3, 3] - gt[:, :3, 3], axis=1)
    say("pose_graph_chain", poses=CHAIN_P, loop_edges=3, wall_s=wall, iterations=it[0], error=float(err),
        launches_per_iteration=(p8["kernel_launches"] - p4["kernel_launches"]) / 4,
        syncs_per_iteration=(p8["stream_syncs"] - p4["stream_syncs"]) / 4,
        device_busy_ms_per_iteration=(p8["device_busy_ms"] - p4["device_busy_ms"]) / 4,
        profiled_4_8_iterations=[p4, p8], drift_end_m=[pre, post], max_pose_err_m=float(errs.max()), cpu_s=cpu_s,
        max_dt_card_vs_cpu_m=float(np.abs(ps[:, :3, 3] - pc.numpy()[:, :3, 3]).max()))
    if not (post < 0.1 * pre and errs.max() < 0.2):
        raise AssertionError(f"2048-pose chain: drift {pre} -> {post} m, max error {errs.max()} m")


def _render_pngs(scene, frames, paths):
    """Worker: render frames (L and R) of `scene` and write each as a uint8
    PNG at paths[f] = (left path, right path)."""
    from PIL import Image

    for f in frames:
        for right, p in enumerate(paths[f]):
            Image.fromarray(np.clip(scene.render(f, right=bool(right)), 0, 255).astype(np.uint8)).save(p)


def _write_pngs(scene, paths: list):
    """Frames 0..len(paths)-1 of `scene` as PNGs, written by the pool."""
    chunks = [c for c in np.array_split(np.arange(len(paths)), 4 * RENDER_WORKERS) if len(c)]
    list(_POOL.map(_render_pngs, [scene] * len(chunks), chunks, [paths] * len(chunks)))


def _cam(K) -> dict:
    return {"fx": float(K[0, 0]), "fy": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2])}


def _write_config(path, cfg: dict) -> str:
    """The config as JSON, which the YAML loader reads as well."""
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _kitti_layout(root, scene, n) -> str:
    """image_0/, image_1/, times.txt and the config: KITTI 00's FE block with
    the scene's intrinsics and baseline, rectified, slamMode 1."""
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, sub))
    _write_pngs(scene, [tuple(os.path.join(root, s, f"{f:06d}.png") for s in ("image_0", "image_1"))
                        for f in range(n)])
    np.savetxt(os.path.join(root, "times.txt"), scene.times[:n])
    return _write_config(os.path.join(root, "config.json"), {
        "rectified": True, "slamMode": 1, "dataset": "KITTI", "imagesPath": root,
        "fileExtension": ".png", "Camera_l": _cam(scene.K), "Camera_r": _cam(scene.K),
        "Camera": {"width": scene.width, "height": scene.height, "fps": 10.0, "bl": float(scene.baseline)},
        "FE": DS_KITTI_FE,
    })


def _euroc_layout(root, scene, n) -> str:
    """mav0/cam0, mav0/cam1 (data/ and data.csv, nanosecond timestamps),
    mav0/imu0/data.csv and the config: MH_01's FE and IMU blocks, slamMode 0,
    an unrectified rig (K the scene's, D = 0, R = I, P = [K|0]) and the
    scene's gravity (the synthetic body is not EuRoC-mounted)."""
    mav0 = os.path.join(root, "mav0")
    ns = [int(round(t * 1e9)) for t in scene.times[:n]]
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(mav0, cam, "data"))
        with open(os.path.join(mav0, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "".join(f"{t},{t}.png\n" for t in ns))
    _write_pngs(scene, [tuple(os.path.join(mav0, c, "data", f"{t}.png") for c in ("cam0", "cam1"))
                        for t in ns])
    os.makedirs(os.path.join(mav0, "imu0"))
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for row in scene.imu:
            f.write(f"{int(round(row[0] * 1e9))}," + ",".join(f"{v:.17g}" for v in row[1:7]) + "\n")
    K = scene.K.astype(np.float64)
    raw = {**_cam(K), "K": {"rows": 3, "cols": 3, "data": K.reshape(-1).tolist()},
           "D": {"rows": 1, "cols": 5, "data": [0.0] * 5},
           "R": {"rows": 3, "cols": 3, "data": np.eye(3).reshape(-1).tolist()},
           "P": {"rows": 3, "cols": 4, "data": np.hstack([K, np.zeros((3, 1))]).reshape(-1).tolist()}}
    return _write_config(os.path.join(root, "config.json"), {
        "rectified": False, "slamMode": 0, "dataset": "EuRoC", "imagesPath": mav0,
        "fileExtension": ".png", "Camera_l": raw, "Camera_r": raw,
        "Camera": {"width": scene.width, "height": scene.height, "fps": 20.0, "bl": float(scene.baseline)},
        "FE": DS_EUROC_FE,
        "IMU": {**DS_EUROC_IMU, "gravity": synthetic.GRAVITY_W.astype(float).tolist()},
    })


def _dataset_run(argv) -> tuple[dict, int]:
    """run_dataset.main on the card: its result, the extract_windows launches
    of the run; no plain window gather may run."""
    with _plain_calls() as plain_devices:
        patches.LAUNCHES = 0
        r = run_dataset.main(argv)
        torch.cuda.synchronize()
        launches = patches.LAUNCHES
    if plain_devices:
        raise AssertionError(f"run_dataset {argv}: {len(plain_devices)} plain calls ({plain_devices})")
    return r, launches


def _native_io() -> tuple[bool, str | None]:
    """Whether phase 17 must run on the native reader: it must wherever the
    machine has g++ and libpng's header (then it has to build); else the
    runs take --no-prefetch, and the build error is printed."""
    toolchain = shutil.which("g++") is not None and os.path.isfile("/usr/include/png.h")
    if toolchain and not native.available():
        raise AssertionError(f"native IO failed to build with g++ and png.h present: {native.build_error()}")
    return native.available(), native.build_error()


def phase_dataset() -> tuple[int, int]:
    """Phase 17: the dataset driver on KITTI 00's 1241x376 and on the EuRoC
    layout with STEREO_IMU."""
    use_native, build_error = _native_io()
    io = [] if use_native else ["--no-prefetch"]
    say("dataset_io", native=use_native, build_error=build_error)
    with tempfile.TemporaryDirectory(prefix="vslam_dataset_") as tmp:
        return _phase_dataset_kitti(tmp, io), _phase_dataset_euroc(tmp, io)


def _phase_dataset_kitti(tmp, io) -> int:
    n = DS_KITTI_FRAMES
    t0 = time.perf_counter()
    scene = synthetic.make_scene(n_frames=n, n_points=900, width=DS_KITTI_W, height=DS_KITTI_H,
                                 fps=10.0, seed=DS_KITTI_SEED)
    root = os.path.join(tmp, "kitti")
    cfg = _kitti_layout(root, scene, n)
    write_s = time.perf_counter() - t0
    p = lambda name: os.path.join(tmp, name)  # noqa: E731
    # each checkpoint's map as the card held it when it was written
    saved, save = [], ckpt_io.save_checkpoint

    def save_and_snapshot(path, world, trk=None):
        save(path, world, trk)
        saved.append({k: v.clone() for k, v in vars(world.arrays).items()})

    ckpt_io.save_checkpoint = save_and_snapshot
    try:
        a, launches = _dataset_run([cfg, *io, "--out", p("a.txt"), "--async-ba", "--global-ba",
                                    "--viz", p("m.html"), "--viz-every", "5", "--ply", p("m.ply"),
                                    "--debug-dir", p("d"), "--debug-every", "10",
                                    "--checkpoint", p("c.npz"), "--checkpoint-every", "5"])
    finally:
        ckpt_io.save_checkpoint = save
    gt = scene.poses_c2w[:n]
    traj_a = trajectory.load_kitti_trajectory(p("a.txt"))
    ate = trajectory.ate_rmse(traj_a, gt, align=False)
    overlays = sorted(os.listdir(p("d")))
    # the live viewer's .json appears once 5 keyframes are in
    names = ("m.html", "m.ply", "c.npz") + (("m.json",) if a["keyframes"] >= 5 else ())
    outputs = {name: os.path.getsize(p(name)) for name in names}
    # the card's last checkpoint, loaded into a CPU world
    cpu_world = map_state.WorldMap(keys_per_kf=system._round_pow2(DS_KITTI_FE["nFeatures"]), device="cpu")
    t1 = time.perf_counter()
    ckpt_io.load_checkpoint(p("c.npz"), cpu_world)
    cpu_load_s = time.perf_counter() - t1
    unequal = [k for k, v in vars(cpu_world.arrays).items() if not torch.equal(v, saved[-1][k].cpu())]
    say("dataset_kitti", argv="run (a)", width=DS_KITTI_W, height=DS_KITTI_H, write_pngs_s=write_s,
        **a, ate_m=ate, extract_windows_launches=launches, overlays=overlays, outputs_bytes=outputs,
        checkpoint_cpu_load_s=cpu_load_s, checkpoint_arrays_unequal_on_cpu=unequal)
    if launches != n or a["frames"] != n:
        raise AssertionError(f"dataset run (a): {a['frames']} frames, {launches} launches, want {n}")
    if not ate <= DS_ATE_GATE_M or not np.isfinite(a["global_ba_error"]):
        raise AssertionError(f"dataset run (a): ATE {ate} m, global BA error {a['global_ba_error']}")
    # a mid-run checkpoint once 5 keyframes are in (the last few keyframes
    # may land in the final flush), and the one at exit
    want_ckpts = 2 if a["keyframes"] >= 8 else 1
    if overlays != [f"frame_{f:06d}.png" for f in range(10, n, 10)] or a["checkpoints"] < want_ckpts or unequal:
        raise AssertionError(f"dataset run (a) outputs: {overlays}, {a['checkpoints']} checkpoints, {unequal}")

    # run (b): stop at frame 20 with a checkpoint, resume to the end
    b, launches_b = _dataset_run([cfg, *io, "--out", p("b.txt"), "--limit", str(DS_RESUME_AT),
                                  "--checkpoint", p("b.npz")])
    r, launches_r = _dataset_run([cfg, *io, "--out", p("r.txt"), "--resume", p("b.npz")])
    traj_r = trajectory.load_kitti_trajectory(p("r.txt"))
    gap = float(np.abs(traj_r[:, :3, :] - traj_a[:, :3, :]).max())
    ate_r = trajectory.ate_rmse(traj_r, gt, align=False)
    say("dataset_kitti", argv="run (b) + resume", part_frames=b["frames"], resumed_from=r["resumed_from"],
        resumed_frames=r["frames"], checkpoint_bytes=b["checkpoint_bytes"],
        checkpoint_write_s=b["checkpoint_write_s"], checkpoint_load_s=r["checkpoint_load_s"],
        resume_gap_m=gap, ate_resumed_m=ate_r, launches=[launches_b, launches_r],
        fps=[b["fps"], r["fps"]])
    if r["resumed_from"] != DS_RESUME_AT or traj_r.shape != (n, 4, 4) or not gap <= DS_RESUME_GAP_M:
        raise AssertionError(f"resume: from {r['resumed_from']}, {traj_r.shape}, gap {gap} m")
    if launches_b + launches_r != n:
        raise AssertionError(f"resume: {launches_b} + {launches_r} launches, want {n}")

    # decode: the native reader and PIL give the same trajectory bit for bit
    if io:
        say("dataset_decode", skipped="native IO unavailable")
        return launches
    d = {}
    for name, extra in (("native", []), ("pil", ["--no-prefetch"])):
        rr, _ = _dataset_run([cfg, *extra, "--out", p(f"{name}.txt"), "--limit", str(DS_DECODE_FRAMES)])
        d[name] = (rr, trajectory.load_kitti_trajectory(p(f"{name}.txt")))
    same = np.array_equal(d["native"][1], d["pil"][1])
    say("dataset_decode", frames=DS_DECODE_FRAMES, identical=same,
        fps={k: v[0]["fps"] for k, v in d.items()},
        frame_p50_ms={k: v[0]["frame_p50_ms"] for k, v in d.items()},
        frame_p90_ms={k: v[0]["frame_p90_ms"] for k, v in d.items()})
    if not same or d["native"][0]["io"] != "native" or d["pil"][0]["io"] != "pil":
        raise AssertionError("native and PIL decode gave different trajectories")
    return launches


def _phase_dataset_euroc(tmp, io) -> int:
    n = DS_EUROC_FRAMES
    scene = synthetic.make_scene(n_frames=n, n_points=900, width=WIDTH, height=HEIGHT, fps=20.0, seed=SEED,
                                 ramp_tau=DS_EUROC_RAMP_TAU)
    root = os.path.join(tmp, "euroc")
    cfg = _euroc_layout(root, scene, n)
    launches = 0
    routes = [("host uint8 remap", [])] if not io else []
    for route, extra in routes + [("device f32 remap", ["--no-prefetch"])]:
        out = os.path.join(tmp, f"euroc_{len(extra)}.txt")
        r, k = _dataset_run([cfg, *extra, "--out", out])
        ate = trajectory.ate_rmse(trajectory.load_kitti_trajectory(out), scene.poses_c2w[:n], align=False)
        say("dataset_euroc", route=route, **r, ate_m=ate, extract_windows_launches=k)
        if r["mode"] != "STEREO_IMU" or r["frames"] != n or k != n or not ate <= IMU_ATE_GATE_M:
            raise AssertionError(f"dataset EuRoC ({route}): {r}, {k} launches, ATE {ate} m")
        launches = k
    return launches


def main() -> int:
    global _POOL
    with concurrent.futures.ProcessPoolExecutor(
        RENDER_WORKERS, mp_context=multiprocessing.get_context("fork")
    ) as _POOL:
        list(_POOL.map(abs, range(RENDER_WORKERS)))  # fork every worker now
        return run()


def run() -> int:
    smi = phase_device()
    phase_build()
    loop_scene = synthetic.make_loop_scene(**LOOP_SCENE)
    t_loop = phase_kernels_loop(loop_scene, torch.device("cuda"), smi)
    scene = synthetic.make_scene(n_frames=N_FRAMES, n_points=900, width=WIDTH, height=HEIGHT,
                                 fps=20.0, seed=SEED)
    t = phase_kernels(scene, torch.device("cuda"), smi)
    t_kitti = phase_kernels_kitti(torch.device("cuda"), smi)
    t_kitti00 = phase_kernels_kitti00(torch.device("cuda"), smi)
    t_mono = phase_kernels_mono(torch.device("cuda"), smi)
    launches_trk, pairs, ate_trk = phase_main_path(scene)
    phase_card_vs_cpu(scene, pairs)
    sys_scene = synthetic.make_scene(n_frames=SYS_SCENE_FRAMES, n_points=900, width=WIDTH,
                                     height=HEIGHT, fps=20.0, seed=SEED)
    launches, sys_pairs, window, sys_, sync_fps = phase_system(sys_scene, ate_trk)
    phase_ba(window, sys_)
    phase_global_ba(sys_, sys_scene)
    del sys_, window
    phase_system_card_vs_cpu(sys_scene, sys_pairs)
    launches_async = phase_async(sys_scene, sys_pairs, sync_fps)
    phase_system_card_vs_cpu(sys_scene, sys_pairs, "async_card_vs_cpu", async_ba=True)
    bins = datasets.bin_imu_per_frame(sys_scene.imu, sys_scene.times)
    launches_imu = phase_imu(sys_scene, sys_pairs, bins)
    launches_kitti, launches_driver_mono = phase_driver()
    launches_mono = phase_mono()
    launches_recovery = phase_recovery()
    launches_loop = phase_loop(loop_scene)
    phase_loop_card_vs_cpu()
    phase_pose_graph()
    launches_ds_kitti, launches_ds_euroc = phase_dataset()
    report = {"kernels": [{
        "name": "extract_windows",
        "route": "cuda",
        "source": "vslam_torch/kernels/csrc/extract_windows.cu",
        "replaces": "vslam_tpu/ops/patches.py:141",
        "launches": launches,
        "launches_by_phase": {"tracker": launches_trk, "system": launches,
                              "async_system": launches_async, "stereo_imu": launches_imu,
                              "kitti_driver": launches_kitti, "mono_driver": launches_driver_mono,
                              "mono_system": launches_mono, "relocalization": launches_recovery,
                              "loop_circuit": launches_loop, "dataset_kitti": launches_ds_kitti,
                              "dataset_euroc": launches_ds_euroc},
        "launches_per_frame": t["launches_per_frame"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["device_ms"],
        "device_ms": t["device_ms"],
        "host_ms_per_call": t["host_ms_per_call"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
        **{f"{name}_table": {k: tab[k] for k in (
            "max_abs_err", "launches_per_frame", "device_ms", "host_ms_per_call", "plain_ms",
            "bound_ms", "library_ms")} for name, tab in (("kitti", t_kitti), ("mono", t_mono),
                                                         ("loop", t_loop), ("kitti00", t_kitti00))},
    }]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
