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
   from the bytes the frame must move. The motion-only LM kernel
   (motion_only_lm.cu) at the tracker's KITTI 00 shape (the two starts,
   B=2, over 4096 active landmarks; kernels/timing.lm_problem): one launch
   (rc 0), held to its plain version on the card (poses within 1e-3),
   then its device ms on a primed stream, host ms per call, device us per
   LM iteration and the plain version's wall ms;
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
   512x384, wall radius 10 m, its first 330 frames: 1.1 laps at the
   bench's 300 frames a lap; 1024 features, active
   set 1024, 32768 landmark and 256 keyframe slots, async BA at a fixed
   latency, loop closure on), frames staged on the card: fps, frame
   p50/p90, keyframes, landmarks, each applied closure (slots, frames,
   pose-graph path, merges, error, wall of its close), the detections'
   and the polishes' walls, closures (>= 1), ATE live (< 0.06 m) and after
   global_ba() (< max(1.1 x live, 0.05) m; tests/test_loop_closure.py:583,
   587), extract_windows launches (330) and plain calls (0); the first
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
   are skipped;
18. parallel (vslam_torch/parallel, vslam_torch/run_batch): the batched
   frontend at the bench configuration (4 sequences, seeds 3, 6, 9, 12, 16
   frames, a sync mapper per sequence) and at S=1: aggregate fps, batched
   frame p50/p90, ATE per sequence (<= 0.05 m), one extract_windows launch
   per batched frame (and one per sequence at frame 0), 0 plain calls; the
   launches, syncs and device busy of one batched frame step at S=1 and
   S=4 (torch.profiler; S=4 under 1.5x S=1's launches); run_batch's
   configuration (320x240, 512 features, 4 levels, 20 frames) at S=1, 4
   and 8, S=4 against each sequence alone (within 2e-3 m); mono-inertial
   (2 x 14 frames) and stereo-inertial (2 x 8) batches against their solo
   runs (2e-3 m; ATE <= 0.06 / 0.04 m); 2 sequences x 8 frames on the card
   and on the CPU (the same keyframes, 1e-3 m / 1e-3 rad); the kernel
   tables of a batched frame 0 (B=8 at the bench shape, B=16 at
   run_batch's); the sharded BA over virtual shards on the card: phase
   7's window on 2 and 4 shards against the unsharded solve (pose log
   1e-3, conditioned points 1e-3, the same kills, error 1e-2 relative),
   per-LM-iteration launches and device busy at 1, 2 and 4 shards,
   run_global on phase 15's corridor over 2 shards (the composed 8-slab
   path, phase 15's gates), and the facade with LocalMapper(mesh=2
   shards) over phase 8's 12 frames against phase 8's card run (the same
   keyframes and BA runs, 1e-3 m);
19. api: the JAX package's last public functions on the card, on phase
   4's frames (no new render) and phase 7's window: extract.extract on
   frame 0's left image (one extract_windows launch, 0 plain calls,
   torch.equal to row 0 of extract_batch(img[None]); against the same call
   on the CPU the keypoints and responses exact, angles within 1e-4 rad,
   >= 99% of the descriptors identical and none more than 2 bits off);
   orb.orientations and orb.brief_descriptors on the blurred levels of
   pyramid.build_pyramid against orientation_from_patches /
   brief_from_patches of the kernel's windows, for the keys at least 15
   px inside their level (the same rules); schur.local_ba_round1 then
   local_ba_round2 against local_ba_two_rounds (pose log within 1e-6, the
   same kills; bit-identical printed); metrics.trace around frame 1 of
   the sync tracker (the trace's bytes, its CUDA kernel events and its
   extract_windows events, >= 1); the phase's wall;
20. bench: vslam_torch.bench's own functions at reduced depth, on the
   card: run_pipeline on the first 24 of phase 6's frames as uint8 (8 of
   warm-up; tracking with the staged async local BA), measure_ba_solves
   with 2 solves, run_mono_pipeline over 24 frames of the lateral scene
   (8 of warm-up; rendered by the pool): fps, solves/s, ATEs (each <=
   0.05 m), keyframes, BA runs, one extract_windows launch per tracked
   frame (24 and 24, the mono bootstrap's views included; none in the
   solves) and 0 plain calls. The loop circuit is phase 16's;
21. tools, run right after phase 5, before any mapper (once the async
   mapper has run in a process, torch.profiler can lose the kernels of a
   short call): vslam_torch.tools' profile_rtt, profile_solver and
   roofline on the card with 2 repetitions per timing, the roofline on its
   own scene (the bench's at 12 frames; phase 4's 16-frame scene has
   another landmark slab), rendered by the pool during phase 5: every
   roofline row timed (device ms > 0) and at most 100% of its bound, the
   one-launch patch row a single extract_windows launch, the warm-up one
   launch per tracked frame (8), no plain call; frame 9's extract_batch
   and stereo_match on the card against the same stages on the CPU (a
   pool process): keys, octaves, masks, responses, idx_r and matched
   exact, angles and descriptors by phase 19's rules, disparity within
   1e-3 px and depth within 1e-3 relative; the phase's wall;
22. dryrun, run right after phase 21: the JAX package's multi-device dry
   run on the port (vslam_torch/dryrun.py) on this card: the entry's
   frame step at the bench's shapes (one extract_windows launch, the pose
   within 0.05 m of frame 1's truth), then dryrun_multichip over 4 virtual
   shards on cuda:0: (a) the live-size two-round BA (20 poses, 4096
   landmarks, 24,576 rows, 2 + 2 iterations) and (b) the same in 4
   landmark slabs (1 + 1) against the unsharded card solve (pose log
   1e-3, points 1e-3, the same kills, error 1e-2 relative), (c) 4
   sequences at 160x120, one batched frontend per shard, one launch each,
   every window call torch.equal to its plain version; part (c)'s table
   (B=2, 3 levels, 128 keys) timed like phase 3's. Its launches are
   "dryrun" in launches_by_phase. Four distinct cards are not this
   script's: `python -m vslam_torch.dryrun --devices 4` on a 4-card
   machine.

Frames are rendered on the host by 8 processes forked at start-up,
before CUDA is initialized, and stopped at the end. The CPU sides of the
card-vs-CPU checks (phases 5, 8, 10, 11, 13 and 18) run in those
processes too (2 torch threads each), while the card works: phases 8, 10
and 11's during phases 7 and 15, the others beside untimed card work.

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
import threading
import time

import numpy as np
import torch

from vslam_torch import bench, dryrun, kernels, native, run_batch, run_dataset, run_synthetic
from vslam_torch.geometry import se3, triangulate
from vslam_torch.kernels import timing
from vslam_torch.models import local_mapper, loop_closure, map_state, pose_graph, reloc, system, tracker
from vslam_torch.ops import extract, imu, lm, orb, patches, pyramid, schur
from vslam_torch.parallel import mesh as par_mesh, multi_seq, sharded_ba
from vslam_torch.tools import _common as tool_common, profile_rtt, profile_solver, roofline
from vslam_torch.utils import checkpoint as ckpt_io, datasets, metrics, synthetic, trajectory
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
# (tests/test_loop_closure.py:583, 587), cut from 1.2 laps in 360 frames to
# 1.1 in 330 (the same motion per frame, so the same first 330 frames; the
# closures at frames 283 and 319 stay, the one at 348 goes): phases 1-16
# took 779 s of the 1200 s limit before phases 17 and 18; one lap, with
# the closure at 283 alone, ends with a live ATE over the gate (PERF.md
# section 4)
LOOP_W, LOOP_H, LOOP_FRAMES = 512, 384, 330
LOOP_SCENE = dict(n_frames=LOOP_FRAMES, width=LOOP_W, height=LOOP_H, loops=1.1, wall_radius=10.0)
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


def _render_async(scene, n: int, stereo: bool = True) -> list:
    """Start rendering frames 0..n-1 of `scene` on the pool; the futures of
    the chunks, in frame order (_collect waits for them)."""
    chunks = [c for c in np.array_split(np.arange(n), 4 * RENDER_WORKERS) if len(c)]
    return [_POOL.submit(_render_frames, scene, c, stereo) for c in chunks]


CPU_THREADS = 2  # torch threads of a CPU-side run in a pool process


def _in_pool(fn, args):
    torch.set_num_threads(CPU_THREADS)
    return fn(*args)


def _cpu_side(fn, *args):
    """Start fn(*args), the CPU side of a card-vs-CPU check, in a pool
    process (forked before CUDA was initialized), so that it runs while
    the card works; the future of its (picklable) result."""
    return _POOL.submit(_in_pool, fn, args)


def _collect(futures: list) -> list:
    return [v for fut in futures for v in fut.result()]


def _render(scene, n: int, stereo: bool = True) -> list:
    """Frames 0..n-1 of `scene` ((2, H, W) L+R pairs, or (H, W) views),
    rendered by the pool (the renderer is a Python loop over patches, one
    core per view)."""
    return _collect(_render_async(scene, n, stereo))


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
                  seed=SEED, mono=False, n_levels=PARAMS["n_levels"]):
    """The main path's inputs to extract_windows for frame 0: every level's
    blurred L+R image (the left one alone with `mono`; a list of scenes
    gives a batched frame's views, L0 R0 L1 R1 ...), the level quota of
    keys, corners from a seeded generator including the extreme corners."""
    views = []
    for sc in scene if isinstance(scene, list) else [scene]:
        views += [sc.render(0)] if mono else [sc.render(0), sc.render(0, right=True)]
    imgs = torch.from_numpy(np.stack(views)).to(dev)
    B = imgs.shape[0]
    shapes = pyramid.level_shapes(height, width, n_levels, 1.2)
    quotas = extract.level_quotas(n_features, n_levels, 1.2)
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


# The LM kernel against its plain version on phase 3's one fixed problem
# (seed 0): both converge in the same iterations, so they differ by the
# rounding of their sums in different orders (poses 4.8e-7 apart on the
# H100). A pose 1e-5 off moves a pixel by under 0.01 px and a chi^2 near
# the gate by under 0.05, so rows within 0.1 of it may classify apart;
# float32 sums of ~3,000 rows in two orders agree to ~1e-6 relative.
LM_POSE_TOL, LM_COST_RTOL, LM_CHI2_MARGIN = 1e-5, 1e-4, 0.1


def phase_kernels_lm(smi) -> dict:
    """The motion-only LM kernel at the tracker's KITTI 00 shape: one
    launch, against the plain version on the same inputs (poses, final
    cost, inlier and stereo masks away from the gate), then timed, with its
    bound."""
    args, _ = timing.lm_problem(B=2, M=4096, device="cuda")
    n0, its = lm.LAUNCHES, []
    T, chi2, inl, st, res = lm.motion_only_ba(*args, stats=its)
    launches = lm.LAUNCHES - n0
    its_r = []
    T_r, chi2_r, inl_r, st_r, res_r = lm.motion_only_ba_ref(*args, stats=its_r)
    torch.cuda.synchronize()
    pose_err = float((T - T_r).abs().max())
    cost_rel = float(((res.error - res_r.error).abs() / res_r.error).max())
    near = (timing.lm_near_gate(args, T_r, chi2_r, LM_CHI2_MARGIN)
            | timing.lm_near_gate(args, T, chi2, LM_CHI2_MARGIN))
    differ = int(((inl != inl_r) | (st != st_r))[~near].sum())
    if launches != 1 or pose_err > LM_POSE_TOL or cost_rel > LM_COST_RTOL or differ:
        raise AssertionError(f"motion_only_lm: {launches} launches; against the plain version poses {pose_err}, "
                             f"cost {cost_rel} relative, {differ} rows classified apart away from the gate")
    t = timing.lm_table(args)
    say("kernel", name="motion_only_lm", shape="KITTI 00 tracker two starts, B=2, A=4096", card=smi, rc=0,
        pose_err=pose_err, cost_rel_err=cost_rel, rows_near_gate=int(near.sum()), rows_differing_elsewhere=differ,
        plain_iterations=its_r, **t)
    return t


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
    t = {"launches_per_frame": patches.LAUNCHES - n0, **timing.window_table(levels, counts, x0, y0, P)}
    frame_bytes, covered = t.pop("bytes"), t.pop("covered_pixels")
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
        patches.LAUNCHES = lm.LAUNCHES = 0
        t0 = time.perf_counter()
        trk, poses = _run_tracker(scene, frames, dev)
        torch.cuda.synchronize()
        track_s = time.perf_counter() - t0
        launches, lm_launches, plain_calls = patches.LAUNCHES, lm.LAUNCHES, len(plain_devices)

    want = N_FRAMES  # one launch per stereo frame, every level
    if launches != want:
        raise AssertionError(f"extract_windows launched {launches} times, want {want}")
    _check_lm_launches(lm_launches, trk.counters)
    if plain_calls:
        raise AssertionError(f"plain versions ran {plain_calls} times ({plain_devices})")
    if poses.shape != (N_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory {poses.shape}")
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:N_FRAMES], align=False)
    stages = trk.metrics.summary()
    say("main_path", frames=N_FRAMES, fps=N_FRAMES / track_s, track_s=track_s,
        render_s=render_s, keyframes=len(trk.new_kf_slots), landmarks=trk.world.n_landmarks,
        ate_m=ate, extract_windows_launches=launches, motion_only_lm_launches=lm_launches,
        radius_attempts=trk.counters.get("radius_attempts"), plain_calls_on_card=plain_calls,
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


def _cpu_tracker(scene, pairs) -> tuple:
    """The tracker alone on the CPU: keyframe slots, their frames, poses."""
    trk, poses = _run_tracker(scene, [torch.from_numpy(p) for p in pairs], "cpu")
    return trk.new_kf_slots, trk.world.kf_frame_idx[: trk.world.n_keyframes].copy(), poses


def phase_card_vs_cpu(scene, pairs):
    sub = pairs[:CPU_FRAMES]
    cpu = _cpu_side(_cpu_tracker, scene, sub)
    t_gpu, p_gpu = _run_tracker(scene, [torch.from_numpy(p).cuda() for p in sub], "cuda")
    kf_cpu, kf_frames_cpu, p_cpu = cpu.result()
    if t_gpu.new_kf_slots != kf_cpu:
        raise AssertionError(f"keyframes differ: card {t_gpu.new_kf_slots} cpu {kf_cpu}")
    n = t_gpu.world.n_keyframes
    if not np.array_equal(t_gpu.world.kf_frame_idx[:n], kf_frames_cpu):
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


def _check_lm_launches(launches: int, counters):
    """On the card every radius attempt's pose solve is one launch of the
    motion-only LM kernel, and nothing else launches it in a run with no
    relocalization."""
    attempts, solves = counters.get("radius_attempts"), counters.get("lm_kernel_solves")
    if not launches == solves == attempts > 0:
        raise AssertionError(f"motion_only_lm launched {launches} times, {solves} kernel solves, "
                             f"{attempts} radius attempts")


@contextlib.contextmanager
def _plain_calls():
    """Count every call of the card kernels' plain versions while the block
    runs: the window gather's (the device of the corners each got) and, on
    CUDA tensors, the motion-only pose solve's (``lm.motion_only_ba_ref``,
    and ``lm.lm_solve`` outside the IMU solve, which has no kernel; as
    "<name>:cuda"). On the card the main path must never reach them."""
    devices, in_imu = [], threading.local()

    def window(fn):
        def run(*args):
            devices.append(args[2].device.type)
            return fn(*args)
        return run

    def pose_solve(name, fn):
        def run(*args, **kwargs):
            x = args[0] if name == "motion_only_ba_ref" else args[2]
            if not getattr(in_imu, "depth", 0) and torch.is_tensor(x) and x.is_cuda:
                devices.append(f"{name}:cuda")
            return fn(*args, **kwargs)
        return run

    def imu_solve(fn):
        def run(*args, **kwargs):
            in_imu.depth = getattr(in_imu, "depth", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                in_imu.depth -= 1
        return run

    watched = [(patches, n, window) for n in ("extract_windows_ref", "extract_windows_levels_ref")]
    watched += [(lm, n, lambda fn, n=n: pose_solve(n, fn)) for n in ("motion_only_ba_ref", "lm_solve")]
    watched += [(lm, "motion_only_ba_imu", imu_solve)]
    plain = [(mod, n, getattr(mod, n)) for mod, n, _ in watched]
    for (mod, n, wrap), (_, _, fn) in zip(watched, plain):
        setattr(mod, n, wrap(fn))
    try:
        yield devices
    finally:
        for mod, n, fn in plain:
            setattr(mod, n, fn)


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
            patches.LAUNCHES = lm.LAUNCHES = 0
            t0 = time.perf_counter()
            poses = _run_system(sys_, frames)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches, lm_launches, plain_calls = patches.LAUNCHES, lm.LAUNCHES, len(plain_devices)
    finally:
        local_mapper.schur.local_ba_two_rounds = solve

    if launches != SYS_FRAMES:
        raise AssertionError(f"extract_windows launched {launches} times, want {SYS_FRAMES}")
    _check_lm_launches(lm_launches, sys_.tracker.counters)
    if plain_calls:
        raise AssertionError(f"plain versions ran {plain_calls} times ({plain_devices})")
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
        extract_windows_launches=launches, motion_only_lm_launches=lm_launches,
        radius_attempts=sys_.tracker.counters.get("radius_attempts"), plain_calls_on_card=plain_calls,
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


# a landmark's 3x3 block beyond this condition number has no depth that
# f32 can resolve (the 24 km landmark of phase 7's window, PERF.md)
LM_COND_MAX = 1e6


def _conditioned(q: schur.BAProblem, p: schur.BAProblem):
    """The valid landmarks of a solved window `q` whose undamped 3x3 block
    has a condition number under LM_COND_MAX (an unconditioned one moves
    along its ray under any change of the step); with each landmark's row
    count and its block's eigenvalues."""
    n_rows = torch.bincount(q.obs_lm[q.obs_valid], minlength=p.pts.shape[0])
    ev = torch.linalg.eigvalsh(schur._assemble(q)[1].double())
    return p.pt_valid & (n_rows > 0) & (ev[:, 0] * LM_COND_MAX > ev[:, 2]), n_rows, ev


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
    n_stereo = torch.bincount(q.obs_lm[q.obs_valid & q.obs_stereo], minlength=L)
    placed, n_rows, ev = _conditioned(q, p)
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
    prof = metrics.profile_counts(lambda: _solve(p))
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
    say("ba_breakdown", **{name: metrics.profile_counts(lambda fn=fn: (fn(), torch.cuda.synchronize()))
                           for name, fn in pieces.items()})

    # one whole LocalMapper.run (triangulation, assembly, BA, write-back,
    # host bookkeeping) on phase 6's final map, and the DLT's batched eigh
    # alone at the mapper's shape (1024 candidates, 13 views)
    slot = sys_.tracker.new_kf_slots[-1]
    run = metrics.profile_counts(lambda: (sys_.mapper.run(slot), torch.cuda.synchronize()))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    Pv = torch.randn((13, 3, 4), device="cuda", generator=g)
    uv = torch.rand((PARAMS["n_features"], 13, 2), device="cuda", generator=g) * WIDTH
    mask = torch.ones((PARAMS["n_features"], 13), dtype=torch.bool, device="cuda")
    dlt = metrics.profile_counts(lambda: (triangulate.triangulate_dlt(Pv, uv, mask), torch.cuda.synchronize()))
    say("mapper_run", kf_slot=slot, **run, dlt_kernel_launches=dlt["kernel_launches"],
        dlt_stream_syncs=dlt["stream_syncs"] - 1)
    return prof


def _cpu_system(scene, pairs, imu_bins, kw: dict) -> tuple:
    """The facade (`kw` as for _system) on the CPU: keyframe slots, BA
    runs, poses."""
    c = _system(scene, "cpu", **kw)
    pc = _run_system(c, [torch.from_numpy(p) for p in pairs], imu_bins)
    return c.tracker.new_kf_slots, c.mapper.ba_count, pc


def cpu_system(scene, pairs, n=SYS_CPU_FRAMES, imu_bins=None, **kw):
    """Start the CPU side of phase_system_card_vs_cpu on the pool."""
    return _cpu_side(_cpu_system, scene, pairs[:n], imu_bins, kw)


def phase_system_card_vs_cpu(scene, pairs, cpu, phase="system_card_vs_cpu", n=SYS_CPU_FRAMES,
                             imu_bins=None, **kw):
    """The facade (`kw` as for _system) over the first `n` frames on the
    card against `cpu`, the future of the same run on the CPU (cpu_system):
    the same keyframes and BA runs, poses within POSE_TOL."""
    sub = pairs[:n]
    g = _system(scene, "cuda", **kw)
    pg = _run_system(g, [torch.from_numpy(p).cuda() for p in sub], imu_bins)
    kf_c, ba_c, pc = cpu.result()
    if g.tracker.new_kf_slots != kf_c or g.mapper.ba_count != ba_c:
        raise AssertionError(
            f"{phase}: keyframes/BA differ: card {g.tracker.new_kf_slots} {g.mapper.ba_count}, "
            f"cpu {kf_c} {ba_c}")
    dt, ang = _pose_diff(pg, pc)
    say(phase, frames=n, keyframes=g.tracker.new_kf_slots, ba_runs=g.mapper.ba_count,
        max_dt_m=float(dt.max()), max_drot_rad=float(ang.max()))
    if dt.max() > POSE_TOL_M or ang.max() > POSE_TOL_RAD:
        raise AssertionError(f"{phase}: card and CPU poses differ: {dt.max()} m, {ang.max()} rad")
    return g.tracker.new_kf_slots, g.mapper.ba_count, pg


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


def phase_imu(scene, pairs, bins, cpu) -> int:
    """STEREO_IMU with the sync mapper over the system frames, then the 15-dof
    solve and the preintegration alone (the last of each the run made);
    `cpu`: the CPU side of its card-vs-CPU check (cpu_system)."""
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
        prof[name] = metrics.profile_counts(lambda: (fn(*args, **kwargs), torch.cuda.synchronize()))
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
        preintegrate=prof["preintegrate"],
        preintegrate_rows=len(imu.active_rows(last["preintegrate"][1][0][0])))
    if not ate <= IMU_ATE_GATE_M:
        raise AssertionError(f"STEREO_IMU ATE {ate} m > {IMU_ATE_GATE_M} m")
    phase_system_card_vs_cpu(scene, pairs, cpu, "stereo_imu_card_vs_cpu", IMU_CPU_FRAMES, bins, imu=True)
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
    scene."""
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


def _cpu_mono(scene, imgs, bins) -> tuple:
    """The mono facade on the CPU: bootstrap and keyframe slots, landmark
    count, poses."""
    c = _mono_system(scene, "cpu")
    pc, _ = _run_mono(c, [torch.from_numpy(i) for i in imgs], bins)
    return c.tracker.bootstrap_slots, c.tracker.new_kf_slots, c.world.n_landmarks, pc


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
    n = MONO_CPU_FRAMES
    cpu = _cpu_side(_cpu_mono, scene, imgs[:n], bins)  # while the untimed repeat runs
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

    g = _mono_system(scene, "cuda")
    pg, _ = _run_mono(g, frames[:n], bins)
    boot_c, kf_c, n_lm_c, pc = cpu.result()
    same = g.tracker.bootstrap_slots == boot_c and g.tracker.new_kf_slots == kf_c
    dt, ang = _pose_diff(pg, pc)
    say("mono_card_vs_cpu", frames=n, keyframes=g.tracker.new_kf_slots,
        bootstrap_slots=g.tracker.bootstrap_slots, same_slots=same,
        landmarks_card=g.world.n_landmarks, landmarks_cpu=n_lm_c,
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
               "retrieve": metrics.profile_counts(lambda: (reloc.retrieve(*args, **kwargs), torch.cuda.synchronize()))}
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


def _corridor_map(mesh=None):
    """Phase 15's map: tests/test_ba.py:231-283's corridor with drifted
    poses on the card, and a mapper on it (3 + 5 LM iterations; `mesh`:
    sharded). Returns (world, the corridor's truth, the drifted poses,
    mapper)."""
    world, c = synthetic.corridor_world(MAP_KF, MAP_LM, PARAMS["n_features"], device="cuda")
    rng = np.random.default_rng(1)
    drift = np.cumsum(rng.normal(0, 0.004, (MAP_KF, 3)), axis=0).astype(np.float32)
    drift[0] = 0.0
    pert = c["poses"].copy()
    pert[:, :3, 3] += drift
    world.arrays.kf_pose.copy_(torch.from_numpy(pert))
    world.kf_poses_host[:] = pert
    mapper = local_mapper.LocalMapper(
        world, c["K"], c["baseline"], local_mapper.LocalMapperConfig(iters_round1=3, iters_round2=5),
        mesh=mesh,
    )
    return world, c, pert, mapper


def _corridor_rel_err(ps, c) -> float:
    """Mean relative translation error over 5-keyframe steps against the
    corridor's truth (tests/test_ba.py:276-283)."""
    d = np.linalg.inv(ps[:-5]) @ ps[5:]
    dg = np.linalg.inv(c["poses"][:-5]) @ c["poses"][5:]
    return float(np.mean(np.linalg.norm(d[:, :3, 3] - dg[:, :3, 3], axis=1)))


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
    prof = metrics.profile_counts(lambda: (m.run_global(), torch.cuda.synchronize()))
    say("global_ba", keyframes=len(r["window"]), wall_s=wall, lm_iters=iters, error=r["error"],
        ate_before_m=ate0, ate_after_m=ate1, second_run=prof)
    if not (np.isfinite(r["error"]) and ate1 <= ATE_GATE_M):
        raise AssertionError(f"global BA: error {r['error']}, ATE {ate0} -> {ate1} m")

    world, c, pert, mapper = _corridor_map()
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
    rel_err = lambda ps: _corridor_rel_err(ps, c)
    p, n_slabs = problems[-1]
    it = metrics.profile_counts(lambda: (schur.local_ba(p, iters=1, n_slabs=n_slabs), torch.cuda.synchronize()),
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


def phase_loop(scene, while_running=None) -> int:
    """Phase 16: the bench's loop circuit through the facade on the card,
    then the first applied closure replayed twice from a copy of the map
    taken just before it. `while_running` is called once the circuit's
    frames are rendered: it may start the renders of a later phase on the
    pool, which is idle while this phase runs on the card."""
    t0 = time.perf_counter()
    frames = _stage(_render(scene, LOOP_FRAMES))
    if while_running is not None:
        while_running()
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
    p4, p8 = (metrics.profile_counts(lambda k=k: (pose_graph.optimize_chain(*dev_args, iters=k), torch.cuda.synchronize()))
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

    # run (b): stop at DS_RESUME_AT with a checkpoint, resume to the end
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


# ---------------------------------------------------------------------------
# phase 18: the parallel layer (vslam_torch/parallel, vslam_torch/run_batch)
# ---------------------------------------------------------------------------
PAR_BENCH_SEQS, PAR_BENCH_FRAMES = 4, 16
PAR_SMALL_SEQS, PAR_SMALL_FRAMES = (1, 4, 8), 20
PAR_SOLO_TOL_M = 2e-3  # batched against solo, tests/test_parallel.py:292
PAR_INERTIAL = {  # mode: (sequences, frames, ATE gate), tests/test_parallel.py:299-470
    "mono": (2, 14, 0.06), "stereo_imu": (2, 8, 0.04)}
PAR_CPU_SEQS, PAR_CPU_FRAMES = 2, 8
PAR_SHARDS = (2, 4)
PAR_MAPPER_FRAMES = SYS_CPU_FRAMES  # phase 8's card run is the unsharded reference
PAR_LAUNCH_RATIO = 1.5  # launches of a batched frame at S=4 against S=1


def _inertial_scenes(mode: str) -> list:
    """tests/test_parallel.py:299-470's scenes (320x240): mono lateral with
    distinct texture, seeds 11 + 5s; stereo-IMU seeds 7 + 5s."""
    S, n, _ = PAR_INERTIAL[mode]
    kw = (dict(n_points=500, texture="distinct", motion="lateral") if mode == "mono"
          else dict(n_points=400))
    seed0 = 11 if mode == "mono" else 7
    return [synthetic.make_scene(n_frames=n, width=320, height=240, fps=10.0, seed=seed0 + 5 * s, **kw)
            for s in range(S)]


# phase 18's scenes: name -> (scenes, frames, stereo)
_PAR_SCENES = {
    "bench": lambda: (run_batch.scenes(PAR_BENCH_SEQS, PAR_BENCH_FRAMES, "bench"), PAR_BENCH_FRAMES, True),
    "small": lambda: (run_batch.scenes(max(PAR_SMALL_SEQS), PAR_SMALL_FRAMES, "small"),
                      PAR_SMALL_FRAMES, True),
    **{mode: (lambda mode=mode: (_inertial_scenes(mode), PAR_INERTIAL[mode][1], mode != "mono"))
       for mode in PAR_INERTIAL},
}
def start_parallel_renders(renders: dict):
    """Start rendering every frame phase 18 needs on the pool, into
    `renders` (name -> (scenes, per-scene render futures)); called while
    phase 16 runs on the card."""
    for name, make in _PAR_SCENES.items():
        scenes, n, stereo = make()
        renders[name] = (scenes, [_render_async(sc, n, stereo) for sc in scenes])


def _par_views(renders: dict, name: str):
    """(scenes, per-scene views) of one of phase 18's scene sets: the early
    renders when they were started, else rendered now."""
    if name not in renders:
        scenes, n, stereo = _PAR_SCENES[name]()
        renders[name] = (scenes, [_render_async(sc, n, stereo) for sc in scenes])
    scenes, futures = renders.pop(name)
    return scenes, [_collect(f) for f in futures]


def _staged_batch(views: list) -> list:
    """Per-scene (2, H, W) views as one (S, 2, H, W) tensor per frame on the
    card."""
    frames = [torch.from_numpy(np.stack([v[f] for v in views])).to("cuda") for f in range(len(views[0]))]
    torch.cuda.synchronize()
    return frames


def _batch_run(config: str, S: int, n: int, frames: list, device="cuda") -> dict:
    """run_batch's frontend and per-sequence sync mappers over n staged
    frames of the first S sequences: wall, aggregate fps, batched-frame
    p50/p90, ATE per sequence, keyframes, BA runs, extract_windows launches
    and plain calls."""
    scenes, pairs, front = run_batch.build(S, n, config, device)
    frames = [f[:S].to(device) for f in frames]
    with _plain_calls() as plain:
        patches.LAUNCHES = 0
        t0 = time.perf_counter()
        run_batch.run_frames(front, pairs, frames)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = patches.LAUNCHES
    poses = [p[0].trajectory() for p in pairs]
    step = front.metrics.summary()["track"]
    return {
        "scenes": scenes, "pairs": pairs, "front": front, "frames": frames, "poses": poses,
        "wall_s": wall, "aggregate_fps": S * n / wall, "frame_p50_ms": step["p50_ms"],
        "frame_p90_ms": step["p90_ms"], "launches": launches, "plain_calls": len(plain),
        "ate_m": [float(trajectory.ate_rmse(pz, sc.poses_c2w[:n], align=False))
                  for pz, sc in zip(poses, scenes)],
        "keyframes": [len(p[0].new_kf_slots) for p in pairs], "ba_runs": [p[1].ba_count for p in pairs],
    }


def _check_batch(tag: str, r: dict, S: int, n: int, gate: float):
    """One launch per batched frame and one per sequence's frame 0, no plain
    call on the card, every ATE under the gate."""
    if r["launches"] != (n - 1) + S or r["plain_calls"]:
        raise AssertionError(f"{tag}: {r['launches']} extract_windows launches (want {n - 1 + S}), "
                             f"{r['plain_calls']} plain calls")
    if not all(np.isfinite(p).all() and p.shape == (n, 4, 4) for p in r["poses"]):
        raise AssertionError(f"{tag}: bad trajectories")
    if max(r["ate_m"]) > gate:
        raise AssertionError(f"{tag}: ATE {r['ate_m']} > {gate} m")


def _step_profile(r: dict) -> dict:
    """Launches, syncs and device busy of one batched frame step (the
    frontend's last frame again, from the trackers' current states)."""
    front = r["front"]
    ts = front.trackers
    t0 = ts[0]
    state = tracker.stack_trees([t._state for t in ts])

    def step():
        tracker.track_step_batch(
            r["frames"][-1], state, t0._radii, t0.params.refine_radius, t0._desc_thr, t0._ratio,
            front._K_b, front._bl_b, t0.scale_factors, t0.params, t0.width, t0.height)
        torch.cuda.synchronize()

    step()
    return metrics.profile_counts(step)


def _summary(r: dict) -> dict:
    return {k: r[k] for k in ("wall_s", "aggregate_fps", "frame_p50_ms", "frame_p90_ms", "launches",
                              "plain_calls", "ate_m", "keyframes", "ba_runs")}


def _solo_gap(r: dict, solo: list) -> float:
    """Largest translation gap between each batched sequence and its solo run."""
    return max(float(_pose_diff(b, s)[0].max()) for b, s in zip(r["poses"], solo))


def _solo_stereo(frames, config: str, seq: int, device="cuda"):
    """Sequence `seq` of a configuration alone through StereoTracker.track
    and its sync mapper."""
    _, pairs, _ = run_batch.build(seq + 1, len(frames), config, device)
    trk, mapper = pairs[seq]
    for fr in frames:
        nk = len(trk.new_kf_slots)
        trk.track(fr)
        if len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
            out = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(out["kf_slot"], out["old_pose"], out["new_pose"])
            trk.add_active(out["new_lm_ids"])
    return trk.trajectory()


def _inertial_pair(mode: str, scene, device):
    """tests/test_parallel.py:299-470's tracker and mapper (320x240, 512
    features, 4 levels, the IMU block of its ImuConfig)."""
    p = tracker.TrackerParams(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256,
                              **({} if mode == "mono" else {"kf_min_stereo": 60}))
    K = scene.K.astype(np.float32)
    world = map_state.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512, device=device)
    cfg = tracker.ImuConfig(gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3,
                            hz=200.0, T_bc=np.eye(4, dtype=np.float32),
                            gravity_w=synthetic.GRAVITY_W.astype(np.float32))
    if mode == "mono":
        trk = tracker.MonoTracker(K, scene.width, scene.height, world, p, imu_cfg=cfg, device=device)
    else:
        trk = tracker.StereoTracker(K, scene.baseline, scene.width, scene.height, world, p,
                                    imu_cfg=cfg, device=device)
    trk.velocity = scene.velocities[0].astype(np.float32)
    mapper = local_mapper.LocalMapper(world, K, 0.0 if mode == "mono" else scene.baseline,
                                      local_mapper.LocalMapperConfig(n_levels=4, scale=1.2))
    return trk, mapper


def _inertial_service(mode, trk, mapper, nk):
    if mode == "mono":
        if trk.needs_init_triangulation:
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            trk.add_active(ids)
            trk.needs_init_triangulation = False
            trk.last_kf_tracked = max(len(ids), 1)
        elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
            trk.add_active(mapper.find_new_points(trk.new_kf_slots[-1], mono=True))
    elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
        out = mapper.run(trk.new_kf_slots[-1])
        trk.reanchor(out["kf_slot"], out["old_pose"], out["new_pose"])
        trk.add_active(out["new_lm_ids"])


def _dt_rows(bins, f):
    """A frame's [dt, gyro, accel] rows (tests/test_parallel.py:313-321)."""
    rows = bins[f]
    if rows is None or len(rows) == 0:
        return None
    t = rows[:, 0]
    dts = np.diff(np.concatenate([[t[0] - 1.0 / 200.0], t]))
    return np.concatenate([np.maximum(dts, 0)[:, None], rows[:, 1:7]], axis=1).astype(np.float32)


def _inertial_batch(mode: str, renders: dict) -> dict:
    """Mono-inertial or stereo-inertial sequences batched on the card,
    against each sequence alone on the card."""
    S, n, gate = PAR_INERTIAL[mode]
    scenes, views = _par_views(renders, mode)
    frames = [[torch.from_numpy(v[f]).to("cuda") for v in views] for f in range(n)]
    rows = [[_dt_rows(datasets.bin_imu_per_frame(sc.imu, sc.times), f) for sc in scenes] for f in range(n)]
    solo = []
    for s, sc in enumerate(scenes):
        trk, mapper = _inertial_pair(mode, sc, "cuda")
        for f in range(n):
            nk = len(trk.new_kf_slots)
            trk.track(frames[f][s], imu=rows[f][s])
            _inertial_service(mode, trk, mapper, nk)
        solo.append(trk.trajectory())
    pairs = [_inertial_pair(mode, sc, "cuda") for sc in scenes]
    front = multi_seq.BatchedStereoFrontend([p[0] for p in pairs])
    with _plain_calls() as plain:
        patches.LAUNCHES = 0
        t0 = time.perf_counter()
        for f in range(n):
            nks = [len(p[0].new_kf_slots) for p in pairs]
            front.track(frames[f], imu=rows[f])
            for (trk, mapper), nk in zip(pairs, nks):
                _inertial_service(mode, trk, mapper, nk)
        front.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = patches.LAUNCHES
    poses = [p[0].trajectory() for p in pairs]
    ate = [float(trajectory.ate_rmse(pz, sc.poses_c2w[:n], align=False)) for pz, sc in zip(poses, scenes)]
    gap = max(float(_pose_diff(b, s_)[0].max()) for b, s_ in zip(poses, solo))
    batched = front.metrics.summary().get("track", {}).get("count", 0)
    # one launch per batched frame, and per sequence one per frame it
    # tracked alone (stereo: frame 0; mono: every bootstrap view and every
    # frame after its init until the last sequence initialized)
    alone = 0
    for trk, _ in pairs:
        if trk._mono:
            init = int(trk.world.kf_frame_idx[trk.bootstrap_slots[-1]]) + 1
            alone += len(trk.bootstrap_slots) + (n - batched - init)
        else:
            alone += n - batched
    out = {"sequences": S, "frames": n, "wall_s": wall, "aggregate_fps": S * n / wall,
           "batched_frames": batched, "launches": launches, "launches_alone": alone,
           "plain_calls": len(plain), "ate_m": ate, "max_gap_to_solo_m": gap,
           "keyframes": [len(p[0].new_kf_slots) for p in pairs]}
    say(f"parallel_{mode}", **out)
    if len(plain) or batched < 1 or launches != batched + alone:
        raise AssertionError(f"parallel_{mode}: {launches} launches for {batched} batched frames "
                             f"and {alone} alone, {len(plain)} plain calls")
    if gap > PAR_SOLO_TOL_M or max(ate) > gate:
        raise AssertionError(f"parallel_{mode}: gap to solo {gap} m, ATE {ate} (gate {gate} m)")
    return out


def _batch_tables(dev, smi) -> dict:
    """extract_windows_levels on the tables of a batched frame 0: 4
    sequences at the bench shape (B=8) and 8 at run_batch's (B=16)."""
    out = {}
    for name, config, S, (H, W, n_feat, n_lv) in (
        ("batch_bench", "bench", PAR_BENCH_SEQS, (HEIGHT, WIDTH, PARAMS["n_features"], PARAMS["n_levels"])),
        ("batch_small", "small", max(PAR_SMALL_SEQS), (240, 320, 512, 4)),
    ):
        cases = _level_inputs(run_batch.scenes(S, 1, config), dev, H, W, n_feat, seed=SEED,
                              n_levels=n_lv)
        agree, errs = _agreement()
        t = _table(cases, agree, smi, f"{config} {W}x{H}, {n_feat} keys, frame 0, {n_lv} levels, "
                                      f"{S} sequences L+R (B={2 * S}), one launch")
        out[name] = {"max_abs_err": max(errs), **t}
    return out


def _cpu_batch(frames: list) -> tuple:
    """run_batch's configuration batched on the CPU over `frames` ((S, 2,
    H, W) arrays): keyframe slots and poses per sequence."""
    r = _batch_run("small", PAR_CPU_SEQS, PAR_CPU_FRAMES, [torch.from_numpy(f) for f in frames],
                   device="cpu")
    return [p[0].new_kf_slots for p in r["pairs"]], r["poses"]


def phase_parallel(window: schur.BAProblem, sys_scene, sys_pairs, unsharded, renders: dict) -> dict:
    """Phase 18: the batched frontend (bench and run_batch configurations,
    mono- and stereo-inertial), card against CPU, and the sharded BA over
    virtual shards on the card. `renders`: the frames started by
    start_parallel_renders (what is missing is rendered here)."""
    launches = {}
    # 1. the bench configuration, S=4 and S=1 through the same frontend
    t0 = time.perf_counter()
    staged = _staged_batch(_par_views(renders, "bench")[1])
    say("parallel_frames", name="bench", wait_s=time.perf_counter() - t0)
    prof = {}
    for S in (PAR_BENCH_SEQS, 1):
        r = _batch_run("bench", S, PAR_BENCH_FRAMES, staged)
        _check_batch(f"parallel_bench_s{S}", r, S, PAR_BENCH_FRAMES, ATE_GATE_M)
        t0 = time.perf_counter()
        prof[S] = _step_profile(r)
        launches[f"batch_bench_s{S}"] = r["launches"]
        say("parallel_bench", sequences=S, frames=PAR_BENCH_FRAMES, **_summary(r), step=prof[S],
            profile_s=time.perf_counter() - t0)
    ratio = prof[PAR_BENCH_SEQS]["kernel_launches"] / prof[1]["kernel_launches"]
    say("parallel_bench_step", launch_ratio_s4_s1=ratio,
        device_busy_ms={S: p["device_busy_ms"] for S, p in prof.items()})
    if not ratio < PAR_LAUNCH_RATIO:
        raise AssertionError(f"a batched frame at S=4 makes {ratio}x the launches of S=1")

    # 2. run_batch's configuration at S = 1, 4, 8; S=4 against each sequence alone
    t0 = time.perf_counter()
    staged = _staged_batch(_par_views(renders, "small")[1])
    say("parallel_frames", name="small", wait_s=time.perf_counter() - t0)
    for S in PAR_SMALL_SEQS:
        r = _batch_run("small", S, PAR_SMALL_FRAMES, staged)
        _check_batch(f"parallel_small_s{S}", r, S, PAR_SMALL_FRAMES, ATE_GATE_M)
        launches[f"batch_small_s{S}"] = r["launches"]
        extra = {}
        if S == 4:
            solo = [_solo_stereo([f[s] for f in staged], "small", s) for s in range(S)]
            extra["max_gap_to_solo_m"] = gap = _solo_gap(r, solo)
            if gap > PAR_SOLO_TOL_M:
                raise AssertionError(f"run_batch S=4: a sequence is {gap} m from its solo run")
        say("parallel_small", sequences=S, frames=PAR_SMALL_FRAMES, **_summary(r), **extra)

    # 3. mono- and stereo-inertial batches
    for mode in PAR_INERTIAL:
        launches[f"batch_{mode}"] = _inertial_batch(mode, renders)["launches"]

    # 4. card against CPU
    cpu = _cpu_side(_cpu_batch, [f[:PAR_CPU_SEQS].cpu().numpy() for f in staged[:PAR_CPU_FRAMES]])
    rg = _batch_run("small", PAR_CPU_SEQS, PAR_CPU_FRAMES, staged[:PAR_CPU_FRAMES])
    kf_g = [p[0].new_kf_slots for p in rg["pairs"]]
    kf_c, poses_c = cpu.result()
    diffs = [_pose_diff(a, b) for a, b in zip(rg["poses"], poses_c)]
    dt, ang = max(float(d[0].max()) for d in diffs), max(float(d[1].max()) for d in diffs)
    say("parallel_card_vs_cpu", sequences=PAR_CPU_SEQS, frames=PAR_CPU_FRAMES, keyframes=kf_g,
        max_dt_m=dt, max_drot_rad=ang)
    if kf_g != kf_c or dt > POSE_TOL_M or ang > POSE_TOL_RAD:
        raise AssertionError(f"batched card vs CPU: keyframes {kf_g} / {kf_c}, {dt} m, {ang} rad")

    # 5. the sharded BA, virtual shards on the card
    _sharded_window(window)
    _sharded_global()
    _sharded_mapper(sys_scene, sys_pairs, unsharded)
    return launches


def _sharded_window(p: schur.BAProblem):
    """Phase 7's window over meshes of 2 and 4 virtual shards on the card
    against the unsharded card solve (tests/test_parallel.py:27-54's
    tolerances); wall, launches and device busy of one LM iteration at 1,
    2 and 4 shards."""
    ref = _solve(p)
    placed = _conditioned(ref[0], p)[0]
    per_iter = {1: metrics.profile_counts(lambda: (schur.local_ba(p, iters=1), torch.cuda.synchronize()))}
    for n in PAR_SHARDS:
        m = par_mesh.make_mesh(devices=["cuda:0"] * n)
        step = sharded_ba.sharded_two_rounds(m)
        sharded_ba.run_problem(step, p)  # warm-up
        t0 = time.perf_counter()
        q, err, kill = sharded_ba.run_problem(step, p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log = float(se3.se3_logmap(se3.inverse(ref[0].poses) @ q.poses)[p.pose_valid].abs().max())
        # rtol = atol = 1e-3 (tests/test_parallel.py:48-50) over the
        # conditioned landmarks; the others are printed
        d = (q.pts - ref[0].pts).abs()
        pts_ok = bool(torch.all((d <= 1e-3 + 1e-3 * ref[0].pts.abs())[placed]))
        same_kill = bool(torch.equal(kill, ref[2]))
        derr = abs(float(err) - float(ref[1]))
        per_iter[n] = metrics.profile_counts(lambda: (schur.local_ba(p, iters=1, mesh=m), torch.cuda.synchronize()))
        say("parallel_sharded_window", shards=n, wall_ms=wall * 1e3, max_pose_log=log,
            max_dpt_conditioned=float(d[placed].max()), landmarks_conditioned=int(placed.sum()),
            max_dpt_other=float(d[p.pt_valid & ~placed].max()) if bool((p.pt_valid & ~placed).any()) else 0.0,
            pts_within_tol=pts_ok, same_kill=same_kill, kills=int(kill.sum()), err=float(err),
            err_unsharded=float(ref[1]))
        if log > 1e-3 or not pts_ok or not same_kill or derr > 1e-2 * max(float(ref[1]), 1.0):
            raise AssertionError(f"sharded window ({n} shards): pose log {log}, "
                                 f"conditioned points {float(d[placed].max())}, "
                                 f"kill equal {same_kill}, err {float(err)} vs {float(ref[1])}")
    say("parallel_sharded_iteration", **{f"shards_{n}": v for n, v in per_iter.items()})


def _sharded_global():
    """run_global on phase 15's corridor map over 2 virtual shards: the
    composed sharded + slabbed solve (8 slabs), phase 15's gates."""
    m = par_mesh.make_mesh(devices=["cuda:0"] * PAR_SHARDS[0])
    world, c, pert, mapper = _corridor_map(mesh=m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = mapper.run_global(max_landmarks=1 << 17)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_obs = int((c["obs_lm"] >= 0).sum())
    new = world.kf_poses_host[:MAP_KF]
    slabs = mapper.counters.get("global_ba_slabs")
    say("parallel_sharded_global", shards=PAR_SHARDS[0], n_slabs=slabs, wall_s=wall, error=r["error"],
        error_per_obs=r["error"] / n_obs, rel_err_before=_corridor_rel_err(pert, c),
        rel_err_after=_corridor_rel_err(new, c))
    if slabs != MAP_SLABS or not np.isfinite(r["error"]) or not r["error"] < 0.01 * n_obs:
        raise AssertionError(f"sharded global BA: slabs {slabs}, error {r['error']} for {n_obs} obs")
    if not _corridor_rel_err(new, c) < 0.7 * _corridor_rel_err(pert, c):
        raise AssertionError("sharded global BA did not reduce the relative error")


def _sharded_mapper(scene, pairs, unsharded):
    """The facade with LocalMapper(mesh=2 virtual shards) over phase 8's
    frames against phase 8's unsharded card run: the same keyframe slots
    and BA count, poses within 1e-3 m."""
    kf_ref, ba_ref, poses_ref = unsharded
    sys_ = _system(scene, "cuda")
    m = par_mesh.make_mesh(devices=["cuda:0"] * PAR_SHARDS[0])
    old = sys_.mapper
    sys_.mapper = local_mapper.LocalMapper(sys_.world, old.K.cpu().numpy(), float(old.baseline),
                                           old.cfg, mesh=m)
    t0 = time.perf_counter()
    poses = _run_system(sys_, [torch.from_numpy(p).cuda() for p in pairs[:PAR_MAPPER_FRAMES]])
    wall = time.perf_counter() - t0
    dt, ang = _pose_diff(poses, poses_ref)
    say("parallel_sharded_mapper", shards=PAR_SHARDS[0], frames=PAR_MAPPER_FRAMES, wall_s=wall,
        keyframes=sys_.tracker.new_kf_slots, ba_runs=sys_.mapper.ba_count, max_dt_m=float(dt.max()),
        max_drot_rad=float(ang.max()))
    if sys_.tracker.new_kf_slots != kf_ref or sys_.mapper.ba_count != ba_ref or dt.max() > POSE_TOL_M:
        raise AssertionError(f"sharded mapper: keyframes {sys_.tracker.new_kf_slots} / {kf_ref}, "
                             f"BA {sys_.mapper.ba_count} / {ba_ref}, {dt.max()} m")


API_ANGLE_TOL = 1e-4  # rad: tests/test_torch_extract.py:283-306's rules for
API_DESC_SAME, API_DESC_BITS = 0.99, 2  # angles and descriptors
API_POSE_LOG_TOL = 1e-6
API_TRACE_FRAME = 1  # the bench frame tracked under metrics.trace


def _desc_agreement(a: torch.Tensor, b: torch.Tensor) -> tuple[float, int]:
    """Share of identical descriptors and the most bits in which two differ."""
    bits = (a != b).sum(-1)
    return float((bits == 0).float().mean()), int(bits.max())


def _interior_keys(keys: extract.Keys, levels: list) -> list:
    """Per pyramid level: the integer level coords of the valid keys at
    least 15 px inside the level."""
    out = []
    for lvl, img in enumerate(levels):
        h, w = img.shape
        xy = (keys.xy / 1.2**lvl).round().long()
        sel = keys.valid & (keys.octave == lvl) & (xy >= PATCH // 2).all(-1)
        sel &= (xy[:, 0] < w - PATCH // 2) & (xy[:, 1] < h - PATCH // 2)
        out.append(xy[sel])
    return out


def phase_api(scene, pairs, window: schur.BAProblem) -> dict:
    """Phase 19: the JAX package's last public functions on the card, on
    phase 4's frames of the bench scene and phase 7's window."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    kw = dict(n_levels=PARAMS["n_levels"], scale=1.2, total=PARAMS["n_features"])
    img = torch.from_numpy(pairs[0][0]).to(dev)
    torch.cuda.synchronize()
    # 1. single-image extraction: one launch of the kernel, no plain call
    with _plain_calls() as plain_devices:
        patches.LAUNCHES = 0
        keys = extract.extract(img, **kw)
        torch.cuda.synchronize()
        launches, plain_calls = patches.LAUNCHES, len(plain_devices)
    row0 = all(torch.equal(a, b) for a, b in zip(keys, extract.extract_batch(img[None], **kw).select(0)))
    cpu = extract.extract(img.cpu(), **kw)
    exact = {n: bool(torch.equal(getattr(keys, n).cpu(), getattr(cpu, n)))
             for n in ("xy", "octave", "valid", "response")}
    valid = cpu.valid
    ang_err = float((keys.angle.cpu() - cpu.angle)[valid].abs().max())
    same, bits = _desc_agreement(keys.desc.cpu()[valid], cpu.desc[valid])
    say("api_extract", shape=f"{WIDTH}x{HEIGHT}", keys=int(valid.sum()), extract_windows_launches=launches,
        plain_calls_on_card=plain_calls, equals_extract_batch_row0=row0, card_vs_cpu_exact=exact,
        card_vs_cpu_max_angle_err=ang_err, card_vs_cpu_desc_identical=same, card_vs_cpu_desc_max_bits=bits)
    if launches != 1 or plain_calls or not row0 or not all(exact.values()):
        raise AssertionError(f"extract: {launches} launches, {plain_calls} plain calls, row 0 {row0}, {exact}")
    if ang_err > API_ANGLE_TOL or same < API_DESC_SAME or bits > API_DESC_BITS:
        raise AssertionError(f"extract card vs CPU: angles {ang_err} rad, {same} identical, {bits} bits")

    # 2. the image-space ORB against the kernel's windows, keys >= 15 px inside
    levels = [pyramid.gaussian_blur(a) for a in pyramid.build_pyramid(img, kw["n_levels"], kw["scale"])]
    inner = _interior_keys(keys, levels)
    counts = [len(xy) for xy in inner]
    corner = torch.cat(inner).sub(PATCH // 2).to(torch.int32)[None]
    windows = patches.extract_windows_levels([a[None] for a in levels], counts, corner[..., 0].contiguous(),
                                             corner[..., 1].contiguous(), PATCH, PATCH)[0]
    ang_w = orb.orientation_from_patches(windows)
    desc_w = orb.brief_from_patches(windows, ang_w)[1]
    ang_i = torch.cat([orb.orientations(a, xy) for a, xy in zip(levels, inner)])
    desc_i = torch.cat([orb.brief_descriptors(a, xy, ang)[1]
                        for a, xy, ang in zip(levels, inner, torch.split(ang_i, counts))])
    orb_ang_err = float((ang_i - ang_w).abs().max())
    orb_same, orb_bits = _desc_agreement(desc_i, desc_w)
    say("api_orb", keys=sum(counts), per_level=counts, max_angle_err_rad=orb_ang_err,
        desc_identical=orb_same, desc_max_bits=orb_bits)
    if orb_ang_err > API_ANGLE_TOL or orb_same < API_DESC_SAME or orb_bits > API_DESC_BITS:
        raise AssertionError(f"image-space ORB: {orb_ang_err} rad, {orb_same} identical, {orb_bits} bits")

    # 3. the split BA rounds against the fused two rounds on phase 7's window
    t0 = time.perf_counter()
    fused = _solve(window)
    t1 = time.perf_counter()
    p1 = schur.local_ba_round1(window)
    split = schur.local_ba_round2(p1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log = float(se3.se3_logmap(se3.inverse(fused[0].poses) @ split[0].poses)[window.pose_valid].abs().max())
    same_kill = bool(torch.equal(fused[2], split[2]))
    bits_equal = all(torch.equal(a, b) for a, b in zip(
        (fused[0].poses, fused[0].pts, fused[0].obs_valid, fused[1], fused[2]),
        (split[0].poses, split[0].pts, split[0].obs_valid, split[1], split[2])))
    say("api_ba_rounds", poses=int(window.pose_valid.sum()), landmarks=int(window.pt_valid.sum()),
        fused_ms=(t1 - t0) * 1e3, split_ms=(t2 - t1) * 1e3, max_pose_log=log, same_kills=same_kill,
        kills=int(split[2].sum()), swept=int((window.obs_valid & ~p1.obs_valid).sum()),
        bit_identical=bits_equal)
    if not log <= API_POSE_LOG_TOL or not same_kill:
        raise AssertionError(f"split BA rounds: pose log {log}, same kills {same_kill}")

    # 4. metrics.trace around one tracked frame of the sync tracker
    world = map_state.WorldMap(**WORLD, device=dev)
    trk = tracker.StereoTracker(scene.K.astype(np.float32), scene.baseline, WIDTH, HEIGHT, world,
                                tracker.TrackerParams(**PARAMS), device=dev)
    frames = [torch.from_numpy(p).to(dev) for p in pairs[: API_TRACE_FRAME + 1]]
    for fr in frames[:-1]:
        trk.track(fr)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        patches.LAUNCHES = 0
        t0 = time.perf_counter()
        with metrics.trace(tmp) as path:
            trk.track(frames[-1])
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        traced_launches = patches.LAUNCHES
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    ew_events = sum("extract_windows" in n for n in kernel_names)
    say("api_trace", frame=API_TRACE_FRAME, trace_file=os.path.basename(path), trace_bytes=trace_bytes,
        events=len(events), cuda_kernel_events=len(kernel_names), extract_windows_events=ew_events,
        extract_windows_launches=traced_launches, traced_frame_and_export_s=traced_s)
    if traced_launches != 1 or ew_events < 1:
        raise AssertionError(f"trace: {traced_launches} launches, {ew_events} extract_windows events")
    say("api", wall_s=time.perf_counter() - t_phase)
    return {"api_extract": launches, "api_traced_frame": traced_launches}


# phase 20: vslam_torch.bench's sections at reduced depth. The euroc
# pipeline takes the first 24 of phase 6's frames (8 of warm-up), as the
# camera's uint8 feed; mono takes 24 frames, the depth at which phase 12's
# mono driver passes its gate on the same scene
BENCH_FRAMES, BENCH_WARMUP, BENCH_SOLVES = 24, 8, 2
BENCH_MONO_FRAMES, BENCH_MONO_WARMUP = 24, 8


@contextlib.contextmanager
def _bench_renders(scene, pairs):
    """vslam_torch.bench's renders come from the pool (nothing is written
    to its cache), and `scene`'s from `pairs`, already rendered."""
    own = bench._render_frames

    def frames(sc, n, key):
        views = pairs[:n] if sc is scene and len(pairs) >= n else _render(sc, n)
        return [v.astype(np.uint8) for v in views]

    bench._render_frames = frames
    try:
        yield
    finally:
        bench._render_frames = own


def phase_bench(scene, pairs) -> dict:
    """Phase 20: vslam_torch.bench's euroc pipeline, BA solves and mono
    pipeline on the card at reduced depth, through the module's own
    functions: ATEs, fps, one extract_windows launch per tracked frame (the
    mono bootstrap's views included) and no plain call."""
    t_phase = time.perf_counter()
    params = tracker.TrackerParams(**PARAMS)
    with _bench_renders(scene, pairs), _plain_calls() as plain_devices:
        patches.LAUNCHES = 0
        fps, ate, trk, mapper = bench.run_pipeline(scene, params, BENCH_FRAMES, BENCH_WARMUP, "unused")
        launches_euroc = patches.LAUNCHES
        st = trk.metrics.summary()["track"]
        say("bench_euroc", frames=BENCH_FRAMES, warmup=BENCH_WARMUP, fps=fps, ate_m=ate,
            keyframes=trk.world.n_keyframes, landmarks=trk.world.n_landmarks, ba_runs=mapper.ba_count,
            track_p50_ms=st["p50_ms"], track_p90_ms=st["p90_ms"],
            extract_windows_launches=launches_euroc, plain_calls_on_card=len(plain_devices))
        patches.LAUNCHES = 0
        solves = bench.measure_ba_solves(trk, mapper, n=BENCH_SOLVES)
        launches_solves = patches.LAUNCHES
        say("bench_ba_solves", n=BENCH_SOLVES, solves_per_s=solves, extract_windows_launches=launches_solves)
        patches.LAUNCHES = 0
        fps_m, ate_m, mono = bench.run_mono_pipeline(BENCH_MONO_FRAMES, BENCH_MONO_WARMUP)
        launches_mono = patches.LAUNCHES
        plain = len(plain_devices)
    init_frame = int(mono.world.kf_frame_idx[mono.bootstrap_slots[-1]]) if mono.initialized else None
    want_mono = (len(mono.bootstrap_slots) + BENCH_MONO_FRAMES - 1 - init_frame
                 if mono.initialized else None)
    say("bench_mono", frames=BENCH_MONO_FRAMES, warmup=BENCH_MONO_WARMUP, fps=fps_m, ate_m=ate_m,
        initialized=mono.initialized, bootstrap_views=len(mono.bootstrap_slots), init_frame=init_frame,
        keyframes=len(mono.new_kf_slots), landmarks=mono.world.n_landmarks,
        extract_windows_launches=launches_mono, want_launches=want_mono, plain_calls_on_card=plain)
    say("bench", wall_s=time.perf_counter() - t_phase)
    if launches_euroc != BENCH_FRAMES or launches_solves or launches_mono != want_mono or plain:
        raise AssertionError(f"bench: launches {launches_euroc} / {launches_solves} / {launches_mono} "
                             f"(want {BENCH_FRAMES} / 0 / {want_mono}), {plain} plain calls")
    if not (ate <= ATE_GATE_M and ate_m <= ATE_GATE_M):
        raise AssertionError(f"bench: euroc ATE {ate} m, mono ATE {ate_m} m > {ATE_GATE_M} m")
    if not all(np.isfinite(v) and v > 0 for v in (fps, solves, fps_m)):
        raise AssertionError(f"bench: fps {fps}, solves/s {solves}, mono fps {fps_m}")
    return {"bench_euroc": launches_euroc, "bench_mono": launches_mono}


# phase 21: the measuring tools (vslam_torch/tools) with 2 repetitions per
# timing; the roofline's scene is its own (12 frames: phase 4's 16-frame
# scene has another landmark slab), rendered by the pool during phase 5
TOOLS_REPS = 2
TOOLS_STEREO_TOL = 1e-3  # px and relative depth: phase 5's 1e-3 for floats


def _roofline_frame_cpu(pair: np.ndarray, fx: float, baseline: float) -> dict:
    """The roofline's extract_batch(x2) and stereo_match stages on the CPU
    (a pool process): their outputs as numpy arrays."""
    stages = roofline.frame_stages(torch.from_numpy(pair).float(), tracker.TrackerParams(**PARAMS),
                                   torch.tensor(fx), torch.tensor(baseline))
    keys = stages["extract_batch(x2)"][0]()
    return {"keys": {k: v.numpy() for k, v in keys._asdict().items()},
            "stereo": {k: v.numpy() for k, v in stages["stereo_match"][0]().items()}}


def phase_tools(frames_future: list) -> dict:
    """Phase 21: roofline, profile_rtt and profile_solver on the card, each
    row timed and below its bound, the one-launch patch row a single
    extract_windows launch, the warm-up one launch per tracked frame, no
    plain call; the audited frame's extraction and stereo matching against
    the same stages on the CPU."""
    t_phase = time.perf_counter()
    # the tools without a mapper first
    rtt = profile_rtt.run()
    say("tools_rtt", rows=rtt)
    solver = profile_solver.run(reps=TOOLS_REPS)
    say("tools_solver", rows=solver)
    if not all(r["ms_per_call"] > 0 for r in rtt) or not all(r["device_ms"] > 0 for r in solver):
        raise AssertionError("profile_rtt / profile_solver: a row without a time")
    frames = [f.astype(np.uint8) for f in _collect(frames_future)]  # the camera's feed, as the tool reads it
    scene = tool_common.bench_scene(roofline.N_FRAMES)
    cpu = _cpu_side(_roofline_frame_cpu, frames[roofline.FRAME], float(scene.K[0, 0]), float(scene.baseline))
    with _plain_calls() as plain_devices:
        roof = roofline.run(frames=frames, reps=TOOLS_REPS, twins=False)  # no plain call on the card
        plain = len(plain_devices)
    rows = roof["rows"]
    say("tools_roofline", rows=[{k: r[k] for k in ("stage", "device_ms", "device_method", "dispatch_ms",
                                                     "blocked_ms", "launches", "syncs", "gflop", "mbytes",
                                                     "sol_ms", "bound", "share_pct", "extract_windows_launches")}
                                for r in rows],
        warmup_frames=roof["warmup_frames"], warmup_extract_windows_launches=roof["warmup_extract_windows_launches"],
        plain_calls_on_card=plain)
    (patch,) = [r for r in rows if r["stage"].startswith("patches frame")]
    bad = [r["stage"] for r in rows if not (r["device_ms"] > 0 and 0 < r["share_pct"] <= 100)]
    if len(rows) != 8 or bad or patch["extract_windows_launches"] != 1 or plain:
        raise AssertionError(f"roofline: {len(rows)} rows, untimed or over the bound: {bad}, "
                             f"{patch['extract_windows_launches']} patch-row launches, {plain} plain calls")
    if roof["warmup_extract_windows_launches"] != roof["warmup_frames"]:
        raise AssertionError(f"roofline warm-up: {roof['warmup_extract_windows_launches']} launches over "
                             f"{roof['warmup_frames']} frames")
    ref, card = cpu.result(), roof["outputs"]
    exact = {n: bool(np.array_equal(card["keys"][n], ref["keys"][n])) for n in ("xy", "octave", "valid", "response")}
    exact.update({n: bool(np.array_equal(card["stereo"][n], ref["stereo"][n])) for n in ("idx_r", "matched")})
    valid = ref["keys"]["valid"]
    ang_err = float(np.abs(card["keys"]["angle"] - ref["keys"]["angle"])[valid].max())
    same, bits = _desc_agreement(*(torch.from_numpy(k["keys"]["desc"][valid]) for k in (card, ref)))
    m = ref["stereo"]["matched"]
    disp_err = float(np.abs(card["stereo"]["disparity"] - ref["stereo"]["disparity"])[m].max())
    depth_ref = ref["stereo"]["depth"][m]
    depth_err = float((np.abs(card["stereo"]["depth"][m] - depth_ref) / depth_ref).max())
    say("tools_card_vs_cpu", frame=roofline.FRAME, keys=int(valid.sum()), stereo_matched=int(m.sum()), exact=exact,
        max_angle_err=ang_err, desc_identical=same, desc_max_bits=bits, max_disparity_err_px=disp_err,
        max_depth_rel_err=depth_err)
    if not all(exact.values()) or ang_err > API_ANGLE_TOL or same < API_DESC_SAME or bits > API_DESC_BITS:
        raise AssertionError(f"roofline frame card vs CPU: {exact}, angles {ang_err}, {same} identical, {bits} bits")
    if disp_err > TOOLS_STEREO_TOL or depth_err > TOOLS_STEREO_TOL:
        raise AssertionError(f"roofline stereo card vs CPU: disparity {disp_err} px, depth {depth_err} relative")
    say("tools", wall_s=time.perf_counter() - t_phase)
    return {"tools_warmup": roof["warmup_extract_windows_launches"]}


DRYRUN_SHARDS = 4  # the multi-device dry run over virtual shards on cuda:0


def phase_dryrun(smi) -> tuple[int, dict]:
    """Phase 22: the JAX package's multi-device dry run on the port
    (vslam_torch/dryrun.py), on one card: the entry's frame step (one
    extract_windows launch, its pose within ATE_GATE_M of frame 1's truth),
    then dryrun_multichip over DRYRUN_SHARDS virtual shards on cuda:0,
    parts (a) and (b) against the unsharded card solve (pose log 1e-3,
    points 1e-3, the same kills, error 1e-2 relative) and part (c)'s
    window calls against their plain version (torch.equal), one launch per
    shard's batched frame; part (c)'s window table timed. Returns the
    phase's launches and that table."""
    t_phase = time.perf_counter()
    dev = "cuda:0"
    n0 = patches.LAUNCHES
    fn, args = dryrun.entry(dev)
    n1 = patches.LAUNCHES
    _, outputs = fn(*args)
    pose = outputs["blob"][:16].reshape(4, 4).cpu().numpy()
    n_step = patches.LAUNCHES - n1
    truth = synthetic.make_scene(n_frames=2, n_points=600, width=WIDTH, height=HEIGHT, fps=20.0,
                                 seed=SEED).poses_c2w[1]
    err_m = float(np.linalg.norm(pose[:3, 3] - truth[:3, 3]))
    res = dryrun.dryrun_multichip(DRYRUN_SHARDS, devices=[dev] * DRYRUN_SHARDS)
    launches = patches.LAUNCHES - n0
    ref = dryrun.unsharded(dryrun.dryrun_problem(DRYRUN_SHARDS, dev))
    agree = {part: dryrun.compare(res[part], ref[part]) for part in ("a", "b")}
    c = res["c"]
    (table,) = dryrun.window_tables(c["calls"][:1])
    err = max(w["max_abs_err"] for w in c["windows"])
    table.update(max_abs_err=err, launches_per_frame=c["launches"][0])
    say("dryrun", entry_launches=n_step, entry_init_launches=n1 - n0, entry_pose_err_m=err_m,
        mesh=res["mesh"], a_iters=res["a"]["iters"], b_iters=res["b"]["iters"],
        walls_s={k: res[k]["wall_s"] for k in "abc"}, unsharded_walls_s={k: ref[k]["wall_s"] for k in "ab"},
        agreement=agree, c_launches=c["launches"], c_windows=c["windows"], c_table=table, card=smi,
        launches=launches, wall_s=time.perf_counter() - t_phase)
    if n_step != 1 or not np.isfinite(pose).all() or err_m > ATE_GATE_M:
        raise AssertionError(f"dry run entry: {n_step} launches, pose {pose[:3, 3]} ({err_m} m from the truth)")
    if not all(a["within"] for a in agree.values()):
        raise AssertionError(f"dry run parts (a), (b) against the unsharded solve: {agree}")
    if c["launches"] != [1] * DRYRUN_SHARDS or not all(w["equal"] for w in c["windows"]):
        raise AssertionError(f"dry run part (c): launches {c['launches']}, windows {c['windows']}")
    return launches, table


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
    t_lm = phase_kernels_lm(smi)
    launches_trk, pairs, ate_trk = phase_main_path(scene)
    tools_frames = _render_async(tool_common.bench_scene(roofline.N_FRAMES), roofline.N_FRAMES)
    phase_card_vs_cpu(scene, pairs)
    # phase 21 runs here, before any mapper: once the async mapper has run
    # in a process, torch.profiler can lose the kernels of a short call
    launches_tools = phase_tools(tools_frames)
    launches_dryrun, t_dryrun = phase_dryrun(smi)
    sys_scene = synthetic.make_scene(n_frames=SYS_SCENE_FRAMES, n_points=900, width=WIDTH,
                                     height=HEIGHT, fps=20.0, seed=SEED)
    launches, sys_pairs, window, sys_, sync_fps = phase_system(sys_scene, ate_trk)
    bins = datasets.bin_imu_per_frame(sys_scene.imu, sys_scene.times)
    # the CPU sides of phases 8, 10 and 11, on the pool while the card runs
    # phases 7 and 15 (whose walls moved by under 6% with them, PERF.md)
    cpu_sync, cpu_async, cpu_imu = (cpu_system(sys_scene, sys_pairs),
                                    cpu_system(sys_scene, sys_pairs, async_ba=True),
                                    cpu_system(sys_scene, sys_pairs, IMU_CPU_FRAMES, bins, imu=True))
    phase_ba(window, sys_)
    phase_global_ba(sys_, sys_scene)
    del sys_
    unsharded = phase_system_card_vs_cpu(sys_scene, sys_pairs, cpu_sync)
    launches_async = phase_async(sys_scene, sys_pairs, sync_fps)
    phase_system_card_vs_cpu(sys_scene, sys_pairs, cpu_async, "async_card_vs_cpu", async_ba=True)
    launches_imu = phase_imu(sys_scene, sys_pairs, bins, cpu_imu)
    launches_kitti, launches_driver_mono = phase_driver()
    launches_mono = phase_mono()
    launches_recovery = phase_recovery()
    par_renders: dict = {}
    launches_loop = phase_loop(loop_scene, while_running=lambda: start_parallel_renders(par_renders))
    phase_loop_card_vs_cpu()
    phase_pose_graph()
    launches_ds_kitti, launches_ds_euroc = phase_dataset()
    t_batch = _batch_tables(torch.device("cuda"), smi)
    launches_par = phase_parallel(window, sys_scene, sys_pairs, unsharded, par_renders)
    launches_api = phase_api(scene, pairs, window)
    launches_bench = phase_bench(sys_scene, sys_pairs)
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
                              "dataset_euroc": launches_ds_euroc, **launches_par, **launches_api,
                              **launches_bench, **launches_tools, "dryrun": launches_dryrun},
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
                                                         ("loop", t_loop), ("kitti00", t_kitti00),
                                                         ("dryrun", t_dryrun), *t_batch.items())},
    }, {
        "name": "motion_only_lm",
        "route": "cuda",
        "source": "vslam_torch/kernels/csrc/motion_only_lm.cu",
        "replaces": "vslam_tpu/ops/lm.py lm_solve + motion_only_ba (lax.while_loop; no Pallas kernel)",
        "bound_by": "bound_ms: the rows' f32 operations on one SM a problem; above it, the serial iteration chain",
        **t_lm,
    }]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
