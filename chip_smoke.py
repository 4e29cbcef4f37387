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
   on frame 0's full 8-level table, as the main path calls it. Then the
   frame's one launch is timed: device time on a primed stream and host
   time per call (vslam_torch/kernels/timing.py), against the plain
   version, one advanced-indexing call per level (the library yardstick)
   and the bound from the bytes the frame must move;
4. main path: StereoTracker (no mapper) over 40 frames of the synthetic
   EuRoC-geometry scene at the bench configuration (752x480, seed 3,
   1024 features, 8 levels, 4096 active landmarks) on the card; kernel
   launch counts (one per frame), fps, keyframes, landmarks, ATE against
   exact ground truth (must be <= 0.05 m);
5. card vs CPU: the first 8 frames again on the card and on the CPU (the
   plain versions); keyframe slots must be equal, per-frame poses within
   1e-3 m / 1e-3 rad.

The second-to-last line is the kernel report {"kernels": [...]}, the last
line {"ok": true, "device": {...}}. Nothing is caught: any failure raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from vslam_torch import kernels
from vslam_torch.kernels import timing
from vslam_torch.models import map_state, tracker
from vslam_torch.ops import extract, patches, pyramid
from vslam_torch.utils import synthetic, trajectory

# the bench configuration (bench.py:341-345) and its scene
WIDTH, HEIGHT, SEED, N_FRAMES = 752, 480, 3, 40
PARAMS = dict(n_features=1024, n_levels=8, active_size=4096)
WORLD = dict(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)
PATCH = 31
ATE_GATE_M = 0.05
CPU_FRAMES = 8
POSE_TOL_M, POSE_TOL_RAD = 1e-3, 1e-3


def say(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields), flush=True)


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


def _level_inputs(scene, dev):
    """The main path's inputs to extract_windows for frame 0: every level's
    blurred L+R image, the level quota of keys, corners from a seeded
    generator including the extreme corners."""
    imgs = torch.from_numpy(np.stack([scene.render(0), scene.render(0, right=True)])).to(dev)
    shapes = pyramid.level_shapes(HEIGHT, WIDTH, PARAMS["n_levels"], 1.2)
    quotas = extract.level_quotas(PARAMS["n_features"], PARAMS["n_levels"], 1.2)
    rng = np.random.default_rng(SEED)
    cur, cases = imgs, []
    for lvl, ((h, w), q) in enumerate(zip(shapes, quotas)):
        if lvl:
            cur = pyramid.resize_bilinear_batch(cur, h, w)
        if q <= 0:
            continue
        x0 = rng.integers(0, w - PATCH + 1, size=(2, q)).astype(np.int32)
        y0 = rng.integers(0, h - PATCH + 1, size=(2, q)).astype(np.int32)
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

    max_err = 0.0

    def agree(name, out, ref):
        nonlocal max_err
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"extract_windows != plain version at {name}")
        max_err = max(max_err, float((out - ref).abs().max()))

    for name, img, x0, y0, P, Pw in cases + [odd]:
        agree(name, patches.extract_windows(img, x0, y0, P, Pw),
              patches.extract_windows_ref(img, x0, y0, P, Pw))
        xb, yb = _out_of_range(x0, y0)
        agree(name + " clamped", patches.extract_windows(img, xb, yb, P, Pw),
              patches.extract_windows_ref(img, xb, yb, P, Pw))
        say("kernel", name="extract_windows", shape=name, equal=True, clamped_equal=True)

    # frame 0's full table, as extract_batch calls it: one launch
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
    say("kernel", name="extract_windows", shape="frame 0, 8 levels, L+R, one launch",
        card=smi, frame_bytes=frame_bytes, covered_pixels=covered, **t)
    return {"max_abs_err": max_err, **t}


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


def phase_main_path(scene) -> tuple[int, list]:
    t0 = time.perf_counter()
    pairs = [np.stack([scene.render(f), scene.render(f, right=True)]) for f in range(N_FRAMES)]
    render_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    # stage every frame pair on the card ahead of the loop, as bench.py does
    frames = [torch.from_numpy(p).to(dev) for p in pairs]
    torch.cuda.synchronize()

    # count every call of the plain versions during the run: on the card the
    # main path must never reach them
    plain = {n: getattr(patches, n) for n in ("extract_windows_ref", "extract_windows_levels_ref")}
    plain_devices = []

    def counted(fn):
        def run(*args):
            plain_devices.append(args[2].device.type)  # the corners
            return fn(*args)
        return run

    torch.cuda.reset_peak_memory_stats()
    for n, fn in plain.items():
        setattr(patches, n, counted(fn))
    patches.LAUNCHES = 0
    t0 = time.perf_counter()
    trk, poses = _run_tracker(scene, frames, dev)
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    launches, plain_calls = patches.LAUNCHES, len(plain_devices)
    for n, fn in plain.items():
        setattr(patches, n, fn)

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
    return launches, pairs


def phase_card_vs_cpu(scene, pairs):
    sub = pairs[:CPU_FRAMES]
    t_gpu, p_gpu = _run_tracker(scene, [torch.from_numpy(p).cuda() for p in sub], "cuda")
    t_cpu, p_cpu = _run_tracker(scene, [torch.from_numpy(p) for p in sub], "cpu")
    if t_gpu.new_kf_slots != t_cpu.new_kf_slots:
        raise AssertionError(f"keyframes differ: card {t_gpu.new_kf_slots} cpu {t_cpu.new_kf_slots}")
    n = t_gpu.world.n_keyframes
    if not np.array_equal(t_gpu.world.kf_frame_idx[:n], t_cpu.world.kf_frame_idx[:n]):
        raise AssertionError("keyframes fired at different frames on card and CPU")
    p_gpu, p_cpu = p_gpu.astype(np.float64), p_cpu.astype(np.float64)
    dt = np.linalg.norm(p_gpu[:, :3, 3] - p_cpu[:, :3, 3], axis=1)
    # relative rotation angle from its skew part and trace (arccos of the
    # trace alone cannot resolve angles below ~3e-4 rad in float32)
    R = np.einsum("fji,fjk->fik", p_gpu[:, :3, :3], p_cpu[:, :3, :3])
    skew = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    ang = np.arctan2(0.5 * np.linalg.norm(skew, axis=1), 0.5 * (np.trace(R, axis1=1, axis2=2) - 1.0))
    say("card_vs_cpu", frames=CPU_FRAMES, keyframes=t_gpu.new_kf_slots,
        max_dt_m=float(dt.max()), max_drot_rad=float(ang.max()))
    if dt.max() > POSE_TOL_M or ang.max() > POSE_TOL_RAD:
        raise AssertionError(f"card and CPU poses differ: {dt.max()} m, {ang.max()} rad")


def main() -> int:
    smi = phase_device()
    phase_build()
    scene = synthetic.make_scene(n_frames=N_FRAMES, n_points=900, width=WIDTH, height=HEIGHT,
                                 fps=20.0, seed=SEED)
    t = phase_kernels(scene, torch.device("cuda"), smi)
    launches, pairs = phase_main_path(scene)
    phase_card_vs_cpu(scene, pairs)
    report = {"kernels": [{
        "name": "extract_windows",
        "route": "cuda",
        "source": "vslam_torch/kernels/csrc/extract_windows.cu",
        "replaces": "vslam_tpu/ops/patches.py:141",
        "launches": launches,
        "launches_per_frame": t["launches_per_frame"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["device_ms"],
        "device_ms": t["device_ms"],
        "host_ms_per_call": t["host_ms_per_call"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
    }]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
