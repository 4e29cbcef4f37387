"""Time the stereo tracker alone on the card, as chip_smoke.py's phase 4
runs it: the bench's scene (752x480, seed 3, 900 points, 20 fps), its
tracker parameters (1024 features, 8 levels, 4096 active landmarks) and
map capacities, 16 frames staged on the card, no mapper.

Three runs of a fresh tracker over the same frames: the first warms up
(kernel build, allocator), the second is timed (fps, frame p50/p90), the
third is traced with torch.profiler (kernel launches, stream syncs and
device busy per tracked frame; frame 0 only initializes). Prints one JSON
line with the card's name and power limit.

To compare two trees on one card, copy this file into each tree's
``vslam_torch/`` and run ``python -m vslam_torch.bench_tracker --frames
F.npz`` from each root in one call, alternating (A, B, B, A); the first
run renders the frames into F.npz and the others load them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from vslam_torch.models import map_state, tracker
from vslam_torch.utils import metrics, synthetic, trajectory

WIDTH, HEIGHT, SEED, N_FRAMES = 752, 480, 3, 16
PARAMS = dict(n_features=1024, n_levels=8, active_size=4096)
WORLD = dict(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)


def _frames(scene, path: str | None) -> np.ndarray:
    """(N, 2, H, W) L+R frames, from `path` when it holds them."""
    if path and os.path.exists(path):
        return np.load(path)["pairs"]
    pairs = np.stack([np.stack([scene.render(f), scene.render(f, right=True)]) for f in range(N_FRAMES)])
    if path:
        np.savez(path, pairs=pairs)
    return pairs


def _track(scene, frames) -> tracker.StereoTracker:
    world = map_state.WorldMap(**WORLD, device="cuda")
    trk = tracker.StereoTracker(scene.K.astype(np.float32), scene.baseline, WIDTH, HEIGHT, world,
                                tracker.TrackerParams(**PARAMS), device="cuda")
    for fr in frames:
        trk.track(fr)
    torch.cuda.synchronize()
    return trk


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", help="npz of the rendered frames (written if absent)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_tracker needs a CUDA card")
    scene = synthetic.make_scene(n_frames=N_FRAMES, n_points=900, width=WIDTH, height=HEIGHT,
                                 fps=20.0, seed=SEED)
    frames = [torch.from_numpy(p).cuda() for p in _frames(scene, args.frames)]
    torch.cuda.synchronize()
    _track(scene, frames)
    t0 = time.perf_counter()
    trk = _track(scene, frames)
    wall = time.perf_counter() - t0
    stages = trk.metrics.summary()["track"]
    prof = metrics.profile_counts(lambda: _track(scene, frames))
    tracked = N_FRAMES - 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = dict(card=smi, frames=N_FRAMES, fps=N_FRAMES / wall, track_p50_ms=stages["p50_ms"],
               track_p90_ms=stages["p90_ms"], launches_per_frame=prof["kernel_launches"] / tracked,
               syncs_per_frame=prof["stream_syncs"] / tracked,
               device_busy_ms_per_frame=prof["device_busy_ms"] / tracked,
               ate_m=trajectory.ate_rmse(trk.trajectory(), scene.poses_c2w[:N_FRAMES], align=False))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
