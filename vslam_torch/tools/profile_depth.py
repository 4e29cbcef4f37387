"""Tracked frames/s at pipeline depth 1 against 2, no BA: the port of the
JAX repo's tools/profile_depth.py.

    python -m vslam_torch.tools.profile_depth

The bench scene (36 frames) through a fresh ``StereoTracker`` (no mapper)
at ``TrackerParams.pipeline_depth`` 1 and 2: 10 frames of warm-up, then
the wall of each of the other 26 ``track`` calls. Prints p50, p90 and the
mean per depth and one JSON line.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vslam_torch.tools import _common

N_FRAMES, WARMUP = 36, 10


def run_depth(scene, staged: list, depth: int) -> dict:
    trk, mapper = _common.make_tracker(scene, staged[0].device, pipeline_depth=depth)
    mapper.close()
    for fr in staged[:WARMUP]:
        trk.track(fr)
    ts = []
    for fr in staged[WARMUP:]:
        t0 = time.perf_counter()
        trk.track(fr)
        ts.append((time.perf_counter() - t0) * 1e3)
    trk.flush()
    ts = np.array(ts)
    r = {"depth": depth, "p50_ms": float(np.percentile(ts, 50)), "p90_ms": float(np.percentile(ts, 90)),
         "mean_ms": float(ts.mean()), "fps": float(1e3 / ts.mean()), "keyframes": len(trk.new_kf_slots),
         "frames_timed": len(ts)}
    print(f"depth={depth}: p50={r['p50_ms']:6.1f} ms  p90={r['p90_ms']:6.1f} ms mean={r['mean_ms']:6.1f} ms "
          f"-> {r['fps']:5.1f} fps  (KFs={r['keyframes']})", flush=True)
    return r


def run() -> list:
    _common.require_card("profile_depth")
    scene = _common.bench_scene(N_FRAMES)
    staged = [torch.from_numpy(f).cuda() for f in _common.scene_frames(scene)]
    return [run_depth(scene, staged, d) for d in (1, 2)]


def main() -> dict:
    return _common.emit("profile_depth", run())


if __name__ == "__main__":
    main()
