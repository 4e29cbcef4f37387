"""A/B of the keyframe-policy knobs on the bench scene: the port of the
JAX repo's tools/ab_kf_policy.py.

    python -m vslam_torch.tools.ab_kf_policy

Two knobs of ``TrackerParams``: ``kf_critical_stereo`` (the low-stereo
bypass floor, default 4/5 of ``kf_min_stereo`` = 64) and
``kf_max_interval`` (the gap ceiling, default 30). Each variant runs the
euroc section's pipeline once (``vslam_torch.bench.run_pipeline``: 80
frames of the bench scene, 12 of warm-up, the staged async local BA) and
prints fps, ATE, keyframes, BA runs and the tracked frame's p50/p90, then
one JSON line.
"""

from __future__ import annotations

import time

from vslam_torch import bench
from vslam_torch.models import tracker
from vslam_torch.tools import _common

N_FRAMES, WARMUP = 80, 12
VARIANTS = [
    ("crit=64 gap=30 (defaults)", 64, 30),
    ("crit=48 gap=30", 48, 30),
    ("crit=40 gap=30", 40, 30),
    ("crit=32 gap=30", 32, 30),
    ("crit=48 gap=60", 48, 60),
    ("crit=48 gap=off", 48, 1 << 30),
    ("crit=64 gap=off", 64, 1 << 30),
]


def run_variant(scene, crit: int, max_interval: int) -> dict:
    params = tracker.TrackerParams(**_common.PARAMS, kf_critical_stereo=crit, kf_max_interval=max_interval)
    t0 = time.perf_counter()
    fps, ate, trk, mapper = bench.run_pipeline(
        scene, params, N_FRAMES, WARMUP, _common.cache_key(scene))
    st = trk.metrics.summary().get("track", {})
    return {"fps": fps, "ate_m": ate, "keyframes": trk.world.n_keyframes, "ba_runs": mapper.ba_count,
            "track_p50_ms": st.get("p50_ms"), "track_p90_ms": st.get("p90_ms"),
            "wall_s": time.perf_counter() - t0}


def run() -> list:
    _common.require_card("ab_kf_policy")
    scene = _common.bench_scene(N_FRAMES)
    rows = []
    for name, crit, gap in VARIANTS:
        r = {"variant": name, "kf_critical_stereo": crit, "kf_max_interval": gap,
             **run_variant(scene, crit, gap)}
        rows.append(r)
        print(f"{name:28s} fps={r['fps']:6.2f} ate={r['ate_m']:.4f} kfs={r['keyframes']:3d} "
              f"ba={r['ba_runs']:3d} p50={r['track_p50_ms']} p90={r['track_p90_ms']}", flush=True)
    return rows


def main() -> dict:
    return _common.emit("ab_kf_policy", run())


if __name__ == "__main__":
    main()
