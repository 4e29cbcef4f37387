"""Per-frame wall of the bench loop with keyframe and BA markers: the port
of the JAX repo's tools/profile_bench.py.

    python -m vslam_torch.tools.profile_bench

Runs ``vslam_torch.bench.run_pipeline`` (the euroc section's loop: 80
frames of the bench scene, 12 of warm-up, the staged async local BA) once
and reads its per-frame log: per timed frame the wall, the BA consume
before tracking, the tracking and the BA stages after it (advance, and at
a keyframe the forced consume and the next dispatch). Prints the steady
mean, the non-keyframe, keyframe and frame-after-keyframe means, the
per-frame table and one JSON line.
"""

from __future__ import annotations

import numpy as np

from vslam_torch import bench
from vslam_torch.models import tracker
from vslam_torch.tools import _common

N_FRAMES, WARMUP = 80, 12


def summary(log: list) -> dict:
    """The JAX tool's aggregates of a frame log (ms): the mean frame, and
    the means of non-keyframe, keyframe and frame-after-keyframe frames."""
    ms = lambda rows, i: float(np.mean([r[i] for r in rows]) * 1e3) if rows else None  # noqa: E731
    kf = [r for r in log if r[5]]
    nkf = [r for r in log if not r[5]]
    after = [log[i] for i in range(1, len(log)) if log[i - 1][5] and not log[i][5]]
    mean = ms(log, 1)
    return {"mean_frame_ms": mean, "fps": 1e3 / mean,
            "non_kf": {"n": len(nkf), "mean_ms": ms(nkf, 1), "track_ms": ms(nkf, 3)},
            "kf": {"n": len(kf), "mean_ms": ms(kf, 1), "consume_ms": ms(kf, 2), "track_ms": ms(kf, 3),
                   "ba_ms": ms(kf, 4)},
            "after_kf": {"n": len(after), "mean_ms": ms(after, 1), "consume_ms": ms(after, 2),
                         "track_ms": ms(after, 3), "ba_ms": ms(after, 4)}}


def run() -> dict:
    _common.require_card("profile_bench")
    scene = _common.bench_scene(N_FRAMES)
    log: list = []
    fps, ate, trk, mapper = bench.run_pipeline(
        scene, tracker.TrackerParams(**_common.PARAMS), N_FRAMES, WARMUP,
        _common.cache_key(scene), frame_log=log)
    s = summary(log)
    print(f"mean frame (after warmup): {s['mean_frame_ms']:7.2f} ms  -> {s['fps']:5.1f} fps")
    print(f"non-KF frames: n={s['non_kf']['n']} mean {s['non_kf']['mean_ms']:7.2f} ms "
          f"(track {s['non_kf']['track_ms']:.2f})")
    if s["kf"]["n"]:
        k = s["kf"]
        print(f"KF frames    : n={k['n']} mean {k['mean_ms']:7.2f} ms  (consume {k['consume_ms']:.2f}, "
              f"track+insert {k['track_ms']:.2f}, ba {k['ba_ms']:.2f})")
    if s["after_kf"]["n"]:
        a = s["after_kf"]
        print(f"frame-after-KF: n={a['n']} mean {a['mean_ms']:7.2f} ms  (consume {a['consume_ms']:.2f}, "
              f"track {a['track_ms']:.2f}, ba {a['ba_ms']:.2f})")
    print("\nper-frame (f, total ms, consume, track, ba, kf):")
    for r in log:
        print(f"  {r[0]:3d} {r[1]*1e3:8.2f} {r[2]*1e3:7.2f} {r[3]*1e3:7.2f} {r[4]*1e3:7.2f} {'KF' if r[5] else ''}")
    rows = [{"frame": r[0], "wall_ms": r[1] * 1e3, "consume_ms": r[2] * 1e3, "track_ms": r[3] * 1e3,
             "ba_ms": r[4] * 1e3, "kf": bool(r[5])} for r in log]
    return {"rows": rows, "summary": s, "bench_fps": fps, "ate_m": ate, "keyframes": trk.world.n_keyframes,
            "ba_runs": mapper.ba_count}


def main() -> dict:
    out = run()
    rows = out.pop("rows")
    return _common.emit("profile_bench", rows, **out)


if __name__ == "__main__":
    main()
