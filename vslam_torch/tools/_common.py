"""What the measuring tools share: the card guard, the bench scene and its
render cache, the tracker warm-up, one stage's measurement and the JSON
line."""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from vslam_torch import bench
from vslam_torch.kernels import timing
from vslam_torch.models import local_mapper, map_state, tracker
from vslam_torch.ops import patches
from vslam_torch.utils import metrics, synthetic

# the bench configuration (bench.py:341-345; tools/roofline.py:105-112)
SCENE = dict(n_points=900, width=752, height=480, fps=20.0, seed=3)
PARAMS = dict(n_features=1024, n_levels=8, active_size=4096)
WORLD = dict(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)
WARMUP_FRAMES = 8


def require_card(tool: str):
    """Raise unless a CUDA card is visible: a measurement never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"vslam_torch.tools.{tool} measures the port on a CUDA card, and none is available")


def bench_scene(n_frames: int):
    """The bench's EuRoC-geometry scene with `n_frames` frames (its
    landmark slab, and so every frame, depends on the count)."""
    return synthetic.make_scene(n_frames=n_frames, **SCENE)


def cache_key(scene) -> str:
    """vslam_torch.bench's render-cache key of a :func:`bench_scene` (the
    bench's own for its 80-frame euroc scene)."""
    fps = "" if SCENE["fps"] == 20.0 else f"_fps{SCENE['fps']:g}"
    return (f"euroc_{scene.width}x{scene.height}_s{SCENE['seed']}_p{SCENE['n_points']}"
            f"_f{len(scene.poses_c2w)}{fps}")


def scene_frames(scene) -> list:
    """Every frame of a :func:`bench_scene` as a (2, H, W) uint8 L+R array,
    from vslam_torch.bench's render cache (rendered into it when absent)."""
    return bench._render_frames(scene, len(scene.poses_c2w), cache_key(scene))


def make_tracker(scene, device="cuda", **params):
    """A stereo tracker and a sync local mapper at the bench's parameters
    and map capacities (keyword arguments override TrackerParams)."""
    p = tracker.TrackerParams(**{**PARAMS, **params})
    K = scene.K.astype(np.float32)
    world = map_state.WorldMap(**{**WORLD, "keys_per_kf": p.n_features}, device=device)
    trk = tracker.StereoTracker(K, scene.baseline, scene.width, scene.height, world, p, device=device)
    mapper = local_mapper.LocalMapper(
        world, K, scene.baseline,
        local_mapper.LocalMapperConfig(n_levels=p.n_levels, scale=p.scale),
    )
    return trk, mapper


def warm_up(trk, mapper, frames, n: int = WARMUP_FRAMES) -> int:
    """The shared warm-up (tools/roofline.py:120-140): the first `n` frames
    tracked, each keyframe past the first mapped synchronously
    (LocalMapper.run, reanchor, add_active), then the pipeline drained.
    Returns the window kernel's launches during it."""
    n0 = patches.LAUNCHES
    for fr in frames[:n]:
        n_kf = len(trk.new_kf_slots)
        trk.track(fr)
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])
    trk.flush()
    if trk.device.type == "cuda":
        torch.cuda.synchronize(trk.device)
    return patches.LAUNCHES - n0


@functools.cache
def _base_syncs() -> int:
    """The stream syncs the profiler records around a call that does
    nothing but the closing synchronize (the profiler's own included)."""
    return metrics.profile_counts(torch.cuda.synchronize)["stream_syncs"]


# Kernel launches queued in one primed round at most. The host can queue
# only about a thousand launches ahead of the card: past that it waits on
# the card, which is still in its spin, and the events then time the host
# (1,836 launches of extract_batch timed 22.97 ms primed against 5.10 ms of
# kernels on an NVIDIA H100 80GB HBM3 at 700 W).
PRIMED_LAUNCHES = 512


def measure(fn, reps: int = 10) -> dict:
    """One stage on the card: kernel launches, host syncs (beyond those of
    a call that does nothing: :func:`_base_syncs`), memcpy calls and
    device busy of one call (``metrics.profile_counts``); ``dispatch_ms``,
    the host time per call without a sync (``timing.host_ms_per_call``);
    ``blocked_ms``, the median wall of a call that ends in a synchronize
    (``timing.wall_ms``); and ``device_ms`` with its ``device_method``: the
    primed-stream CUDA events of ``timing.primed_device_ms`` for a call
    with no host sync and at most PRIMED_LAUNCHES launches (as many calls
    per round as fit), else the profiler's device busy (a call that waits
    on the host cannot be primed)."""
    fn()
    torch.cuda.synchronize()
    prof = metrics.profile_counts(lambda: (fn(), torch.cuda.synchronize()))
    row = {
        "launches": prof["kernel_launches"],
        "syncs": prof["stream_syncs"] - _base_syncs(),
        "memcpy": prof["memcpy_calls"],
        "device_busy_ms": prof["device_busy_ms"],
        "dispatch_ms": timing.host_ms_per_call(fn, reps=reps, warmup=1),
        "blocked_ms": timing.wall_ms(fn, reps=reps, warmup=1),
    }
    if row["syncs"] == 0 and 0 < row["launches"] <= PRIMED_LAUNCHES:
        primed_reps = max(1, min(reps, PRIMED_LAUNCHES // row["launches"]))
        row["device_ms"] = timing.primed_device_ms(fn, reps=primed_reps, warmup=1)
        row["device_method"] = "primed_events"
    else:
        # a process that has run the async mapper can lose the kernel
        # records of a short profiled call: refuse the zero
        if (row["launches"] or row["memcpy"]) and not row["device_busy_ms"] > 0:
            raise RuntimeError(f"the profiler recorded {row['launches']} launches, {row['memcpy']} copies "
                               "and no device time")
        row["device_ms"] = row["device_busy_ms"]
        row["device_method"] = "profiler_busy"
    return row


def emit(tool: str, rows: list, **extra) -> dict:
    """Print the tool's JSON line (its rows and the card's name and power
    limit) and return it."""
    line = {"tool": tool, "device": bench.card(), "rows": rows, **extra}
    print(json.dumps(line), flush=True)
    return line
