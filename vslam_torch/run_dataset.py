"""Dataset driver (the port of examples/run_dataset.py; the reference's
VIOSlam / VIOSlamMono drivers, src/VIOSlam.cpp:141-329,
src/VIOSlamMono.cpp:112-275).

    python -m vslam_torch.run_dataset <config.yaml> [--data-root DIR]
        [--limit N] [--out traj.txt] [--async-ba] [--no-prefetch]
        [--checkpoint ck.npz] [--checkpoint-every N] [--resume ck.npz]
        [--viz map.html] [--viz-every N] [--ply map.ply] [--global-ba]
        [--loop-closure] [--debug-dir DIR] [--debug-every N] [--device cpu]

Loads the YAML config, enumerates the dataset (KITTI image_0/image_1 or
EuRoC mav0), bins the IMU samples per frame, runs the frame loop on
``--device`` (the GPU unless ``--device cpu``) and writes the trajectory
in the reference's KITTI 3x4 format, plus TUM format beside it. SIGINT
stops the loop cleanly and still writes the trajectory.

Frames arrive through the native readahead (vslam_torch/native: PNG
decode on worker threads, and for an unrectified rig the rectification
too, on the host in uint8) unless ``--no-prefetch``, or unless the native
library cannot be built here; then PIL decodes and the facade rectifies on
the device. A run can be checkpointed at keyframe boundaries and resumed
(``--checkpoint`` / ``--resume``); a checkpoint of the JAX package resumes
here too. ``--shards N`` with N > 1 raises NotImplementedError (the
mesh-sharded BA is not ported).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np


def _host_rectify_maps(conf, mono: bool):
    """(lx, ly, rx, ry) float32 source-coordinate maps for the native
    prefetcher's rectify stage (the reference's initUndistortRectifyMap,
    src/VIOSlam.cpp:282-287), or None when the rig has no raw intrinsics."""
    from vslam_torch.geometry import camera as cam

    rig = cam.StereoCamera.from_config(conf)
    if rig.left.K is None:
        return None

    def split(c):
        m = cam.init_undistort_rectify_map(c.K, c.D, c.R, c.P, rig.width, rig.height)
        return (
            np.ascontiguousarray(m[..., 0], np.float32),
            np.ascontiguousarray(m[..., 1], np.float32),
        )

    lx, ly = split(rig.left)
    rx = ry = None
    if not mono:
        rx, ry = split(rig.right)
    return lx, ly, rx, ry


def main(argv=None) -> dict:
    """Run the driver; prints its lines and returns the run's numbers."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--async-ba", action="store_true")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="decode with PIL (no native IO)")
    ap.add_argument("--checkpoint", default=None,
                    help="write the full SLAM state here at exit")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="also checkpoint every N new keyframes")
    ap.add_argument("--resume", default=None,
                    help="restore a checkpoint and continue from its frame")
    ap.add_argument("--viz", default=None, help="HTML map viewer output path")
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="with --viz: also rewrite the viewer every N new keyframes")
    ap.add_argument("--ply", default=None, help="PLY point-cloud output path")
    ap.add_argument("--global-ba", action="store_true",
                    help="one bundle adjustment over the whole map before saving")
    ap.add_argument("--shards", default=None,
                    help="shard the local BA over N devices (not ported: N > 1 raises)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="detect and close trajectory loops at keyframes")
    ap.add_argument("--debug-dir", default=None,
                    help="write tracked-keypoint overlay PNGs here")
    ap.add_argument("--debug-every", type=int, default=10, metavar="N",
                    help="overlay every N-th frame (with --debug-dir)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    stop = []  # set by SIGINT: finish the frame, then wrap up
    previous = signal.signal(signal.SIGINT, lambda _sig, _frm: stop.append(True))
    try:
        return _run(args, stop)
    finally:
        signal.signal(signal.SIGINT, previous)


def _run(args, stop: list) -> dict:
    from vslam_torch import native
    from vslam_torch.models.system import VSlamSystem
    from vslam_torch.utils import checkpoint as ckpt_io
    from vslam_torch.utils.config import ConfigFile, SlamMode
    from vslam_torch.utils.datasets import open_dataset

    conf = ConfigFile(args.config)
    mono = conf.slam_mode in (SlamMode.MONOCULAR, SlamMode.MONO_IMU)

    # native IO: decode threads; for an unrectified rig the prefetcher also
    # rectifies on the host, so the facade skips its device remap
    use_native = not args.no_prefetch
    if use_native and not native.available():
        print(f"native IO unavailable ({native.build_error()}); PIL fallback")
        use_native = False
    maps = None
    if use_native and not conf.rectified:
        maps = _host_rectify_maps(conf, mono)

    shards = args.shards
    if shards is not None and shards != "auto":
        shards = int(shards)
    system = VSlamSystem(
        conf, async_ba=args.async_ba, io_rectified=maps is not None,
        shards=shards, loop_closure=args.loop_closure, device=args.device,
    )
    ds = open_dataset(conf, args.data_root)
    result = {"resumed_from": None, "checkpoints": 0}
    start = 0
    if args.resume:
        t0 = time.perf_counter()
        meta = ckpt_io.load_checkpoint(args.resume, system.world, system.tracker)
        result["checkpoint_load_s"] = time.perf_counter() - t0
        start = int(meta["frame_idx"])
        result["resumed_from"] = start
        print(f"resumed {args.resume}: frame {start}, "
              f"{system.world.n_keyframes} kfs, {system.world.n_landmarks} lms")
    io = "native" if use_native else "pil"
    print(f"mode={system.mode.name} frames={len(ds)} "
          f"rig={system.rig.width}x{system.rig.height} io={io}")

    debug_hook = None
    if args.debug_dir:
        from vslam_torch.utils import debug_view

        debug_hook = debug_view.make_tracker_hook(args.debug_dir, every=max(args.debug_every, 1))
        system.tracker.debug_hook = debug_hook

    live_viz = None
    if args.viz and args.viz_every > 0:
        from vslam_torch.utils import viz as viz_mod

        live_viz = viz_mod.LiveMapWriter(args.viz, system.world, every_n_kf=args.viz_every)

    def checkpoint():
        t0 = time.perf_counter()
        ckpt_io.save_checkpoint(args.checkpoint, system.world, system.tracker)
        result["checkpoint_write_s"] = time.perf_counter() - t0
        result["checkpoint_bytes"] = os.path.getsize(args.checkpoint)
        result["checkpoints"] += 1

    times = []
    t0 = time.time()
    n = 0
    kfs_at_ckpt = system.world.n_keyframes
    for frame in ds.frames(args.limit, maps=maps, prefetch=use_native):
        if stop:
            break
        times.append(frame.t)
        if frame.index < start:
            continue  # already in the resumed state
        if debug_hook is not None:
            # processing lags dispatch by the pipeline depth: keep a few
            # recent left frames for the overlay writer
            debug_hook.cache[frame.index] = np.asarray(frame.left)
            for k in list(debug_hook.cache):
                if k < frame.index - 8:
                    del debug_hook.cache[k]
        if mono:
            system.track_mono_imu(frame.left, imu=frame.imu)
        else:
            system.track_stereo(frame.left, frame.right, imu=frame.imu)
        n += 1
        if (
            args.checkpoint
            and args.checkpoint_every > 0
            and system.world.n_keyframes - kfs_at_ckpt >= args.checkpoint_every
        ):
            system.exit()  # drain the BA in flight so that the snapshot is consistent
            checkpoint()
            kfs_at_ckpt = system.world.n_keyframes
        if live_viz is not None:
            live_viz.maybe_export(system.tracker)
        if n % 50 == 0:
            fps = n / (time.time() - t0)
            print(f"frame {n}  {fps:.1f} fps  kfs={system.world.n_keyframes} "
                  f"lms={system.world.n_landmarks}")

    system.exit()
    result["global_ba_error"] = None
    if args.global_ba:
        r = system.global_ba()
        if r is not None:
            result["global_ba_error"] = float(r["error"])
            print(f"global BA: {len(r['window'])} kfs, err={r['error']:.1f}, "
                  f"killed={r['n_killed']}")
    wall = time.time() - t0
    if args.checkpoint:
        checkpoint()
        print(f"checkpoint -> {args.checkpoint}")
    system.save_trajectory(args.out, np.asarray(times))
    if args.viz or args.ply:
        from vslam_torch.utils import viz

        poses = system.trajectory()
        if args.viz:
            viz.export_html(args.viz, system.world, poses, active_ids=system.tracker.active_ids)
            print(f"viz -> {args.viz}")
        if args.ply:
            viz.export_ply(args.ply, system.world, poses, active_ids=system.tracker.active_ids)
            print(f"ply -> {args.ply}")
    print(f"done: {n} frames in {wall:.1f}s ({n / max(wall, 1e-9):.1f} fps) -> {args.out}")
    stages = system.tracker.metrics.summary() | system.mapper.metrics.summary()
    counts = system.tracker.counters.summary() | system.mapper.counters.summary()
    if stages:
        print("stages:", json.dumps(stages))
        print("counters:", json.dumps(counts))
    track = stages.get("track", {})
    result.update(
        mode=system.mode.name, frames=n, wall_s=wall, fps=n / max(wall, 1e-9), io=io,
        keyframes=system.world.n_keyframes, landmarks=system.world.n_landmarks,
        ba_runs=system.mapper.ba_count, frame_p50_ms=track.get("p50_ms"),
        frame_p90_ms=track.get("p90_ms"), device=str(system.device),
    )
    return result


if __name__ == "__main__":
    main()
