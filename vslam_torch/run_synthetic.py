"""End-to-end drive on a rendered synthetic world (the port of
examples/run_synthetic.py), with no dataset: renders one of the built-in
scenes, runs the full pipeline (extraction, stereo matching or the mono
bootstrap, tracking, the async local BA or mono triangulation) and prints
fps + ATE against the scene's exact ground truth.

    python -m vslam_torch.run_synthetic                  # EuRoC-geometry stereo
    python -m vslam_torch.run_synthetic --scene kitti    # KITTI-geometry stereo
    python -m vslam_torch.run_synthetic --scene mono     # monocular-inertial, lateral
    python -m vslam_torch.run_synthetic --global-ba      # + one BA over the whole map
    python -m vslam_torch.run_synthetic --device cpu --frames 8

Runs on the GPU unless ``--device cpu``. Not ported yet (NotImplementedError):
``--scene loop`` (loop closure, ROADMAP A10) and ``--viz`` (the map viewer,
A8).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

SCENES = {
    # name: (width, height, fps, n_frames, n_features, description)
    "euroc": (752, 480, 20.0, 80, 1024, "EuRoC-geometry stereo"),
    "kitti": (1248, 384, 10.0, 40, 2048, "KITTI-geometry stereo"),
    "mono": (752, 480, 20.0, 60, 1024, "monocular-inertial (lateral)"),
    "loop": (512, 384, 10.0, 325, 1024, "closed circuit + loop closure"),
}


def config(W: int, H: int, fps: float, nfeat: int, slam_mode: int) -> dict:
    """The driver's config in the reference's schema (a rectified rig
    matching the synthetic scene)."""
    cam = {"fx": 460.0, "fy": 460.0, "cx": W / 2, "cy": H / 2}
    return {
        "rectified": True, "slamMode": slam_mode, "dataset": "KITTI",
        "imagesPath": "/nonexistent", "fileExtension": ".png",
        "Camera": {"width": W, "height": H, "fps": fps, "bl": 0.12},
        "Camera_l": dict(cam), "Camera_r": dict(cam),
        "FE": {"nFeatures": nfeat, "nLevels": 8, "imScale": 1.2, "edgeThreshold": 19,
               "maxFastThreshold": 20, "minFastThreshold": 7},
        "IMU": {"Hz": 200, "gyroscope_noise_density": 1.7e-4,
                "accelerometer_noise_density": 2.0e-3, "gyroscope_random_walk": 1.9e-5,
                "accelerometer_random_walk": 3.0e-3, "gravity": [0.0, 0.0, -9.81]},
    }


def main(argv=None) -> dict:
    """Run the drive; prints the ``[result]`` line and returns its fields."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="euroc")
    ap.add_argument("--frames", type=int, default=0, help="override frame count")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--viz", default=None, help="HTML map viewer output path")
    ap.add_argument("--global-ba", action="store_true")
    args = ap.parse_args(argv)
    if args.scene == "loop":
        raise NotImplementedError("vslam_torch: --scene loop (loop closure, ROADMAP A10) is not ported yet")
    if args.viz:
        raise NotImplementedError("vslam_torch: --viz (the map viewer, ROADMAP A8) is not ported yet")

    from vslam_torch.models import system as system_mod
    from vslam_torch.utils import datasets, synthetic, trajectory
    from vslam_torch.utils.config import ConfigFile

    W, H, fps, n, nfeat, desc = SCENES[args.scene]
    if args.frames:
        n = args.frames
    print(f"[scene] {desc}: {W}x{H} @ {fps} fps, {n} frames, {nfeat} features")

    mono = args.scene == "mono"
    t0 = time.time()
    if mono:
        scene = synthetic.make_scene(
            n_frames=n, n_points=900, width=W, height=H, fps=fps, seed=11,
            texture="distinct", motion="lateral",
        )
    else:
        scene = synthetic.make_scene(
            n_frames=n, n_points=900, width=W, height=H, fps=fps,
            seed=3 if args.scene == "euroc" else 5,
        )
    print(f"[scene] built in {time.time() - t0:.1f}s; rendering + tracking...")

    conf = ConfigFile.from_dict(config(W, H, fps, nfeat, 2 if mono else 1))
    sys_ = system_mod.VSlamSystem(
        conf, async_ba=True, lm_capacity=1 << 15, kf_capacity=128, device=args.device
    )
    if mono:
        sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
        bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    t0 = time.time()
    for f in range(n):
        if mono:
            sys_.track_mono_imu(scene.render(f), imu=bins[f])
        else:
            sys_.track_stereo(scene.render(f), scene.render(f, right=True))
        if (f + 1) % 50 == 0:
            print(f"  frame {f + 1}/{n}  kfs={sys_.world.n_keyframes}")
    sys_.exit()
    wall = time.time() - t0
    gt = scene.poses_c2w[:n]
    result = {}
    if args.global_ba:
        result["ate_before_global_ba_m"] = float(trajectory.ate_rmse(sys_.trajectory(), gt, align=False))
        t0 = time.time()
        g = sys_.global_ba()
        result["global_ba_s"] = time.time() - t0
        result["global_ba_error"] = None if g is None else g["error"]

    poses = sys_.trajectory()
    ate = float(trajectory.ate_rmse(poses, gt[: len(poses)], align=False))
    result = {
        "scene": args.scene, "frames": n, "wall_s": wall, "fps": n / wall, "ate_m": ate,
        "keyframes": sys_.world.n_keyframes, "landmarks": sys_.world.n_landmarks,
        "ba_runs": sys_.mapper.ba_count, "device": str(sys_.device), **result,
    }
    if mono:
        trk = sys_.tracker
        result["bootstrap_views"] = len(trk.bootstrap_slots)
        result["init_frame"] = int(sys_.world.kf_frame_idx[trk.bootstrap_slots[-1]])
    print(
        f"[result] {n} frames in {wall:.1f}s ({n / wall:.1f} fps incl. host "
        f"rendering) | ATE RMSE vs exact GT: {ate:.4f} m | "
        f"{sys_.world.n_keyframes} keyframes, {sys_.world.n_landmarks} landmarks"
    )
    return result


if __name__ == "__main__":
    main()
