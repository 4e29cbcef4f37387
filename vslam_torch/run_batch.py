"""Multi-sequence batch mode drive (the port of examples/run_batch.py): S
synthetic sequences tracked as ONE batched frame step
(vslam_torch/parallel/multi_seq.py), each with its own map and synchronous
local mapper.

    python -m vslam_torch.run_batch [n_seqs] [n_frames]        # on the GPU
    python -m vslam_torch.run_batch 2 4 --device cpu
    python -m vslam_torch.run_batch 4 16 --config bench        # 752x480 bench shape

``--config small`` (the default) is examples/run_batch.py's: 320x240,
400 points, 10 fps, seeds 7 + 3s, 512 features, 4 levels, an active set
of 1024. ``--config bench`` is the bench's stereo configuration: 752x480,
900 points, 20 fps, seeds 3 + 3s, 1024 features, 8 levels, an active set
of 4096, 32768 landmark and 128 keyframe slots. Frames are rendered before
the clock starts. Prints per-sequence ATE and the aggregate frames/s,
then a ``[result]`` line; ``main(argv)`` returns its fields.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

CONFIGS = {
    # name: scene, tracker parameters, world capacities, mapper levels
    "small": dict(
        scene=dict(n_points=400, width=320, height=240, fps=10.0, seed0=7),
        params=dict(n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60),
        world=dict(lm_capacity=8192, kf_capacity=64),
        n_levels=4,
    ),
    "bench": dict(
        scene=dict(n_points=900, width=752, height=480, fps=20.0, seed0=3),
        params=dict(n_features=1024, n_levels=8, active_size=4096),
        world=dict(lm_capacity=1 << 15, kf_capacity=128),
        n_levels=8,
    ),
}


def scenes(n_seqs: int, n_frames: int, config: str = "small") -> list:
    """The configuration's synthetic scenes, seeds seed0 + 3s."""
    from vslam_torch.utils import synthetic

    sc = dict(CONFIGS[config]["scene"])
    seed0 = sc.pop("seed0")
    return [synthetic.make_scene(n_frames=n_frames, seed=seed0 + 3 * s, **sc) for s in range(n_seqs)]


def build(n_seqs: int, n_frames: int, config: str = "small", device="cuda"):
    """Scenes, one (StereoTracker, LocalMapper) pair per sequence and the
    batched frontend over the trackers."""
    from vslam_torch.models import local_mapper, map_state, tracker
    from vslam_torch.parallel import multi_seq

    c = CONFIGS[config]
    scene_list = scenes(n_seqs, n_frames, config)
    params = tracker.TrackerParams(**c["params"])
    pairs = []
    for scene in scene_list:
        K = scene.K.astype(np.float32)
        world = map_state.WorldMap(**c["world"], keys_per_kf=params.n_features, device=device)
        trk = tracker.StereoTracker(
            K, scene.baseline, scene.width, scene.height, world, params, device=device
        )
        mapper = local_mapper.LocalMapper(
            world, K, scene.baseline,
            local_mapper.LocalMapperConfig(n_levels=c["n_levels"], scale=params.scale),
        )
        pairs.append((trk, mapper))
    return scene_list, pairs, multi_seq.BatchedStereoFrontend([p[0] for p in pairs])


def run_frames(front, pairs, frames) -> None:
    """Track every frame (a list of per-sequence (left, right) pairs or a
    staged (S, 2, H, W) array), running each sequence's mapper at its new
    keyframes (the synchronous mapper, as examples/run_batch.py does)."""
    for f in frames:
        nks = [len(p[0].new_kf_slots) for p in pairs]
        front.track(f)
        for s, (trk, mapper) in enumerate(pairs):
            if len(trk.new_kf_slots) > nks[s] and trk.new_kf_slots[-1] > 0:
                r = mapper.run(trk.new_kf_slots[-1])
                trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
                trk.add_active(r["new_lm_ids"])
    front.flush()


def main(argv=None) -> dict:
    """Run the drive; prints the ``[result]`` line and returns its fields."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_seqs", nargs="?", type=int, default=4)
    ap.add_argument("n_frames", nargs="?", type=int, default=20)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="small")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from vslam_torch.utils import trajectory

    S, n = args.n_seqs, args.n_frames
    scene_list, pairs, front = build(S, n, args.config, args.device)
    frames = [[(sc.render(f), sc.render(f, right=True)) for sc in scene_list] for f in range(n)]
    t0 = time.perf_counter()
    run_frames(front, pairs, frames)
    wall = time.perf_counter() - t0

    ates = []
    for s, (trk, _) in enumerate(pairs):
        poses = trk.trajectory()
        ate = float(trajectory.ate_rmse(poses, scene_list[s].poses_c2w[:n], align=False))
        ates.append(ate)
        print(f"seq {s}: {len(poses)} frames, ATE {ate * 100:.2f} cm, "
              f"{trk.world.n_keyframes} kfs, {trk.world.n_landmarks} lms")
    step = front.metrics.summary().get("track", {})
    result = {
        "config": args.config, "n_seqs": S, "frames": n, "wall_s": wall,
        "aggregate_fps": S * n / wall, "ate_m": ates,
        "keyframes": [p[0].world.n_keyframes for p in pairs],
        "ba_runs": [p[1].ba_count for p in pairs],
        "batched_frame_p50_ms": step.get("p50_ms"), "batched_frame_p90_ms": step.get("p90_ms"),
        "device": str(front.device),
    }
    print(f"[result] {S} sequences x {n} frames in {wall:.1f}s "
          f"({S * n / wall:.1f} aggregate frames/s, mappers included) | "
          f"max ATE {max(ates):.4f} m")
    return result


if __name__ == "__main__":
    main()
