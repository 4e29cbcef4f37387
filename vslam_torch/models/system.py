"""System facade (port of vslam_tpu/models/system.py; reference
VSlamSystem, include/System.h:15-57, src/System.cpp): one config ->
cameras, tracker, map and local mapper; ``track_stereo`` per frame, with
the local mapper run synchronously at every keyframe; trajectories saved
in the reference's KITTI 3x4 format (src/System.cpp:87-124).

Ported: ``SlamMode.STEREO`` with the synchronous local BA. Everything runs
on ``device`` (the GPU unless the caller asks for the CPU). Not ported,
each raising NotImplementedError: the STEREO_IMU and MONOCULAR modes
(ROADMAP A9), ``async_ba=True`` (the next slice), ``shards`` (A12),
``loop_closure=True`` (A10) and ``global_ba`` (A11).
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.geometry import camera as cam
from vslam_torch.models import local_mapper, map_state, tracker
from vslam_torch.utils import trajectory as traj_io
from vslam_torch.utils.config import ConfigFile, SlamMode


def _not_ported(what: str):
    raise NotImplementedError(f"vslam_torch: {what} is not ported yet")


class VSlamSystem:
    def __init__(
        self,
        conf: ConfigFile,
        mode: SlamMode | None = None,
        async_ba: bool = False,
        lm_capacity: int = 1 << 16,
        kf_capacity: int = 1024,
        tracker_params: tracker.TrackerParams | None = None,
        io_rectified: bool = False,
        shards: int | str | None = None,
        loop_closure: bool = False,
        *,
        device="cuda",
    ):
        """`io_rectified=True` declares the incoming frames already
        undistorted + rectified, so the facade skips its remap even for an
        unrectified config."""
        self.conf = conf
        self.mode = mode if mode is not None else conf.slam_mode
        if self.mode != SlamMode.STEREO:
            _not_ported(f"SlamMode {self.mode.name} (the IMU and mono paths, ROADMAP A9)")
        if async_ba:
            _not_ported("async_ba=True (the async local mapper, the next slice)")
        if shards is not None and shards != 1:
            _not_ported("shards (the mesh-sharded local BA, ROADMAP A12)")
        if loop_closure:
            _not_ported("loop_closure=True (loop closure, ROADMAP A10)")
        self.device = torch.device(device)
        self.rig = cam.StereoCamera.from_config(conf)
        K = self.rig.left.intrinsics.astype(np.float32)

        fe_total = int(conf.get("FE", "nFeatures", default=2048))
        params = tracker_params or tracker.TrackerParams(
            n_features=_round_pow2(fe_total),
            n_levels=int(conf.get("FE", "nLevels", default=8)),
            scale=float(conf.get("FE", "imScale", default=1.2)),
            fast_hi=float(conf.get("FE", "maxFastThreshold", default=20)),
            fast_lo=float(conf.get("FE", "minFastThreshold", default=7)),
            edge_margin=int(conf.get("FE", "edgeThreshold", default=19)),
        )
        self.world = map_state.WorldMap(
            lm_capacity=lm_capacity, kf_capacity=kf_capacity,
            keys_per_kf=params.n_features, device=self.device,
        )
        self.tracker = tracker.StereoTracker(
            K, self.rig.baseline, self.rig.width, self.rig.height, self.world, params,
            device=self.device,
        )
        self.mapper = local_mapper.LocalMapper(
            self.world, K, self.rig.baseline,
            local_mapper.LocalMapperConfig(n_levels=params.n_levels, scale=params.scale),
        )
        # rectification (EuRoC-style unrectified rigs): maps on the device
        self._maps = None
        if not io_rectified and not conf.rectified and self.rig.left.K is not None:
            self._maps = tuple(
                torch.as_tensor(
                    cam.init_undistort_rectify_map(
                        c.K, c.D, c.R, c.P, self.rig.width, self.rig.height
                    ),
                    device=self.device,
                )
                for c in (self.rig.left, self.rig.right)
            )
        self.loop_closer = None  # loop closure is not ported (A10)

    # ------------------------------------------------------------------
    def _frame(self, img) -> torch.Tensor:
        return torch.as_tensor(img).to(self.device, torch.float32)

    def _rectify(self, left, right):
        """The frame pair, remapped on the device when the rig needs it.
        Frames stay on the device: no host round trip."""
        if self._maps is None:
            return left, right
        return (
            cam.remap_bilinear(self._frame(left), self._maps[0]),
            cam.remap_bilinear(self._frame(right), self._maps[1]),
        )

    def _try_loop_closure(self, kf_slot: int):
        """Post-BA loop detection; a no-op while loop closure is not
        ported (``loop_closer`` is always None)."""
        if self.loop_closer is None:
            return

    def track_stereo(self, left, right, imu=None) -> np.ndarray:
        """Process one frame ((H, W) numpy arrays or tensors); returns the
        (4, 4) cam-to-world pose of the newest processed frame (reference
        TrackStereo, src/System.cpp:72-85). `imu` is ignored in STEREO
        mode, as in the JAX facade."""
        left, right = self._rectify(left, right)
        n_kf_before = len(self.tracker.new_kf_slots)
        if isinstance(left, torch.Tensor) or isinstance(right, torch.Tensor):
            pose = self.tracker.track(torch.stack([self._frame(left), self._frame(right)]))
        else:
            pose = self.tracker.track(left, right)
        self._dispatch_ba(n_kf_before)
        return pose

    def _dispatch_ba(self, n_kf_before: int):
        if len(self.tracker.new_kf_slots) > n_kf_before:
            slot = self.tracker.new_kf_slots[-1]
            if slot > 0:  # BA needs at least 2 KFs
                r = self.mapper.run(slot)
                self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
                self.tracker.add_active(r["new_lm_ids"])
                self._try_loop_closure(slot)

    def exit(self):
        """Drain the tracking pipeline (the reference's ExitSystem is an
        empty stub, src/System.cpp:67-70)."""
        self.tracker.flush()

    def global_ba(self):
        _not_ported("global BA (global_ba / LocalMapper.run_global, ROADMAP A11)")

    # ------------------------------------------------------------------
    def trajectory(self) -> np.ndarray:
        return self.tracker.trajectory()

    def save_trajectory(self, path: str, times: np.ndarray | None = None):
        poses = self.trajectory()
        traj_io.save_kitti_trajectory(path, poses)
        if times is not None:
            traj_io.save_tum_trajectory(path + ".tum", times[: len(poses)], poses)


def _round_pow2(n: int) -> int:
    """Round feature counts to a power of two for tiling-friendly shapes."""
    p = 1
    while p < n:
        p *= 2
    return p
