"""System facade (port of vslam_tpu/models/system.py; reference
VSlamSystem, include/System.h:15-57, src/System.cpp): one config ->
cameras, tracker, map and local mapper; ``track_stereo`` per frame, with
the local mapper run at every keyframe; trajectories saved in the
reference's KITTI 3x4 format (src/System.cpp:87-124).

Ported: ``SlamMode.STEREO``, ``SlamMode.STEREO_IMU`` (IMU rows with
absolute timestamps, the one-time gravity init) and ``SlamMode.MONOCULAR``
(mono + IMU through ``track_mono_imu``: the tracker's bootstrap, the
one-time init triangulation, then mono triangulation at every keyframe and
no window BA), the synchronous local BA, ``async_ba=True``,
``global_ba`` (one BA over the whole map) and ``loop_closure=True``
(models/loop_closure: detection after each keyframe's BA result, the pose
graph and merge, then a rate-limited global-BA polish). The async BA keeps the JAX
package's schedule (which decides which map each tracking step sees):
phase A at the keyframe,
the solve on the mapper's worker thread, the write-back behind the second
tracked frame after it, the consume (early landmark publication, then
re-anchoring) before the third, at a fixed latency with
``deterministic_ba_latency`` or once the solve is ready (at most
``ba_max_latency_frames``) without it. Everything runs on ``device`` (the
GPU unless the caller asks for the CPU). ``shards=N`` shards the mapper's
bundle adjustments over a mesh of N shards (vslam_torch/parallel): N
distinct cards on CUDA (raising if there are fewer), N virtual shards on
the CPU; ``"auto"`` takes every visible card, so it is unsharded on one
card and on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.geometry import camera as cam
from vslam_torch.models import local_mapper, map_state, tracker
from vslam_torch.parallel import mesh as mesh_mod
from vslam_torch.utils import metrics as metrics_mod
from vslam_torch.utils import trajectory as traj_io
from vslam_torch.utils.config import ConfigFile, SlamMode


class VSlamSystem:
    """``metrics`` times the stages ``frame`` (each call of
    ``track_stereo`` / ``track_mono_imu``), ``frame.upload`` (the frames'
    rectification and their copy to the device), ``ba`` (a synchronous
    local BA) and ``build`` (the construction)."""

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
        unrectified config. `loop_closure`: detect revisits at every
        keyframe and correct the whole trajectory (models/loop_closure)."""
        self.metrics = metrics_mod.StageTimer()
        with self.metrics.stage("build"):
            self.conf = conf
            self.mode = mode if mode is not None else conf.slam_mode
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

            # IMU config (STEREO_IMU / MONO_IMU; reference IMU YAML block +
            # T_bc1, config/config_MH_01.yaml:18-24, 112-115)
            imu_cfg = None
            self._imu_hz = 200.0
            if self.mode in (SlamMode.STEREO_IMU, SlamMode.MONO_IMU):
                hz = float(conf.get("IMU", "Hz", default=200))
                self._imu_hz = hz
                T_bc = conf.get_matrix("T_bc1", default=None)
                if T_bc is None:
                    T_bc = np.eye(4, dtype=np.float32)
                imu_cfg = tracker.ImuConfig(
                    gyro_noise=float(conf.get("IMU", "gyroscope_noise_density", default=1.7e-4)),
                    accel_noise=float(conf.get("IMU", "accelerometer_noise_density", default=2e-3)),
                    gyro_walk=float(conf.get("IMU", "gyroscope_random_walk", default=1.9e-5)),
                    accel_walk=float(conf.get("IMU", "accelerometer_random_walk", default=3e-3)),
                    hz=hz,
                    T_bc=np.asarray(T_bc, np.float32).reshape(4, 4),
                    gravity_w=np.array([0.0, 0.0, -9.81], np.float32),
                )
            self._last_imu_t: float | None = None
            self._gravity_set = False

            if self.mode == SlamMode.MONOCULAR:
                self.tracker = tracker.MonoTracker(
                    K, self.rig.width, self.rig.height, self.world, params, imu_cfg=imu_cfg,
                    device=self.device,
                )
            else:
                self.tracker = tracker.StereoTracker(
                    K, self.rig.baseline, self.rig.width, self.rig.height, self.world, params,
                    imu_cfg=imu_cfg, device=self.device,
                )
            # optional explicit world gravity (config `IMU.gravity: [x, y, z]`):
            # the reference's init permutes the first accel sample's axes for
            # EuRoC's sensor mounting (src/VIOSlam.cpp:274); any other rig
            # needs the true vector
            g = conf.get("IMU", "gravity", default=None)
            if g is not None and imu_cfg is not None:
                self.tracker.set_gravity(np.asarray(g, np.float32))
                self._gravity_set = True
            mesh = None
            if shards is not None and shards != 1:
                auto = torch.cuda.device_count() if self.device.type == "cuda" else 1
                n = auto if shards == "auto" else int(shards)
                if n > 1:
                    mesh = mesh_mod.make_mesh(n, device=self.device)
            self.mapper = local_mapper.LocalMapper(
                self.world, K, self.rig.baseline,
                local_mapper.LocalMapperConfig(n_levels=params.n_levels, scale=params.scale),
                mesh=mesh,
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
            # after an applied closure, one global BA polishes the corrected
            # map, but only once the map gained `polish_min_new_kfs` keyframes
            # since the last polish (the graph and merge apply every time)
            self.closure_polish = True
            self.polish_min_new_kfs = 4
            self._last_polish_nkf = -(1 << 30)  # the first closure always polishes
            self.loop_closer = None
            if loop_closure:
                from vslam_torch.models import loop_closure as lc_mod

                self.loop_closer = lc_mod.LoopCloser(self.world, K, self.rig.baseline, system=self)

            self._async = async_ba
            self._pending_ba: dict | None = None
            self._ba_dispatch_frame = -1
            self._frame_count = 0
            # frames an async BA ages before its consume: the write-back lands
            # behind the second tracked frame after the keyframe, the consume
            # comes before the third (vslam_tpu system.py:171-192)
            self.ba_latency_frames = 2
            # without deterministic_ba_latency the consume waits, past that
            # age, until the solve is ready (pending_ready), at most this many
            # frames; the trajectory then depends on thread timing
            self.ba_max_latency_frames = 8
            # True: consume at exactly ba_latency_frames, joining the worker if
            # it is still running (a trajectory reproducible bit for bit)
            self.deterministic_ba_latency = False

    # ------------------------------------------------------------------
    def _frame(self, img) -> torch.Tensor:
        """The frame as a float32 tensor on the device. A uint8 frame (the
        native reader's) crosses to the device as uint8, a quarter of the
        bytes, and is converted there."""
        return torch.as_tensor(img).to(self.device).to(torch.float32)

    def _rectify(self, left, right):
        """The frame pair, remapped on the device when the rig needs it.
        Frames stay on the device: no host round trip."""
        if self._maps is None:
            return left, right
        return (
            cam.remap_bilinear(self._frame(left), self._maps[0]),
            cam.remap_bilinear(self._frame(right), self._maps[1]),
        )

    def _consume_ba_results(self, force: bool = False):
        """Finish the in-flight async BA, if any, once it is
        ``ba_latency_frames`` old (or at once with `force`): publish its
        triangulated landmarks, then (when deterministic, ready, or past
        ``ba_max_latency_frames``) re-anchor the tracker on its result."""
        if self._pending_ba is None:
            return
        if not force:
            age = self._frame_count - self._ba_dispatch_frame
            if age < self.ba_latency_frames:
                return
            # the triangulated landmarks go live independent of the BA
            self.tracker.add_active(self.mapper.consume_triangulation(self._pending_ba))
            if (
                not self.deterministic_ba_latency
                and age < self.ba_max_latency_frames
                and not local_mapper.pending_ready(self._pending_ba)
            ):
                return  # the solve is still running; look again next frame
        r = self.mapper.finish(self._pending_ba)
        self._pending_ba = None
        self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        self.tracker.add_active(r.get("new_lm_ids", ()))
        self._try_loop_closure(r["kf_slot"])

    def _try_loop_closure(self, kf_slot: int):
        """Post-BA loop detection for the newest keyframe. On an applied
        closure the tracker re-anchors on the corrected map (reanchor also
        re-gathers the active set), then (with ``closure_polish``, never in
        mono: a projection-only global BA has no scale gauge) a global BA
        polishes the structure across the seam, which the graph moved only
        rigidly with its anchor keyframes."""
        if self.loop_closer is None:
            return
        r = self.loop_closer.try_close(kf_slot)
        if r is None:
            return
        self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        nkf = self.world.n_keyframes
        if (
            self.closure_polish
            and self.mode != SlamMode.MONOCULAR
            and nkf - self._last_polish_nkf >= self.polish_min_new_kfs
        ):
            g = self.mapper.run_global()
            if g is not None:
                self._last_polish_nkf = nkf
                self.tracker.reanchor(g["kf_slot"], g["old_pose"], g["new_pose"])

    # ------------------------------------------------------------------
    def _imu_to_dt_rows(self, rows) -> np.ndarray | None:
        """Absolute-timestamp IMU rows (K, 7) [t, w, a] -> (K, 7) [dt, w, a]
        rows for the tracker, with the reference's first-sample 1/Hz
        fallback (src/FeatureTracker.cpp:337-350), and the one-time gravity
        init from the first accel sample (src/VIOSlam.cpp:274)."""
        if rows is None or len(rows) == 0:
            return None
        rows = np.asarray(rows, np.float64)
        if not self._gravity_set:
            a = rows[0, 4:7]
            self.tracker.set_gravity(np.array([a[1], -a[0], a[2]]))
            self._gravity_set = True
        t = rows[:, 0]
        prev = self._last_imu_t if self._last_imu_t is not None else t[0] - 1.0 / self._imu_hz
        dts = np.diff(np.concatenate([[prev], t]))
        self._last_imu_t = float(t[-1])
        return np.concatenate([np.maximum(dts, 0.0)[:, None], rows[:, 1:7]], axis=1).astype(
            np.float32
        )

    def track_stereo(self, left, right, imu=None) -> np.ndarray:
        """Process one frame ((H, W) numpy arrays or tensors); returns the
        (4, 4) cam-to-world pose of the newest processed frame (reference
        TrackStereo / TrackStereoIMU, src/System.cpp:72-85). `imu`: the
        (K, 7) [t, gyro, accel] rows since the previous frame, used in
        STEREO_IMU mode and ignored in STEREO mode."""
        with self.metrics.stage("frame", frame=self.tracker.frame_idx):
            with self.metrics.stage("frame.upload"):
                left, right = self._rectify(left, right)
                if isinstance(left, torch.Tensor) or isinstance(right, torch.Tensor):
                    LR = torch.stack([self._frame(left), self._frame(right)])
                else:
                    LR = self._frame(np.stack([left, right]))  # one host-to-device copy
            if imu is not None and self.mode == SlamMode.STEREO_IMU:
                imu = self._imu_to_dt_rows(imu)
            else:
                imu = None
            if self._async:
                self._consume_ba_results()
            n_kf_before = len(self.tracker.new_kf_slots)
            pose = self.tracker.track(LR, imu=imu)
            self._advance_ba()  # the next phase of an async BA, behind this frame's step
            self._dispatch_ba(n_kf_before)
            return pose

    def track_mono_imu(self, left, imu=None) -> np.ndarray:
        """Process one monocular-inertial frame ((H, W) numpy array or
        tensor; `imu` as for track_stereo); returns the (4, 4) cam-to-world
        pose of the newest processed frame (reference TrackMonoIMU,
        src/System.cpp:82-85). Hands the bootstrap's initial triangulation
        to the mapper, then triangulates at every keyframe."""
        with self.metrics.stage("frame", frame=self.tracker.frame_idx):
            with self.metrics.stage("frame.upload"):
                if self._maps is not None:
                    left = cam.remap_bilinear(self._frame(left), self._maps[0])
                img = self._frame(left)
            imu = self._imu_to_dt_rows(imu) if imu is not None else None
            if self._async:
                self._consume_ba_results()
            n_kf_before = len(self.tracker.new_kf_slots)
            pose = self.tracker.track(img, imu=imu)
            if getattr(self.tracker, "needs_init_triangulation", False):
                ids = self.mapper.find_new_points(self.tracker.new_kf_slots[-1], mono=True)
                self.tracker.add_active(ids)
                self.tracker.needs_init_triangulation = False
                self.tracker.last_kf_tracked = max(len(ids), 1)
            else:
                self._advance_ba()
                self._dispatch_ba(n_kf_before, mono=True)
            return pose

    def _advance_ba(self):
        if self._pending_ba is not None:
            self._pending_ba = self.mapper.advance(self._pending_ba)

    def _dispatch_ba(self, n_kf_before: int, mono: bool = False):
        self._frame_count += 1
        if len(self.tracker.new_kf_slots) > n_kf_before:
            slot = self.tracker.new_kf_slots[-1]
            if slot > 0:  # BA needs at least 2 KFs
                if mono:
                    # no mono window BA (vslam_tpu system.py:340-355: a
                    # projection-only window has no scale gauge and
                    # amplified drift ~100x); keyframe mapping is
                    # triangulation only, scale rides on the IMU solve
                    self.tracker.add_active(self.mapper.find_new_points(slot, mono=True))
                    self._try_loop_closure(slot)
                elif self._async:
                    self._consume_ba_results(force=True)  # at most one BA in flight
                    self._pending_ba = self.mapper.run_async_staged(slot)
                    self._ba_dispatch_frame = self._frame_count
                else:
                    with self.metrics.stage("ba"):
                        r = self.mapper.run(slot)
                    self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
                    self.tracker.add_active(r["new_lm_ids"])
                    self._try_loop_closure(slot)

    def exit(self):
        """Drain the tracking pipeline and the in-flight BA, and stop the
        mapper's worker thread (the reference's ExitSystem is an empty
        stub, src/System.cpp:67-70)."""
        self.tracker.flush()
        self._consume_ba_results(force=True)
        self.mapper.close()

    def global_ba(self) -> dict | None:
        """Full-map refinement (LocalMapper.run_global): drains the
        pipeline and the in-flight BA first, then re-anchors the tracker on
        the refined newest keyframe so that tracking can go on."""
        self.exit()
        r = self.mapper.run_global()
        if r is not None:
            self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        return r

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
