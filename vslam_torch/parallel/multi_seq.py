"""Multi-sequence batch mode: S sequences as one batched frame step (port
of vslam_tpu/parallel/multi_seq.py).

The reference processes one dataset sequence per process (reference
src/VIOSlam.cpp:141-329). Here S same-resolution sequences ride ONE frame
step (:func:`vslam_torch.models.tracker.track_step_batch`): every op of
the step takes the S problems on its leading dimension, so a frame costs
the launches of one sequence, one ``extract_windows`` launch over the 2S
(stereo) or S (mono) views, one host read per radius attempt for all S,
and one device-to-host copy of the stacked result blob.

Design: each sequence keeps its own tracker (host bookkeeping, keyframe
policy, world map, local mapper): those are per-sequence and event
driven. Only the per-frame step is batched: before each frame the
per-sequence states are stacked, the step runs once, and each tracker is
handed its slice of the outputs through its normal pending-queue pipeline,
so keyframe insertion, re-anchoring and recovery behave exactly as in
single-sequence mode.

Constraints: all sequences share resolution, tracker shapes and mode
(stereo, stereo-inertial or mono-inertial) and live on one device;
intrinsics, baselines and IMU constants (gravity after each sequence's
one-time init, T_bc, noise parameters) are per sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.models import tracker as tracker_mod
from vslam_torch.ops import imu as imu_ops
from vslam_torch.utils import metrics as metrics_mod


class BatchedStereoFrontend:
    """Drive S StereoTrackers (or S MonoTrackers) with one batched frame
    step. Each MonoTracker's bootstrap runs unbatched through its own
    track() (host-driven, per-sequence event logic); the batch starts once
    every sequence has initialized. ``metrics`` times the batched frames
    (stage ``track``, and the frame step's stages, see
    ``tracker.track_step_batch``) and ``counters`` counts the step's radius
    attempts, LM iterations and host reads."""

    def __init__(self, trackers: list):
        if not trackers:
            raise ValueError("BatchedStereoFrontend needs at least one tracker")
        t0 = trackers[0]
        p0 = t0.params
        self._mono = bool(t0._mono)
        for t in trackers[1:]:
            p = t.params
            if (p.n_features, p.n_levels, p.active_size, t.width, t.height) != (
                p0.n_features, p0.n_levels, p0.active_size, t0.width, t0.height
            ):
                raise ValueError("batched sequences must share resolution and tracker shapes")
            if (t.imu_cfg is None) != (t0.imu_cfg is None):
                raise ValueError("all batched sequences must agree on IMU mode")
            if t.imu_cfg is not None and t.imu_cfg.max_samples != t0.imu_cfg.max_samples:
                raise ValueError("batched IMU sequences must share max_samples")
            if bool(t._mono) != self._mono:
                raise ValueError("batched sequences must agree on mono vs stereo mode")
            if t.device != t0.device:
                raise ValueError("batched sequences must live on one device")
        self.trackers = trackers
        self.S = len(trackers)
        self.device = t0.device
        self._has_imu = t0.imu_cfg is not None
        self._K_b = torch.stack([t.K for t in trackers])
        self._bl_b = torch.stack([t.baseline for t in trackers])
        # the stacked IMU constants: gravity differs per sequence once each
        # one-time gravity init ran (set_gravity replaces the tracker's
        # _imu_const tuple), so the stack is rebuilt whenever any tracker's
        # tuple changed
        self._const_b = None
        self._const_ids = None
        self.metrics = metrics_mod.StageTimer()
        self.counters = metrics_mod.Counters()

    def _imu_const_b(self):
        consts = [t._imu_const for t in self.trackers]
        ids = tuple(id(c) for c in consts)
        if ids != self._const_ids:
            prms = [c[2] for c in consts]
            if len(set(prms)) == 1:
                prm = prms[0]
            else:  # per-sequence noise parameters ride as (S,) tensors
                prm = imu_ops.ImuParams(*(
                    torch.tensor(np.float32(col), device=self.device) for col in zip(*prms)
                ))
            self._const_b = (
                torch.stack([c[0] for c in consts]), torch.stack([c[1] for c in consts]), prm
            )
            self._const_ids = ids
        return self._const_b

    def _frames(self, frames) -> torch.Tensor:
        """The frames as one float32 (S, 2|1, H, W) tensor on the device:
        host arrays are stacked on the host and copied once."""
        if isinstance(frames, (torch.Tensor, np.ndarray)):
            LR = torch.as_tensor(frames)
        else:
            views = [self._view(f) for f in frames]
            if all(isinstance(v, np.ndarray) for v in views):
                LR = torch.as_tensor(np.stack(views))
            else:
                LR = torch.stack([torch.as_tensor(v).to(self.device, torch.float32) for v in views])
        LR = LR.to(self.device, torch.float32)
        return LR[:, None] if LR.ndim == 3 else LR

    def _view(self, f):
        """One sequence's frame: a (left, right) pair (or (left,) mono) of
        arrays or tensors, stacked; or one image or stacked frame as it is."""
        if not isinstance(f, (list, tuple)):
            return f
        f = f[: 1 if self._mono else 2]
        if all(isinstance(v, np.ndarray) for v in f):
            return np.stack(f)
        return torch.stack([torch.as_tensor(v).to(self.device) for v in f])

    # ------------------------------------------------------------------
    def track(self, frames, imu=None) -> list:
        """One frame for every sequence. `frames` = list of (left, right)
        numpy pairs (stereo) or left images (mono), or a pre-staged
        (S, 2|1, H, W) array or tensor. `imu` = list of per-sequence
        [dt, gyro, accel] row arrays (None entries allowed) when the batch
        runs with IMU. Returns the newest PROCESSED pose per sequence
        (lagging by each tracker's pipeline depth, exactly as
        single-sequence track()).

        Mono: while ANY sequence is still bootstrapping, every sequence
        runs unbatched through its own track(); the caller must service
        `needs_init_triangulation` exactly as in single-sequence mode."""
        ts = self.trackers
        bootstrapping = self._mono and any(not t.initialized for t in ts)
        if ts[0].frame_idx == 0 or bootstrapping:
            # per-sequence init (frame-0 stereo map seed / mono bootstrap)
            for i, t in enumerate(ts):
                f = frames[i]
                rows = imu[i] if imu is not None else None
                if isinstance(f, (list, tuple)):  # (left, right) or (left,)
                    t.track(*(np.asarray(v) for v in f[: 1 if self._mono else 2]), imu=rows)
                else:  # one view, or a staged (2|1, H, W) array or tensor
                    t.track(f, imu=rows)
            return [t.pose.copy() for t in ts]

        t0 = ts[0]
        p = t0.params
        with self.metrics.stage("track", frame=t0.frame_idx):
            for t in ts:
                t.counters.inc("frames")
            LR = self._frames(frames)
            imu_arg = None
            if self._has_imu:
                n_max = t0.imu_cfg.max_samples
                rows = [
                    np.zeros((0, 7), np.float32) if r is None else np.asarray(r, np.float32)[:n_max]
                    for r in (imu if imu is not None else [None] * self.S)
                ]
                imu_arg = (rows, *self._imu_const_b())
            radii = t0._radii_first if t0.frame_idx == 1 else t0._radii
            new_state, outputs = tracker_mod.track_step_batch(
                LR, tracker_mod.stack_trees([t._state for t in ts]), radii, p.refine_radius,
                t0._desc_thr, t0._ratio, self._K_b, self._bl_b, t0.scale_factors, p,
                t0.width, t0.height, imu=imu_arg, timer=self.metrics, counters=self.counters,
            )
            # one host copy for all S (it counts the refine pass's kernel LM
            # iterations into the step's counters)
            shared = [outputs["blob"], None, outputs.get("lm_iters"), self.counters]
            for s, t in enumerate(ts):
                t._state = tracker_mod.index_tree(new_state, s)
                out_s = tracker_mod.index_tree(outputs, s)
                out_s["shared_blob"], out_s["seq"] = shared, s
                t._pending.append((t.frame_idx, out_s, t.active_ids.copy(), t._D.copy()))
                t.frame_idx += 1
                while len(t._pending) > t.params.pipeline_depth:
                    t._process(*t._pending.popleft())
        return [t.pose.copy() for t in ts]

    def flush(self):
        for t in self.trackers:
            t.flush()
