"""Per-frame stereo tracking frontend (port of vslam_tpu/models/tracker.py,
reference FeatureTracker::TrackImage, src/FeatureTracker.cpp:1108-1278).

One tracked frame (:func:`_track_step`): batched L+R extraction (the patch
windows through the CUDA kernel on a GPU), stereo matching, the
constant-velocity or IMU prediction, the adaptive-radius projection-match +
motion-only-LM retry loop, the radius-4 refine pass, the failure gate and
landmark miss aging. The host side (:class:`StereoTracker`) keeps the JAX
package's dispatch-pipeline semantics: frame f is processed (pose
bookkeeping, keyframe policy, keyframe insertion) only after frames f+1 ..
f+pipeline_depth were tracked, because that delay decides when keyframes
fire and when new landmarks become matchable.

Ported: stereo and stereo-inertial tracking (``imu_cfg``: IMU
preintegration and the 15-dof visual-inertial solve on every frame), the
monocular-inertial :class:`MonoTracker` (IMU bootstrap, then the same frame
step on one image), and lost-tracking recovery: after ``reseed_after``
refused solves the tracker relocalizes on the old map (models/reloc.py)
or, failing that, re-seeds a stereo map at the dead-reckoned pose, and the
per-frame ``debug_hook`` (utils/debug_view).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from vslam_torch.geometry import se3
from vslam_torch.models import map_state, reloc
from vslam_torch.ops import extract, imu as imu_ops, lm, project_match, stereo_match
from vslam_torch.utils import metrics as metrics_mod


@dataclasses.dataclass
class ImuConfig:
    """IMU noise model + extrinsics (reference IMU YAML block,
    config/config_MH_01.yaml:18-24, and T_bc1 at 112-115)."""

    gyro_noise: float  # rad/s/sqrt(Hz)
    accel_noise: float  # m/s^2/sqrt(Hz)
    gyro_walk: float
    accel_walk: float
    hz: float
    T_bc: np.ndarray  # (4, 4) body-to-cam
    gravity_w: np.ndarray  # (3,) world-frame gravity (measured-gravity init,
    #                         reference src/VIOSlam.cpp:274)
    max_samples: int = 64  # per-frame sample capacity (rows beyond it are dropped)


@dataclasses.dataclass
class TrackerParams:
    """vslam_tpu.models.tracker.TrackerParams (same names, same defaults;
    see there for the measurements behind them)."""

    n_features: int = 2048
    n_levels: int = 8
    scale: float = 1.2
    fast_hi: float = 20.0
    fast_lo: float = 7.0
    edge_margin: int = 19
    active_size: int = 4096
    spawn_per_kf: int = 256
    max_spawn_close: int = 100  # reference maxAddedStereo budget per KF
    radius_schedule: tuple = (10.0, 40.0, 70.0, 100.0)
    first_frame_radius: float = 120.0
    refine_radius: float = 4.0
    desc_thr: float = 100.0
    ratio: float = 0.8
    # mono re-acquisition (reference src/FeatureTracker.cpp:1400,
    # src/FeatureMatcher.cpp:442-447); None -> MonoTracker derives them: the
    # schedule escalates to 1200 px, thresholds relaxed by +50 / +0.1
    mono_radius_schedule: tuple | None = None
    mono_first_frame_radius: float | None = None
    mono_desc_thr: float | None = None
    mono_ratio: float | None = None
    min_inliers: int = 50
    kf_min_stereo: int = 80
    kf_min_mono: int = 80  # mono KF trigger (reference 1470-1484)
    kf_every: int = 5
    kf_critical_stereo: int | None = None  # None -> 4/5 of kf_min_stereo
    kf_tracked_ratio: float = 0.9
    kf_tracked_ratio_many: float = 0.7
    kf_max_interval: int = 30
    many_keys: int = 350
    outlier_age: int = 20
    reseed_after: int = 3
    close_factor: float = 40.0
    desc_majority: bool = True
    pipeline_depth: int = 2


def _extract(LR: torch.Tensor, p: TrackerParams) -> extract.Keys:
    return extract.extract_batch(
        LR, n_levels=p.n_levels, scale=p.scale, total=p.n_features,
        edge_margin=p.edge_margin, fast_hi=p.fast_hi, fast_lo=p.fast_lo,
    )


def _stereo(LR, kl, kr, fx, baseline, scale_factors, p: TrackerParams):
    return stereo_match.match_stereo(
        LR[0], LR[1],
        kl.xy, kl.octave, kl.desc, kl.valid,
        kr.xy, kr.octave, kr.desc, kr.valid,
        fx, baseline, scale_factors, close_factor=p.close_factor,
    )


def _frontend(LR, fx, baseline, scale_factors, p: TrackerParams):
    """Extraction on both images + stereo matching (frame 0)."""
    keys2 = _extract(LR, p)
    kl, kr = keys2.select(0), keys2.select(1)
    return kl, _stereo(LR, kl, kr, fx, baseline, scale_factors, p)


def _frontend_mono(img: torch.Tensor, p: TrackerParams) -> extract.Keys:
    """Extraction only, on one (H, W) image (the mono bootstrap views)."""
    return _extract(img[None], p).select(0)


def _rot_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle of Ra^T Rb."""
    R = Ra.T @ Rb
    return torch.arccos(torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0))


def _no_stereo(keys: extract.Keys) -> dict:
    """The stereo dict of a mono frame: nothing matched, no right x
    (vslam_tpu/models/tracker.py:248-255)."""
    N = keys.xy.shape[0]
    dev = keys.xy.device
    none = torch.zeros((N,), dtype=torch.bool, device=dev)
    return {
        "matched": none,
        "close": none,
        "depth": torch.zeros((N,), dtype=torch.float32, device=dev),
        "est_right_x": torch.full((N,), -1.0, dtype=torch.float32, device=dev),
    }


def _track_step(
    LR: torch.Tensor,  # (2, H, W) float32 left/right, or (1, H, W) mono
    state: dict,
    radii: list,  # adaptive radius schedule (reference 1191-1233)
    refine_radius: float,
    desc_thr: float,
    ratio: float,
    K: torch.Tensor,
    baseline: torch.Tensor,
    scale_factors: torch.Tensor,
    p: TrackerParams,
    width: int,
    height: int,
    imu=None,
):
    """One tracked frame. Returns (new_state, outputs); outputs hold what a
    keyframe insertion needs plus the packed f32 ``blob``
    [pose 16 | vel 3 | bias 6 | stats 9 | miss_age A] the host reads. A
    mono frame (`LR` of one image) has no stereo matching and no right-image
    matching (reference TrackImageMonoIMU, src/FeatureTracker.cpp:1280-1495).

    `imu` (the STEREO_IMU path): (samples (K, 7) host array of [dt, gyro,
    accel] rows, gravity_w (3,), T_bc (4, 4), ImuParams). Every frame then
    takes the single-start 15-dof solve, a frame without samples included;
    its prediction falls back to constant velocity (vslam_tpu
    tracker.py:283-293, 410-430)."""
    n_levels, min_inliers = p.n_levels, p.min_inliers
    active = state["active"]
    dev = LR.device
    # previous solved poses re-projected onto SE(3) (se3.orthonormalize)
    pose_prev = se3.orthonormalize(state["pose"])
    prev_prev = se3.orthonormalize(state["prev_pose"])

    keysb = _extract(LR, p)
    keys = keysb.select(0)
    mono = LR.shape[0] == 1
    if mono:
        kr, st = None, _no_stereo(keys)
    else:
        kr = keysb.select(1)
        st = _stereo(LR, keys, kr, K[0, 0], baseline, scale_factors, p)

    # constant-velocity prediction (reference updatePoses, 1699-1708)
    vel_T = pose_prev @ se3.inverse(prev_prev)
    T_pred = vel_T @ pose_prev
    has_imu = imu is not None
    if has_imu:
        # IMU prediction + preintegration (reference PredictNextPoseIMU,
        # src/FeatureTracker.cpp:1036-1106) over the rows with dt > 0; it
        # replaces the constant-velocity prediction when there are any
        samples, gravity_w, T_bc, imu_params = imu
        rows = imu_ops.active_rows(samples)
        v_prev, bias_prev = state["vel"], state["bias"]
        pre = imu_ops.preintegrate(rows, bias_prev, imu_params)
        T_prev_wb = pose_prev @ se3.inverse(T_bc)
        T_pred_wb, v_pred = imu_ops.predict(T_prev_wb, v_prev, pre, bias_prev, bias_prev, gravity_w)
        if len(rows):
            T_pred = T_pred_wb @ T_bc
        v0, b0 = v_pred, bias_prev
    else:
        v0, b0 = state["vel"], state["bias"]
    A = active["pos"].shape[0]

    def attempt(T_base, v_base, radius, do_right):
        """Projection matching at `radius` + motion-only LM from T_base (two
        starts without IMU, the 15-dof solve with it); right-image matching
        only in the refine pass of a stereo frame."""
        proj = project_match.predict_and_cull(
            T_base, active["pos"], active["valid"], K, baseline, width, height,
            active["maxdist"], active["mindist"], n_levels=n_levels,
        )
        midx, _ = project_match.match_by_projection(
            proj["pred_l"], proj["pred_oct"], active["desc"],
            active["valid"] & proj["in_l"],
            keys.xy, keys.octave, keys.desc, keys.valid,
            radius, scale_factors, desc_thr, ratio,
        )
        matched = midx >= 0
        safe = torch.where(matched, midx, 0)
        obs_l = torch.stack(
            [keys.xy[safe, 0], keys.xy[safe, 1], st["est_right_x"][safe]], dim=-1
        )
        if do_right and not mono:
            midx_r, _ = project_match.match_by_projection(
                proj["pred_r"], proj["pred_oct"], active["desc"],
                active["valid"] & proj["in_r"] & ~matched,
                kr.xy, kr.octave, kr.desc, kr.valid,
                radius, scale_factors, desc_thr, ratio,
            )
            matched_r = midx_r >= 0
            safe_r = torch.where(matched_r, midx_r, 0)
            obs_r3 = torch.stack(
                [kr.xy[safe_r, 0], kr.xy[safe_r, 1], torch.full((A,), -1.0, device=dev)],
                dim=-1,
            )
            obs = torch.where(matched_r[:, None], obs_r3, obs_l)
            oct_obs = torch.where(matched_r, kr.octave[safe_r], keys.octave[safe])
            r_uv = kr.xy[safe_r]
            r_oct = kr.octave[safe_r]
        else:
            midx_r = torch.full((A,), -1, dtype=torch.int64, device=dev)
            matched_r = torch.zeros((A,), dtype=torch.bool, device=dev)
            obs = obs_l
            oct_obs = keys.octave[safe]
            r_uv = torch.zeros((A, 2), dtype=torch.float32, device=dev)
            r_oct = torch.zeros((A,), dtype=torch.int64, device=dev)
        matched = matched | matched_r
        is_stereo = (midx >= 0) & st["matched"][safe]
        w = extract.inv_sigma2(oct_obs, n_levels, p.scale)
        if has_imu:
            T_opt, v_opt, b_opt, _, inl, st_out, _ = lm.motion_only_ba_imu(
                T_base, v_base, bias_prev, T_prev_wb, v_prev, pre, gravity_w,
                imu_params, T_bc, active["pos"], obs, w, is_stereo, matched_r,
                matched, K, baseline, max_iters=100,
            )
        else:
            # MULTI-START (vslam_tpu/models/tracker.py:372-408): solve from
            # the prediction AND the previous pose as one batch of 2, keep
            # the one with more inliers, then lower cost
            Ts, _, inls, sts, rs = lm.motion_only_ba(
                torch.stack([T_base, pose_prev]), active["pos"], obs, w, is_stereo,
                matched_r, matched, K, baseline, max_iters=100,
            )
            na, nb = torch.sum(inls[0]), torch.sum(inls[1])
            use_b = (nb > na) | ((nb == na) & (rs.error[1] < rs.error[0]))
            T_opt = torch.where(use_b, Ts[1], Ts[0])
            inl = torch.where(use_b, inls[1], inls[0])
            st_out = torch.where(use_b, sts[1], sts[0])
            v_opt, b_opt = v_base, b0
        inliers = matched & inl
        return {
            "T": T_opt,
            "v": v_opt,
            "b": b_opt,
            "midx": midx,
            "inliers": inliers,
            "n_m": torch.sum(matched),
            "n_i": torch.sum(inliers),
            "n_st": torch.sum(st_out & inliers),
            "in_frame": active["valid"] & (proj["in_l"] | proj["in_r"]),
            "pred_l": proj["pred_l"],
            "midx_r": midx_r,
            "st_out": st_out,
            "r_uv": r_uv,
            "r_oct": r_oct,
        }

    # adaptive-radius retry loop: every attempt starts from the prediction;
    # the host reads the inlier count once per attempt
    T_opt, v_opt, n_found = T_pred, v0, 0
    for radius in radii:
        if n_found >= min_inliers:
            break
        res = attempt(T_pred, v0, radius, do_right=False)
        T_opt, v_opt, n_found = res["T"], res["v"], int(res["n_i"])

    # refine pass at the small radius from the optimized pose
    res = attempt(T_opt, v_opt, refine_radius, do_right=True)
    T_opt, inliers, midx, midx_r = res["T"], res["inliers"], res["midx"], res["midx_r"]
    n_m, n_i, n_st = res["n_m"], res["n_i"], res["n_st"]
    v_opt, b_opt = res["v"], res["b"]

    # ---- tracking-failure gate (vslam_tpu/models/tracker.py:485-540) ----
    pred_step = torch.linalg.norm(T_pred[:3, 3] - pose_prev[:3, 3])
    sol_jump = torch.linalg.norm(T_opt[:3, 3] - T_pred[:3, 3])
    scene = torch.nanquantile(
        torch.where(active["valid"], active["maxdist"], float("nan")),
        0.5,
        interpolation="midpoint",
    )
    scene = torch.where(torch.isfinite(scene), scene, 20.0)
    t_floor = torch.clamp(10.0 * pred_step, min=0.05 * scene, max=0.5 * scene)
    ang_jump = _rot_angle(T_pred[:3, :3], T_opt[:3, :3])
    pred_ang = _rot_angle(pose_prev[:3, :3], T_pred[:3, :3])
    lost = (
        (n_i < min_inliers // 2)
        | (sol_jump > t_floor)
        | (ang_jump > torch.clamp(10.0 * pred_ang, 0.35, 1.0))
        | ~torch.all(torch.isfinite(T_opt))
        | ~torch.all(torch.isfinite(v_opt))
    )
    T_opt = torch.where(lost, T_pred, T_opt)
    v_opt = torch.where(lost, v0, v_opt)
    b_opt = torch.where(lost, b0, b_opt)
    inliers = inliers & ~lost
    midx = torch.where(lost, -1, midx)
    midx_r = torch.where(lost, -1, midx_r)
    zero = torch.zeros_like(n_m)
    n_m = torch.where(lost, zero, n_m)
    n_i = torch.where(lost, zero, n_i)
    n_st = torch.where(lost, zero, n_st)

    # outlier aging (reference setActiveOutliers, 1016-1034)
    miss_age = torch.where(
        inliers, 0, state["miss_age"] + (res["in_frame"] & ~inliers).long()
    )

    new_state = {
        "pose": T_opt,
        "prev_pose": pose_prev,
        "vel": v_opt,
        "bias": b_opt,
        "active": active,
        "miss_age": miss_age,
    }
    f32 = torch.float32
    stats = torch.cat(
        [
            torch.stack([n_m, n_i, n_st, torch.sum(keys.valid), torch.sum(st["matched"])]).to(f32),
            torch.stack([sol_jump, ang_jump, t_floor]),
            lost.to(f32)[None],
        ]
    )
    blob = torch.cat([T_opt.reshape(-1), v_opt, b_opt, stats, miss_age.to(f32)])
    outputs = {
        "keys": keys,
        "st": st,
        "lm_pred": res["pred_l"],
        "midx": midx,
        "inliers": inliers,
        "in_frame": res["in_frame"],
        "midx_r": midx_r,
        "st_flags": res["st_out"],
        "r_uv": res["r_uv"],
        "r_oct": res["r_oct"],
        "blob": blob,
    }
    return new_state, outputs


def _prepare_keyframe(
    T_kf,
    keys: extract.Keys,
    st_depth,
    st_right_x,
    st_matched,
    st_close,
    match_idx,  # (A,) per-active-landmark key index or -1
    inliers,  # (A,)
    active_ids,  # (A,) global landmark slots (layout match_idx refers to)
    spawn_slots,  # (spawn,) preallocated global slots
    m: map_state.MapArrays,  # current world (read before the commit writes)
    sup_ids,  # (A,) CURRENT active landmark ids incl. the last KF's spawns
    lm_pred,  # (A, 2) the tracked frame's own predicted landmark pixels
    lm_in_frame,  # (A,) bool
    match_r_idx,  # (A,) per-landmark RIGHT-image key index or -1
    r_uv,  # (A, 2)
    r_oct,  # (A,)
    lm_stereo,  # (A,) stereo flag after the solver's stereo->mono demotion
    K,
    spawn: int,
    max_close: int,
    n_levels: int,
    scale: float,
    width: int,
    height: int,
    n_right: int,
):
    """Build the KF observation table + spawn new close-stereo landmarks
    (reference insertKeyFrame, src/FeatureTracker.cpp:743-842; the JAX
    version's comments at tracker.py:634-771 give the rationale of each
    rule). Index orders use stable sorts, as jnp.argsort is stable."""
    dev = keys.xy.device
    N = keys.xy.shape[0]
    ok = (match_idx >= 0) & inliers
    # two landmarks can match one key on a distance tie: the later one
    # keeps it, as in the serial scatter of the CPU and of XLA (a CUDA
    # scatter leaves the winner of duplicate writes undefined)
    ok = map_state.last_writer(torch.where(ok, match_idx, N), ok, N)
    tgt = torch.where(ok, match_idx, N)  # N: out-of-range row, sliced off
    key_lm = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    key_lm[tgt] = torch.where(ok, active_ids, -1)
    key_lm = key_lm[:N]
    clear_st = torch.zeros((N + 1,), dtype=torch.bool, device=dev)
    clear_st[tgt] = ok & ~lm_stereo
    clear_st = clear_st[:N]

    # right-camera-only observations, compacted to the Kr-slot table
    ok_r = (match_r_idx >= 0) & inliers
    take_r = torch.argsort((~ok_r).to(torch.int8), stable=True)[:n_right]
    take_r_ok = ok_r[take_r]
    obs_r_lm = torch.where(take_r_ok, active_ids[take_r], -1)
    obs_r_uv = torch.where(take_r_ok[:, None], r_uv[take_r], 0.0)
    obs_r_oct = torch.where(take_r_ok, r_oct[take_r], 0)

    # spawn suppression: close stereo keys near any landmark matchable in
    # this keyframe (the tracked frame's own predictions + the CURRENT
    # world's active set projected here) do not spawn duplicates
    sup_safe = torch.where(sup_ids >= 0, sup_ids, 0)
    sup_valid = (sup_ids >= 0) & m.lm_valid[sup_safe]
    sup_proj = project_match.predict_and_cull(
        T_kf, m.lm_pos[sup_safe], sup_valid, K, 0.0, width, height,
        m.lm_maxdist[sup_safe], m.lm_mindist[sup_safe], n_levels=n_levels,
    )
    sup_all = torch.cat([lm_pred, sup_proj["pred_l"]], dim=0)
    sup_in = torch.cat([lm_in_frame, sup_proj["in_l"]], dim=0)
    diff = keys.xy[:, None, :] - sup_all[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(sup_in[None, :], d2, float("inf"))
    near_existing = torch.amin(d2, dim=1) < (8.0 * 8.0)
    cand = keys.valid & st_close & (key_lm < 0) & ~near_existing & (st_depth > 0)
    # scan order (key index), the reference's depth order is a documented
    # deviation (vslam_tpu/models/tracker.py:700-707)
    rank_key = torch.where(
        cand, torch.arange(N, dtype=torch.float32, device=dev), float("inf")
    )
    take = torch.argsort(rank_key, stable=True)[:spawn]
    take_valid = cand[take]
    rank = torch.cumsum(take_valid.long(), dim=0) - 1
    take_valid = take_valid & (rank < max_close)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    kxy = keys.xy[take]
    kz = st_depth[take]
    x = (kxy[:, 0] - cx) / fx * kz
    y = (kxy[:, 1] - cy) / fy * kz
    pc = torch.stack([x, y, kz], dim=-1)
    pw = se3.transform_points(T_kf, pc)
    dist = torch.linalg.norm(pc, dim=-1)
    sf = scale ** keys.octave[take].to(torch.float32)
    maxdist = dist * sf
    mindist = maxdist / (scale ** (n_levels - 1))
    new_desc = keys.desc[take]

    # write spawned ids into the key->lm table so the KF observes them
    key_lm_ext = torch.cat([key_lm, key_lm.new_full((1,), -1)])
    key_lm_ext[torch.where(take_valid, take, N)] = torch.where(take_valid, spawn_slots, -1)
    key_lm = key_lm_ext[:N]

    ok_desc = (match_idx >= 0) & inliers
    desc_src = keys.desc[torch.where(ok_desc, match_idx, 0)]
    n_spawned = torch.sum(take_valid)
    return {
        "key_lm": key_lm,
        "refresh_ids": torch.where(ok_desc, active_ids, -1),
        "refresh_desc": desc_src,
        "obs_uv": torch.stack([keys.xy[:, 0], keys.xy[:, 1], st_right_x], dim=-1),
        "obs_oct": keys.octave,
        "obs_stereo": st_matched & keys.valid & ~clear_st,
        "obs_r_lm": obs_r_lm,
        "obs_r_uv": obs_r_uv,
        "obs_r_oct": obs_r_oct,
        "spawn_pos": pw,
        "spawn_desc": new_desc,
        "spawn_maxdist": maxdist,
        "spawn_mindist": mindist,
        "spawn_valid": take_valid,
        # one host fetch: [key_lm (N) | obs_r_lm (Kr) | n_spawned (1)]
        "host_blob": torch.cat([key_lm, obs_r_lm, n_spawned[None]]),
    }


def _prepare_and_commit(
    kf_slot: int, T_kf, keys, st_depth, st_right_x, st_matched, st_close,
    match_idx, inliers, active_ids, spawn_slots,
    m: map_state.MapArrays, sup_ids, lm_pred, lm_in_frame, match_r_idx, r_uv,
    r_oct, st_flags, K, *, spawn: int, max_close: int, n_levels: int,
    scale: float, width: int, height: int, n_right: int, desc_majority: bool = True,
):
    """_prepare_keyframe + the three map writes (in place). Returns the
    packed int64 host blob."""
    data = _prepare_keyframe(
        T_kf, keys, st_depth, st_right_x, st_matched, st_close, match_idx,
        inliers, active_ids, spawn_slots, m, sup_ids, lm_pred,
        lm_in_frame, match_r_idx, r_uv, r_oct, st_flags, K,
        spawn=spawn, max_close=max_close, n_levels=n_levels, scale=scale,
        width=width, height=height, n_right=n_right,
    )
    map_state.scatter_landmarks(
        m, spawn_slots, data["spawn_pos"], data["spawn_desc"],
        data["spawn_maxdist"], data["spawn_mindist"], data["spawn_valid"],
    )
    map_state.refresh_descriptors(
        m, data["refresh_ids"], data["refresh_desc"], majority=desc_majority
    )
    map_state.scatter_keyframe(
        m, kf_slot, T_kf, data["obs_uv"], data["obs_oct"], data["obs_stereo"],
        data["key_lm"], keys.packed, keys.valid, data["obs_r_uv"],
        data["obs_r_oct"], data["obs_r_lm"],
    )
    return data["host_blob"]


def _imu_predict(samples, T_prev_wc, v_prev, bias_prev, gravity_w, T_bc, imu_params):
    """IMU dead-reckoning step (reference PredictNextPoseIMU,
    src/FeatureTracker.cpp:1036-1106; vslam_tpu tracker.py:850-862) over the
    rows of `samples` with dt > 0. Returns (T_pred_wc, v_pred); without such
    rows, the inputs unchanged."""
    rows = imu_ops.active_rows(samples)
    if not len(rows):
        return T_prev_wc, v_prev
    pre = imu_ops.preintegrate(rows, bias_prev, imu_params)
    T_pred_wb, v_pred = imu_ops.predict(
        T_prev_wc @ se3.inverse(T_bc), v_prev, pre, bias_prev, bias_prev, gravity_w
    )
    return T_pred_wb @ T_bc, v_pred


def _map_ages(targets: np.ndarray, layout: np.ndarray, ages: np.ndarray) -> np.ndarray:
    """Look up each target landmark id's miss age in a (layout, ages) pair
    from a possibly older active-set layout; ids not present age 0."""
    out = np.zeros(len(targets), np.int64)
    src = layout >= 0
    lay = layout[src]
    ag = ages[src]
    if len(lay) == 0:
        return out
    order = np.argsort(lay)
    lay_s = lay[order]
    ag_s = ag[order]
    pos = np.searchsorted(lay_s, targets)
    pos_c = np.clip(pos, 0, len(lay_s) - 1)
    hit = (targets >= 0) & (lay_s[pos_c] == targets)
    out[hit] = ag_s[pos_c[hit]]
    return out


def sufficient_motion(
    T_a: np.ndarray, T_b: np.ndarray, min_baseline: float = 0.1, min_angle_deg: float = 5.0
) -> bool:
    """Reference checkSufficientMovement (include/Conversions.h:112-137):
    enough baseline OR rotation between two poses to attempt mono init."""
    d = np.linalg.norm(T_a[:3, 3] - T_b[:3, 3])
    R = T_a[:3, :3].T @ T_b[:3, :3]
    angle = np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
    return d > min_baseline or angle > min_angle_deg


class StereoTracker:
    """Host orchestration of the per-frame loop (reference TrackImage).

    ``track()`` tracks a frame and processes the frame ``pipeline_depth``
    frames older (pose bookkeeping, KF policy, KF insertion); ``flush()``
    drains; ``trajectory()`` flushes. ``self.pose`` is the newest PROCESSED
    frame's pose. Every tensor lives on ``device`` (the GPU unless the
    caller asks for the CPU), which must be the world map's device."""

    def __init__(
        self,
        K: np.ndarray,
        baseline: float,
        width: int,
        height: int,
        world: map_state.WorldMap,
        params: TrackerParams | None = None,
        imu_cfg=None,
        *,
        device="cuda",
    ):
        """`imu_cfg` (an :class:`ImuConfig`) selects the stereo-inertial
        path: every tracked frame then takes the 15-dof solve."""
        self.device = torch.device(device)
        if world.device != self.device:
            raise ValueError(f"tracker device {self.device} != world map device {world.device}")
        self.params = params or TrackerParams()
        p = self.params
        self.imu_cfg = imu_cfg
        self._imu_const = None
        if imu_cfg is not None:
            self._imu_const = (
                self._to_device(imu_cfg.gravity_w),
                self._to_device(np.asarray(imu_cfg.T_bc, np.float32).reshape(4, 4)),
                imu_ops.ImuParams(
                    gyro_noise=imu_cfg.gyro_noise, accel_noise=imu_cfg.accel_noise,
                    gyro_walk=imu_cfg.gyro_walk, accel_walk=imu_cfg.accel_walk,
                ),
            )
        self.velocity = np.zeros(3, np.float32)
        self.bias = np.zeros(6, np.float32)
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        self.baseline = torch.tensor(baseline, dtype=torch.float32, device=self.device)
        self.width = width
        self.height = height
        self.world = world
        self.metrics = metrics_mod.StageTimer()
        self.counters = metrics_mod.Counters()
        self.scale_factors = torch.as_tensor(
            extract.scale_factors(p.n_levels, p.scale), device=self.device
        )
        # radii as f32 values, as the JAX package keeps them on device
        self._radii = [float(np.float32(r)) for r in p.radius_schedule]
        self._radii_first = [float(np.float32(p.first_frame_radius))] * len(p.radius_schedule)
        self._desc_thr = float(np.float32(p.desc_thr))
        self._ratio = float(np.float32(p.ratio))
        self._mono = False

        self.frame_idx = 0
        self.pose = np.eye(4, dtype=np.float32)
        self.prev_pose = np.eye(4, dtype=np.float32)
        self.last_kf_tracked = 0
        self.last_kf_frame = 0
        self.last_kf_slot = -1
        self.lost_streak = 0
        self._last_n_used = 0
        self.last_stats = {}
        # host active-set bookkeeping (layout for the NEXT frame)
        self.active_ids = np.full(p.active_size, -1, np.int64)
        self.miss_age = np.zeros(p.active_size, np.int64)
        # per-frame trajectory: (ref KF slot, relative pose) records
        self.frame_records: list[tuple[int, np.ndarray]] = []
        self.new_kf_slots: list[int] = []
        self._state = None
        self._pending = collections.deque()  # unprocessed (frame, outputs, layout, D)
        # deferred keyframe commit: its host blob is read one frame later
        self._kf_pending = None
        # cumulative BA re-anchoring delta
        self._D = np.eye(4, dtype=np.float32)
        # optional per-frame diagnostic callback (frame_idx, pose, outputs,
        # stats), called once a frame's stats are known; e.g.
        # utils/debug_view.make_tracker_hook writes keypoint overlay PNGs.
        # Whatever it reads from `outputs` it moves to the host itself.
        self.debug_hook = None

    def set_gravity(self, gravity_w: np.ndarray):
        """Install the measured-gravity vector (the reference computes it from
        the first accel sample, src/VIOSlam.cpp:274, after construction)."""
        if self.imu_cfg is None:
            return
        self.imu_cfg.gravity_w = np.asarray(gravity_w, np.float32)
        _, T_bc, prm = self._imu_const
        self._imu_const = (self._to_device(self.imu_cfg.gravity_w), T_bc, prm)

    # ------------------------------------------------------------------
    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(self.device)

    def _gather_active_dev(self):
        ids = torch.as_tensor(self.active_ids, device=self.device)
        return map_state.gather_active(self.world.arrays, ids)

    def _fresh_state(self, pose: np.ndarray):
        return {
            "pose": self._to_device(pose),
            "prev_pose": self._to_device(np.asarray(pose).copy()),
            "vel": self._to_device(self.velocity),
            "bias": self._to_device(self.bias),
            "active": self._gather_active_dev(),
            "miss_age": torch.as_tensor(self.miss_age, device=self.device),
        }

    def _refresh_active(self, new_ids: np.ndarray, layout: np.ndarray, ages: np.ndarray):
        """Merge newly-observed landmark ids into the CURRENT active set,
        dropping aged-out landmarks; evict by staleness, newest-id tiebreak
        (vslam_tpu/models/tracker.py:1063-1106)."""
        cur = self.active_ids
        cur_age = _map_ages(cur, layout, ages)
        alive = (cur >= 0) & (cur_age <= self.params.outlier_age)
        keep = cur[alive]
        keep_age = cur_age[alive]
        merged = np.unique(np.concatenate([keep, new_ids[new_ids >= 0]]))
        m_age = np.zeros(len(merged), np.int64)
        if len(keep):
            order = np.argsort(keep)
            pos = np.searchsorted(merged, keep[order])
            inside = (pos < len(merged)) & (merged[np.clip(pos, 0, len(merged) - 1)] == keep[order])
            m_age[pos[inside]] = keep_age[order][inside]
        A = self.params.active_size
        if len(merged) > A:
            sel = np.sort(np.lexsort((-merged, m_age))[:A])
            merged = merged[sel]
            m_age = m_age[sel]
        out = np.full(A, -1, np.int64)
        out[: len(merged)] = merged
        new_age = np.zeros(A, np.int64)
        new_age[: len(merged)] = m_age
        self.active_ids = out
        self.miss_age = new_age
        if self._state is not None:
            self._state = {
                **self._state,
                "active": self._gather_active_dev(),
                "miss_age": torch.as_tensor(self.miss_age, device=self.device),
            }

    # ------------------------------------------------------------------
    def track(self, left, right=None, imu=None):
        """Track one rectified stereo pair ((H, W) arrays, or a pre-stacked
        (2, H, W) array or tensor as `left`); processes the frame
        ``pipeline_depth`` frames back and returns the newest PROCESSED
        pose. `imu`: the (K, 7) [dt, gyro, accel] rows since the previous
        frame (used only with an ``imu_cfg``; at most ``max_samples``)."""
        with self.metrics.stage("track"):
            self.counters.inc("frames")
            return self._track_frame(left, right, imu)

    def _frames(self, left, right) -> torch.Tensor:
        """The frame as a float32 (views, H, W) tensor on the device: 2
        views for this tracker, 1 for a MonoTracker."""
        if right is not None:
            LR = self._to_device(np.stack([left, right]))
        else:
            LR = torch.as_tensor(left).to(self.device, torch.float32)
            if LR.ndim == 2:
                LR = LR[None]
        if LR.shape[0] != (1 if self._mono else 2):
            raise ValueError(
                f"{type(self).__name__} tracks {'one image' if self._mono else 'stereo pairs'} "
                f"per frame, got {LR.shape[0]} (monocular tracking is MonoTracker)"
            )
        return LR

    def _track_frame(self, left, right, imu=None):
        p = self.params
        LR = self._frames(left, right)

        if self.frame_idx == 0:
            kl, st = _frontend(LR, self.K[0, 0], self.baseline, self.scale_factors, p)
            self._initialize_map(kl, st)
            self._state = self._fresh_state(self.pose)
            self.frame_idx += 1
            return self.pose.copy()

        imu_arg = None
        if self.imu_cfg is not None:
            S = self.imu_cfg.max_samples
            rows = np.zeros((0, 7), np.float32) if imu is None else np.asarray(imu, np.float32)[:S]
            imu_arg = (rows, *self._imu_const)
        radii = self._radii_first if self.frame_idx == 1 else self._radii
        self._state, outputs = _track_step(
            LR, self._state, radii, p.refine_radius, self._desc_thr, self._ratio,
            self.K, self.baseline, self.scale_factors, p, self.width, self.height,
            imu=imu_arg,
        )
        self._pending.append(
            (self.frame_idx, outputs, self.active_ids.copy(), self._D.copy())
        )
        self.frame_idx += 1
        while len(self._pending) > p.pipeline_depth:
            self._process(*self._pending.popleft())
        return self.pose.copy()

    def flush(self):
        """Drain the pipeline (process all tracked-but-unprocessed frames)."""
        while self._pending:
            self._process(*self._pending.popleft())
        self._finish_kf_commit()

    # ------------------------------------------------------------------
    def _process(self, frame_idx: int, outputs: dict, layout: np.ndarray, D_dispatch: np.ndarray):
        """Host-side completion of a tracked frame: one fetch of the packed
        blob, pose bookkeeping, KF policy, KF insertion."""
        p = self.params
        self._finish_kf_commit()
        blob = outputs["blob"].cpu().numpy()
        A = p.active_size
        corr = self._D @ np.linalg.inv(D_dispatch)
        pose = (corr @ blob[:16].reshape(4, 4)).astype(np.float32)
        self.prev_pose = self.pose
        self.pose = pose
        self.velocity = (corr[:3, :3] @ blob[16:19]).astype(np.float32)
        self.bias = blob[19:25].astype(np.float32)
        n_m, n_inl, n_stereo_inl, n_keys, n_stereo_keys = (int(x) for x in blob[25:30])
        ages = blob[34 : 34 + A].astype(np.int64)
        self.last_stats = {
            "n_matched": n_m,
            "n_inliers": n_inl,
            "n_stereo_inliers": n_stereo_inl,
            "n_keys": n_keys,
            "n_stereo_keys": n_stereo_keys,
            "sol_jump": float(blob[30]),
            "ang_jump": float(blob[31]),
            "gate_floor": float(blob[32]),
            "lost": bool(blob[33] > 0.5),
        }
        if self.debug_hook is not None:
            self.debug_hook(frame_idx, pose, outputs, self.last_stats)

        # lost-tracking recovery (vslam_tpu/models/tracker.py:1230-1275;
        # the reference has none). After `reseed_after` consecutive refused
        # solves (the device's lost bit: inlier starvation or a jump
        # refusal): relocalize on the old map, else (stereo only) re-seed a
        # keyframe at the dead-reckoned pose whose spawns are uncapped. The
        # extra spacing keeps a second recovery off frames tracked before
        # the first one's landmarks went live.
        lost = self.last_stats["lost"]
        self.lost_streak = self.lost_streak + 1 if lost else 0
        reseed = False
        recovery_due = (
            self.lost_streak >= p.reseed_after
            and frame_idx - self.last_kf_frame > p.pipeline_depth + p.reseed_after
        )
        if recovery_due:
            if self._relocalize(frame_idx, outputs):
                return  # re-anchored on the old map; no keyframe this frame
            reseed = not self._mono and n_stereo_keys >= p.kf_min_stereo
        if reseed or self._kf_decision(frame_idx, n_keys, n_inl, n_stereo_inl):
            self._finish_kf_commit()
            # a re-seed commits at once: recovery needs the fresh active set
            # now, and its spawn count becomes the tracked baseline
            n_used = self._insert_keyframe(
                frame_idx, pose, outputs, layout, ages, reseed=reseed, defer=not reseed
            )
            self.last_kf_tracked = n_used if reseed else n_inl
            self.last_kf_frame = frame_idx
            self.lost_streak = 0
        else:
            # non-KF record: pose relative to the last KF (reference addFrame)
            ref = self.world.kf_poses_host[self.last_kf_slot]
            rel = np.linalg.inv(ref) @ self.pose
            self.frame_records.append((self.last_kf_slot, rel.astype(np.float32)))
            if np.array_equal(layout, self.active_ids):
                self.miss_age = ages
            else:
                self.miss_age = _map_ages(self.active_ids, layout, ages)

    def _relocalize(self, frame_idx: int, outputs: dict) -> bool:
        """Global relocalization (models/reloc.py): retrieve the keyframe
        whose descriptors best match this frame, verified by a PnP solve;
        restart there with zero velocity and an active set reloaded with
        that keyframe's and its covisible neighbours' landmarks. Frames
        already tracked process as lost. Returns False when no keyframe is
        accepted (the caller may then re-seed)."""
        w = self.world
        if w.n_keyframes == 0:
            return False
        p = self.params
        best, votes, T_opt = reloc.retrieve(
            w, outputs["keys"], w.n_keyframes, K=self.K, baseline=float(self.baseline),
            min_inliers=max(p.min_inliers // 2, 20),
        )
        if best < 0:
            return False
        ids = w.kf_obs_lm[best]
        ids = ids[ids >= 0]
        covis = w.covisible_kfs(best)
        if len(covis):
            more = w.kf_obs_lm[covis]
            ids = np.unique(np.concatenate([ids, more[more >= 0]]))
        A = p.active_size
        out = np.full(A, -1, np.int64)
        out[: min(len(ids), A)] = ids[:A]
        self.active_ids = out
        self.miss_age = np.zeros(A, np.int64)
        # the verified solve is the camera pose; zero velocity restart
        pose = np.asarray(T_opt, np.float32)
        self.pose = pose.copy()
        self.prev_pose = pose.copy()
        self.velocity = np.zeros(3, np.float32)
        self._state = self._fresh_state(self.pose)
        self.lost_streak = 0
        self.last_kf_frame = frame_idx
        self.last_kf_slot = best
        rel = np.linalg.inv(w.kf_poses_host[best]) @ pose
        self.frame_records.append((best, rel.astype(np.float32)))
        self.last_kf_tracked = max(votes, 1)
        self.counters.inc("relocalizations")
        return True

    def _kf_decision(self, frame_idx: int, n_keys: int, n_inl: int, n_stereo_inl: int) -> bool:
        """Keyframe policy (reference src/FeatureTracker.cpp:1262 plus the
        critical low-stereo trigger and the max-gap ceiling; see
        vslam_tpu/models/tracker.py:_kf_decision)."""
        p = self.params
        ratio_thr = p.kf_tracked_ratio_many if n_keys > p.many_keys else p.kf_tracked_ratio
        crit = (
            p.kf_critical_stereo
            if p.kf_critical_stereo is not None
            else (4 * p.kf_min_stereo) // 5
        )
        saw_last_kf = frame_idx - self.last_kf_frame > p.pipeline_depth
        low_stereo = saw_last_kf and n_stereo_inl < p.kf_min_stereo
        critical_stereo = saw_last_kf and n_stereo_inl < crit
        periodic = frame_idx - self.last_kf_frame >= p.kf_every
        degraded = n_inl < ratio_thr * max(self.last_kf_tracked, 1)
        gap = frame_idx - self.last_kf_frame >= p.kf_max_interval
        return (
            ((low_stereo or periodic) and degraded) or critical_stereo or gap
        ) and n_inl >= p.min_inliers // 2

    # ------------------------------------------------------------------
    def _initialize_map(self, keys, st):
        """Frame 0: seed landmarks from stereo depth (reference
        initializeMap, src/FeatureTracker.cpp:72-123)."""
        p = self.params
        A = p.active_size
        dev = self.device
        kf_slot = self.world.alloc_keyframe(0)
        spawn_host = self.world.alloc_landmarks(p.n_features)
        none_i = torch.full((A,), -1, dtype=torch.int64, device=dev)
        none_b = torch.zeros((A,), dtype=torch.bool, device=dev)
        host_blob = _prepare_and_commit(
            kf_slot, self._to_device(self.pose), keys, st["depth"],
            st["est_right_x"], st["matched"],
            st["matched"],  # at init every stereo match seeds a landmark
            none_i, none_b, none_i, torch.as_tensor(spawn_host, device=dev),
            self.world.arrays,
            none_i, torch.zeros((A, 2), device=dev), none_b,
            none_i,  # no right matches
            torch.zeros((A, 2), device=dev), torch.zeros((A,), dtype=torch.int64, device=dev),
            none_b, self.K,
            spawn=p.n_features,
            # map init has no maxAddedStereo cap (reference initializeMap)
            max_close=p.n_features,
            n_levels=p.n_levels, scale=p.scale, width=self.width,
            height=self.height, n_right=self.world.right_obs_per_kf,
            desc_majority=p.desc_majority,
        )
        n_used = self._commit_keyframe(
            kf_slot, host_blob, spawn_host, self.active_ids, self.miss_age,
            T_kf_host=self.pose,
        )
        self.last_kf_tracked = n_used
        self.last_kf_frame = 0

    def _insert_keyframe(
        self, frame_idx: int, pose: np.ndarray, outputs: dict,
        layout: np.ndarray, ages: np.ndarray, reseed: bool = False, defer: bool = False,
    ) -> int:
        """Insert a keyframe at the (re-anchoring-corrected) host pose.
        `reseed`: a re-seed keyframe behaves like frame-0 map init: every
        stereo match spawns, with no spawn cap and no suppression near the
        old landmarks (the ones that stopped matching). `defer`: the host
        side completes at the next processed frame. Returns the spawn count,
        or -1 when deferred."""
        p = self.params
        dev = self.device
        A = p.active_size
        keys, st = outputs["keys"], outputs["st"]
        kf_slot = self.world.alloc_keyframe(frame_idx)
        spawn_n = p.n_features if reseed else p.spawn_per_kf
        spawn_host = self.world.alloc_landmarks(spawn_n)
        if reseed:
            st_close = st["matched"]
            sup_ids = torch.full((A,), -1, dtype=torch.int64, device=dev)
            lm_pred = torch.zeros((A, 2), device=dev)
            lm_in_frame = torch.zeros((A,), dtype=torch.bool, device=dev)
        else:
            st_close = st["close"]
            sup_ids = torch.as_tensor(self.active_ids, device=dev)
            lm_pred, lm_in_frame = outputs["lm_pred"], outputs["in_frame"]
        host_blob = _prepare_and_commit(
            kf_slot, self._to_device(pose), keys, st["depth"], st["est_right_x"],
            st["matched"], st_close, outputs["midx"], outputs["inliers"],
            torch.as_tensor(layout, device=dev), torch.as_tensor(spawn_host, device=dev),
            self.world.arrays, sup_ids, lm_pred, lm_in_frame, outputs["midx_r"],
            outputs["r_uv"], outputs["r_oct"], outputs["st_flags"], self.K,
            spawn=spawn_n, max_close=spawn_n if reseed else p.max_spawn_close,
            n_levels=p.n_levels, scale=p.scale, width=self.width,
            height=self.height, n_right=self.world.right_obs_per_kf,
            desc_majority=p.desc_majority,
        )
        return self._commit_keyframe(
            kf_slot, host_blob, spawn_host, layout, ages, T_kf_host=pose, defer=defer,
        )

    def _commit_keyframe(
        self, kf_slot, host_blob, spawn_host, layout: np.ndarray, ages: np.ndarray,
        T_kf_host: np.ndarray, defer: bool = False,
    ) -> int:
        """Host side of a keyframe commit. defer=True stashes the completion
        (host mirrors, spawn release, active-set refresh) until the next
        processed frame — the JAX package's timing, which decides when the
        new landmarks become matchable."""
        t0 = time.perf_counter()
        self.world.kf_poses_host[kf_slot] = np.asarray(T_kf_host, np.float32)
        self.frame_records.append((kf_slot, np.eye(4, dtype=np.float32)))
        self.last_kf_slot = kf_slot
        pending = {
            "kf_slot": kf_slot, "blob": host_blob, "spawn_host": spawn_host,
            "layout": layout, "ages": ages, "t0": 0.0,
        }
        if defer:
            pending["t0"] = time.perf_counter() - t0
            self._kf_pending = pending
            return -1
        self._kf_pending = pending
        self._finish_kf_commit()
        return self._last_n_used

    def _finish_kf_commit(self):
        """Complete a stashed keyframe commit: read its host blob, update
        the host observation tables, release the unused spawn tail, refresh
        the active set and publish the KF to ``new_kf_slots``."""
        pk = self._kf_pending
        if pk is None:
            return
        self._kf_pending = None
        tb = time.perf_counter()
        w = self.world
        blob = pk["blob"].cpu().numpy()
        N = w.keys_per_kf
        Kr = w.right_obs_per_kf
        key_lm_host = blob[:N]
        w.kf_obs_lm[pk["kf_slot"]] = key_lm_host
        w.kf_obs_r_lm[pk["kf_slot"]] = blob[N : N + Kr]
        n_used = int(blob[-1])
        self.new_kf_slots.append(pk["kf_slot"])
        self._last_n_used = n_used
        # valid spawns are a prefix of the slot block, so the tail is contiguous
        w.release_landmarks(pk["spawn_host"][n_used:])
        self._refresh_active(key_lm_host[key_lm_host >= 0], pk["layout"], pk["ages"])
        self.counters.inc("keyframes")
        self.metrics.record("kf_commit", (time.perf_counter() - tb) + pk["t0"])

    def add_active(self, ids: np.ndarray):
        """Merge externally-created landmarks into the tracked active set."""
        if len(ids):
            self._refresh_active(np.asarray(ids, np.int64), self.active_ids, self.miss_age)

    def refresh_after_ba(self):
        """Re-gather the active landmark arrays after the map changed."""
        if self._state is not None:
            self._state = {**self._state, "active": self._gather_active_dev()}

    # ------------------------------------------------------------------
    def reanchor(self, kf_slot: int, old_pose: np.ndarray, new_pose: np.ndarray):
        """Re-anchor the current tracking pose after a BA update (reference
        changePosesLCA, src/FeatureTracker.cpp:884-908)."""
        delta = (new_pose @ np.linalg.inv(old_pose)).astype(np.float32)
        if not np.isfinite(delta).all():
            return
        self.pose = (delta @ self.pose).astype(np.float32)
        self.prev_pose = (delta @ self.prev_pose).astype(np.float32)
        self._D = delta @ self._D
        if self._state is not None:
            d = self._to_device(delta)
            self._state = {
                **self._state,
                "pose": d @ self._state["pose"],
                "prev_pose": d @ self._state["prev_pose"],
            }
        self.refresh_after_ba()

    def trajectory(self) -> np.ndarray:
        """(F, 4, 4) per-frame poses recomposed as closeKF.pose * relative
        (reference saveTrajectoryAndPosition, src/System.cpp:99-107)."""
        self.flush()
        out = [self.world.kf_poses_host[s] @ rel for s, rel in self.frame_records]
        return np.stack(out) if out else np.zeros((0, 4, 4), np.float32)


class MonoTracker(StereoTracker):
    """Monocular-inertial frontend (reference TrackImageMonoIMU,
    src/FeatureTracker.cpp:1280-1495; vslam_tpu/models/tracker.py:1655-1855).

    Bootstrap: the first keyframe anchors the world; later frames
    dead-reckon on the IMU until `BOOTSTRAP_KFS` motion-gated keyframes
    (include/Conversions.h:112-137) are in, every frame in between becoming
    an observation-only keyframe too (up to `MAX_BOOTSTRAP_VIEWS`), so the
    one-time init triangulates across all of them. The caller then
    triangulates the initial map (``LocalMapper.find_new_points(slot,
    mono=True)``, as ``VSlamSystem.track_mono_imu`` does) and clears
    ``needs_init_triangulation``; metric scale comes from the IMU
    baselines. Steady state is the shared frame step on one image."""

    BOOTSTRAP_KFS = 3  # motion-gated keyframes, reference src/FeatureTracker.cpp:1315
    # every bootstrap frame is a triangulation view up to the mapper's
    # window (local_mapper.WINDOW)
    MAX_BOOTSTRAP_VIEWS = 12
    # view floor before init completes: at fast ego-motion the 3 gates can
    # pass in 3 frames, too few views for a dense init
    MIN_BOOTSTRAP_VIEWS = 6

    def __init__(self, K, width, height, world, params=None, imu_cfg=None, *, device="cuda"):
        super().__init__(
            K, baseline=0.0, width=width, height=height, world=world, params=params,
            imu_cfg=imu_cfg, device=device,
        )
        self._mono = True
        p = self.params
        # the reference's 1200 px mono re-acquisition radius, reached only
        # when the tight radii starve, and its relaxed thresholds
        ms = p.mono_radius_schedule or (10.0, 120.0, 400.0, 1200.0)
        self._radii = [float(np.float32(r)) for r in ms]
        ffr = p.mono_first_frame_radius if p.mono_first_frame_radius is not None else ms[-1]
        self._radii_first = [float(np.float32(ffr))] * len(ms)
        self._desc_thr = float(np.float32(
            p.mono_desc_thr if p.mono_desc_thr is not None else float(p.desc_thr) + 50.0
        ))
        self._ratio = float(np.float32(
            p.mono_ratio if p.mono_ratio is not None else min(float(p.ratio) + 0.1, 0.95)
        ))
        self.initialized = False
        self.bootstrap_slots: list[int] = []  # every bootstrap view's slot
        self.gate_slots: list[int] = []  # the motion-gated subset
        self.needs_init_triangulation = False

    def track(self, left, right=None, imu=None):
        """Track one (H, W) image; `imu` as for StereoTracker.track."""
        if self.initialized:
            return super().track(left, None, imu)
        with self.metrics.stage("track"):
            self.counters.inc("frames")
            return self._bootstrap(left, imu)

    def _bootstrap(self, left, imu):
        img = self._frames(left, None)[0]
        if imu is not None and self.imu_cfg is not None and self.frame_idx > 0:
            # dead-reckon on the IMU (reference PredictNextPoseIMU)
            rows = np.asarray(imu, np.float32)[: self.imu_cfg.max_samples]
            gravity, T_bc, prm = self._imu_const
            T_new, v_new = _imu_predict(
                rows, self._to_device(self.pose), self._to_device(self.velocity),
                self._to_device(self.bias), gravity, T_bc, prm,
            )
            self.prev_pose = self.pose
            self.pose = T_new.cpu().numpy()
            self.velocity = v_new.cpu().numpy()

        take_gate = self.frame_idx == 0 or (
            len(self.gate_slots) < self.BOOTSTRAP_KFS
            and sufficient_motion(self.pose, self.world.kf_poses_host[self.gate_slots[-1]])
        )
        take_view = take_gate or len(self.bootstrap_slots) < self.MAX_BOOTSTRAP_VIEWS - 1
        if take_view:
            self._insert_mono_keyframe(_frontend_mono(img, self.params))
            self.bootstrap_slots.append(self.last_kf_slot)
            if take_gate:
                self.gate_slots.append(self.last_kf_slot)
            if (
                len(self.gate_slots) >= self.BOOTSTRAP_KFS
                and len(self.bootstrap_slots) >= self.MIN_BOOTSTRAP_VIEWS
            ):
                self.needs_init_triangulation = True
                self.initialized = True
                self.last_kf_frame = self.frame_idx
                self._state = self._fresh_state(self.pose)
                # keep the dead-reckoned motion: the next tracked frame's
                # constant-velocity prediction continues the arc
                self._state["prev_pose"] = self._to_device(self.prev_pose)
        else:
            ref = self.world.kf_poses_host[self.last_kf_slot]
            rel = np.linalg.inv(ref) @ self.pose
            self.frame_records.append((self.last_kf_slot, rel.astype(np.float32)))
        self.frame_idx += 1
        return self.pose.copy()

    def _insert_mono_keyframe(self, keys: extract.Keys):
        """A keyframe with observations and no spawns at the current pose
        (mono landmarks come only from multi-view triangulation, reference
        1497-1684); committed at once."""
        p = self.params
        A, N = p.active_size, p.n_features
        dev = self.device
        kf_slot = self.world.alloc_keyframe(self.frame_idx)
        spawn_host = self.world.alloc_landmarks(1)
        none_i = torch.full((A,), -1, dtype=torch.int64, device=dev)
        none_b = torch.zeros((A,), dtype=torch.bool, device=dev)
        none_k = torch.zeros((N,), dtype=torch.bool, device=dev)
        host_blob = _prepare_and_commit(
            kf_slot, self._to_device(self.pose), keys,
            torch.zeros((N,), device=dev),  # st_depth
            torch.full((N,), -1.0, device=dev),  # st_right_x
            none_k, none_k,  # st_matched, st_close: no spawns
            none_i, none_b, none_i, torch.as_tensor(spawn_host, device=dev),
            self.world.arrays, none_i, torch.zeros((A, 2), device=dev), none_b, none_i,
            torch.zeros((A, 2), device=dev), torch.zeros((A,), dtype=torch.int64, device=dev),
            none_b, self.K, spawn=1, max_close=1, n_levels=p.n_levels, scale=p.scale,
            width=self.width, height=self.height, n_right=self.world.right_obs_per_kf,
            desc_majority=p.desc_majority,
        )
        self._commit_keyframe(
            kf_slot, host_blob, spawn_host, self.active_ids, self.miss_age, T_kf_host=self.pose,
        )

    def _kf_decision(self, frame_idx: int, n_keys: int, n_inl: int, n_stereo_inl: int) -> bool:
        """Mono KF policy (reference 1470-1484): a low tracked mono count
        (only for frames tracked after the last keyframe's landmarks went
        live), every-Nth frame with a low tracked ratio, or the max gap."""
        p = self.params
        ratio_thr = p.kf_tracked_ratio_many if n_keys > p.many_keys else p.kf_tracked_ratio
        saw_last_kf = frame_idx - self.last_kf_frame > p.pipeline_depth
        return (
            (saw_last_kf and n_inl < p.kf_min_mono)
            or (
                frame_idx - self.last_kf_frame >= p.kf_every
                and n_inl < ratio_thr * max(self.last_kf_tracked, 1)
            )
            or frame_idx - self.last_kf_frame >= p.kf_max_interval
        ) and n_inl >= p.min_inliers // 2
