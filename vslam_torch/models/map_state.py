"""World map: preallocated structure-of-arrays (port of
vslam_tpu/models/map_state.py).

Same layout as the JAX map. The JAX package updates the map functionally
(each scatter returns a new pytree); here the scatters write the device
tensors IN PLACE, which saves a copy of the observation tables per
keyframe. That is safe because readers take copies: ``gather_active`` and
the keyframe preparation gather (advanced indexing copies) before the
commit writes. Invalid rows are redirected to the dump slot P-1, which is
never allocated and never valid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vslam_torch.ops import hamming

DESC_WORDS = 8  # packed descriptor words (32 bits each, int64 storage)


@dataclasses.dataclass
class MapArrays:
    """Device-resident map storage."""

    lm_pos: torch.Tensor  # (P, 3) f32 world positions
    lm_desc: torch.Tensor  # (P, 256) int8 +-1
    lm_maxdist: torch.Tensor  # (P,) f32 scale band upper
    lm_mindist: torch.Tensor  # (P,) f32 scale band lower
    lm_valid: torch.Tensor  # (P,) bool
    lm_bitsum: torch.Tensor  # (P, 256) int16 running per-bit sum (majority)
    lm_nobs: torch.Tensor  # (P,) int16 observation count
    kf_pose: torch.Tensor  # (W, 4, 4) f32 cam-to-world
    kf_valid: torch.Tensor  # (W,) bool
    obs_uv: torch.Tensor  # (W, K, 3) f32 [u_l, v_l, u_r]
    obs_oct: torch.Tensor  # (W, K) int64
    obs_stereo: torch.Tensor  # (W, K) bool
    obs_lm: torch.Tensor  # (W, K) int64 landmark slot or -1
    obs_desc: torch.Tensor  # (W, K, 8) int64 packed per-KF key descriptors
    obs_valid: torch.Tensor  # (W, K) bool
    obs_r_uv: torch.Tensor  # (W, Kr, 2) f32 right-camera-only obs
    obs_r_oct: torch.Tensor  # (W, Kr) int64
    obs_r_lm: torch.Tensor  # (W, Kr) int64 landmark slot or -1


def _lm_fields(P: int, device) -> dict:
    return dict(
        lm_pos=torch.zeros((P, 3), dtype=torch.float32, device=device),
        lm_desc=torch.zeros((P, 256), dtype=torch.int8, device=device),
        lm_maxdist=torch.zeros((P,), dtype=torch.float32, device=device),
        lm_mindist=torch.zeros((P,), dtype=torch.float32, device=device),
        lm_valid=torch.zeros((P,), dtype=torch.bool, device=device),
        lm_bitsum=torch.zeros((P, 256), dtype=torch.int16, device=device),
        lm_nobs=torch.zeros((P,), dtype=torch.int16, device=device),
    )


def _kf_fields(W: int, K: int, Kr: int, device) -> dict:
    i64 = torch.int64
    return dict(
        kf_pose=torch.eye(4, dtype=torch.float32, device=device).repeat(W, 1, 1),
        kf_valid=torch.zeros((W,), dtype=torch.bool, device=device),
        obs_uv=torch.zeros((W, K, 3), dtype=torch.float32, device=device),
        obs_oct=torch.zeros((W, K), dtype=i64, device=device),
        obs_stereo=torch.zeros((W, K), dtype=torch.bool, device=device),
        obs_lm=torch.full((W, K), -1, dtype=i64, device=device),
        obs_desc=torch.zeros((W, K, DESC_WORDS), dtype=i64, device=device),
        obs_valid=torch.zeros((W, K), dtype=torch.bool, device=device),
        obs_r_uv=torch.zeros((W, Kr, 2), dtype=torch.float32, device=device),
        obs_r_oct=torch.zeros((W, Kr), dtype=i64, device=device),
        obs_r_lm=torch.full((W, Kr), -1, dtype=i64, device=device),
    )


def make_map(
    lm_capacity: int = 1 << 16,
    kf_capacity: int = 512,
    keys_per_kf: int = 2048,
    right_obs_per_kf: int = 256,
    *,
    device,
) -> MapArrays:
    return MapArrays(
        **_lm_fields(lm_capacity, device),
        **_kf_fields(kf_capacity, keys_per_kf, right_obs_per_kf, device),
    )


def last_writer(tgt: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """Among the `ok` rows that scatter to one target of n + 1 (n: the
    discard row), the last row: the one the serial scatter of the CPU and
    of XLA keeps. A CUDA scatter leaves the winner of duplicate writes
    undefined, so writes that may collide are masked with this first."""
    rows = torch.arange(tgt.shape[0], device=tgt.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=tgt.device).scatter_reduce(
        0, tgt, torch.where(ok, rows, -1), "amax", include_self=True
    )
    return ok & (last[tgt] == rows)


def scatter_landmarks(
    m: MapArrays,
    slots: torch.Tensor,  # (S,) target slots
    pos: torch.Tensor,  # (S, 3)
    desc: torch.Tensor,  # (S, 256) int8
    maxdist: torch.Tensor,  # (S,)
    mindist: torch.Tensor,  # (S,)
    valid: torch.Tensor,  # (S,) bool — invalid rows go to the dump slot
) -> MapArrays:
    """Insert/overwrite landmarks in place."""
    dump = m.lm_pos.shape[0] - 1
    s = torch.where(valid, slots, dump)
    m.lm_pos[s] = pos
    m.lm_desc[s] = desc
    m.lm_maxdist[s] = maxdist
    m.lm_mindist[s] = mindist
    m.lm_valid[s] = valid
    m.lm_valid[dump] = False
    m.lm_bitsum[s] = desc.to(torch.int16)
    m.lm_nobs[s] = 1
    return m


def refresh_descriptors(
    m: MapArrays, ids: torch.Tensor, desc: torch.Tensor, majority: bool = True
) -> MapArrays:
    """Fold one new view's descriptor per landmark into its representative
    descriptor (MapPoint::calcDescriptor analog): per-bit majority of the
    observation set (ties to the newest bit), or the newest view outright.
    ids < 0 are dropped; valid ids are distinct."""
    dump = m.lm_pos.shape[0] - 1
    ok = ids >= 0
    s = torch.where(ok, ids, dump)
    d16 = torch.where(ok[:, None], desc.to(torch.int16), 0)
    bs = m.lm_bitsum[s] + d16
    m.lm_bitsum[s] = bs
    m.lm_nobs[s] = m.lm_nobs[s] + ok.to(torch.int16)
    if majority:
        new_desc = torch.where(bs > 0, 1, torch.where(bs < 0, -1, desc.to(torch.int16)))
        new_desc = new_desc.to(torch.int8)
    else:
        new_desc = desc
    m.lm_desc[s] = new_desc
    return m


def scatter_keyframe(
    m: MapArrays,
    kf_slot: int,
    pose: torch.Tensor,  # (4, 4)
    obs_uv: torch.Tensor,  # (K, 3)
    obs_oct: torch.Tensor,  # (K,)
    obs_stereo: torch.Tensor,  # (K,)
    obs_lm: torch.Tensor,  # (K,) landmark slot or -1
    obs_desc: torch.Tensor,  # (K, 8) packed
    obs_valid: torch.Tensor,  # (K,) bool
    obs_r_uv: torch.Tensor,  # (Kr, 2)
    obs_r_oct: torch.Tensor,  # (Kr,)
    obs_r_lm: torch.Tensor,  # (Kr,)
) -> MapArrays:
    m.kf_pose[kf_slot] = pose
    m.kf_valid[kf_slot] = True
    m.obs_uv[kf_slot] = obs_uv
    m.obs_oct[kf_slot] = obs_oct
    m.obs_stereo[kf_slot] = obs_stereo
    m.obs_lm[kf_slot] = obs_lm
    m.obs_desc[kf_slot] = obs_desc
    m.obs_valid[kf_slot] = obs_valid
    m.obs_r_uv[kf_slot] = obs_r_uv
    m.obs_r_oct[kf_slot] = obs_r_oct
    m.obs_r_lm[kf_slot] = obs_r_lm
    return m


def writeback_ba(
    m: MapArrays,
    kf_slots: torch.Tensor,  # (Wb,) keyframe slots (padding rows invalid)
    kf_valid: torch.Tensor,  # (Wb,) bool
    new_poses: torch.Tensor,  # (Wb, 4, 4)
    lm_slots: torch.Tensor,  # (Lb,)
    lm_keep: torch.Tensor,  # (Lb,) bool landmarks to write (others untouched)
    new_pts: torch.Tensor,  # (Lb, 3)
    obs_kill_kf: torch.Tensor,  # (Ob,) kf slot of left observations to sever
    obs_kill_key: torch.Tensor,  # (Ob,) key slot
    obs_kill: torch.Tensor,  # (Ob,) bool
    obs_r_kill_kf: torch.Tensor,  # (Obr,) right-only observations to sever
    obs_r_kill_key: torch.Tensor,  # (Obr,)
    obs_r_kill: torch.Tensor,  # (Obr,) bool
) -> MapArrays:
    """Apply local-BA results in place (reference write-back,
    src/OptimizationBA.cpp:875-938): optimized KF poses and landmark
    positions, severed wrong matches, and the severed left observations'
    descriptors taken out of the landmarks' majority bit-sums.

    The JAX version drops invalid rows (``mode="drop"``). Here: invalid
    keyframe rows repeat the first valid row's slot AND value (the last KF
    slot is a real keyframe once capacity fills, so it cannot serve as a
    scratch row; identical duplicate writes leave no order to decide);
    invalid landmark rows go to the dump slot P-1; severed cells are set
    by an exact integer accumulate (add -1 - old id), which is order-free
    with duplicate non-kill rows aliasing a cell. Descriptor bit-sums are
    summed with an accumulating scatter, so two killed rows of one
    landmark both count."""
    dump = m.lm_pos.shape[0] - 1
    first = torch.argmax(kf_valid.to(torch.uint8))[None]  # 1-d: no host sync
    ks = torch.where(kf_valid, kf_slots, kf_slots[first])
    fill = torch.where(kf_valid.any(), new_poses[first], m.kf_pose[kf_slots[first]])
    m.kf_pose[ks] = torch.where(kf_valid[:, None, None], new_poses, fill)
    m.lm_pos[torch.where(lm_keep, lm_slots, dump)] = new_pts

    # pre-sever landmark and descriptor of each killed left row (read
    # before the cells are written)
    kf_s = torch.where(obs_kill, obs_kill_kf, 0)
    key_s = torch.where(obs_kill, obs_kill_key, 0)
    lm_of = m.obs_lm[kf_s, key_s]
    d16 = hamming.unpack_signed(m.obs_desc[kf_s, key_s]).to(torch.int16)
    m.obs_lm.index_put_((kf_s, key_s), torch.where(obs_kill, -1 - lm_of, 0), accumulate=True)
    rkf_s = torch.where(obs_r_kill, obs_r_kill_kf, 0)
    rkey_s = torch.where(obs_r_kill, obs_r_kill_key, 0)
    r_old = m.obs_r_lm[rkf_s, rkey_s]
    m.obs_r_lm.index_put_((rkf_s, rkey_s), torch.where(obs_r_kill, -1 - r_old, 0), accumulate=True)

    # majority upkeep: a severed observation leaves the landmark's set
    # (right-camera observations carry no descriptor)
    hit = obs_kill & (lm_of >= 0)
    tgt = torch.where(hit, lm_of, dump)
    m.lm_bitsum.index_put_((tgt,), torch.where(hit[:, None], -d16, 0), accumulate=True)
    m.lm_nobs.index_put_((tgt,), -hit.to(torch.int16), accumulate=True)
    bs = m.lm_bitsum[tgt]
    maj = torch.where(bs > 0, 1, torch.where(bs < 0, -1, m.lm_desc[tgt].to(torch.int16)))
    m.lm_desc[tgt] = maj.to(torch.int8)
    return m


def gather_active(m: MapArrays, ids: torch.Tensor) -> dict:
    """Compact (A,) landmark slots (padded with -1) -> active-set arrays
    (copies) for tracking."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0)
    return {
        "ids": ids,
        "pos": m.lm_pos[safe],
        "desc": m.lm_desc[safe],
        "maxdist": m.lm_maxdist[safe],
        "mindist": m.lm_mindist[safe],
        "valid": valid & m.lm_valid[safe],
    }


class WorldMap:
    """Host-side facade: slot allocation, covisibility, host mirrors. The
    device arrays live in ``self.arrays`` on ``device`` (the GPU unless
    the caller asks for the CPU)."""

    def __init__(
        self,
        lm_capacity=1 << 16,
        kf_capacity=512,
        keys_per_kf=2048,
        right_obs_per_kf=256,
        *,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.arrays = make_map(
            lm_capacity, kf_capacity, keys_per_kf, right_obs_per_kf, device=self.device
        )
        self.lm_capacity = lm_capacity
        self.kf_capacity = kf_capacity
        self.keys_per_kf = keys_per_kf
        self.right_obs_per_kf = right_obs_per_kf
        self.n_landmarks = 0
        self.n_keyframes = 0
        # host mirrors
        self.kf_obs_lm = np.full((kf_capacity, keys_per_kf), -1, np.int64)
        self.kf_obs_r_lm = np.full((kf_capacity, right_obs_per_kf), -1, np.int64)
        self.kf_frame_idx = np.full(kf_capacity, -1, np.int64)
        self.kf_poses_host = np.tile(np.eye(4, dtype=np.float32), (kf_capacity, 1, 1))

    def alloc_landmarks(self, count: int) -> np.ndarray:
        """Reserve `count` slots; grows the landmark axis when full."""
        start = self.n_landmarks
        if start + count > self.lm_capacity - 1:  # P-1 is the dump slot
            self.grow_landmarks(start + count + 1)
        self.n_landmarks = start + count
        return np.arange(start, start + count, dtype=np.int64)

    def release_landmarks(self, slots: np.ndarray):
        """Return an unused tail of slots while it is still the topmost
        allocation."""
        if len(slots) == 0:
            return
        if slots[-1] == self.n_landmarks - 1 and slots[0] + len(slots) == self.n_landmarks:
            self.n_landmarks = int(slots[0])

    def alloc_keyframe(self, frame_idx: int) -> int:
        slot = self.n_keyframes
        if slot >= self.kf_capacity:
            self.grow_keyframes(slot + 1)
        self.n_keyframes += 1
        self.kf_frame_idx[slot] = frame_idx
        return slot

    def grow_landmarks(self, min_capacity: int):
        """Double the landmark axis until it holds `min_capacity`. The old
        dump slot becomes an ordinary slot (never valid; overwritten when
        allocated)."""
        if min_capacity <= self.lm_capacity:
            return
        P_new = self.lm_capacity
        while P_new < min_capacity:
            P_new *= 2
        add = P_new - self.lm_capacity
        m = self.arrays
        ext = _lm_fields(add, self.device)
        self.arrays = dataclasses.replace(
            m, **{k: torch.cat([getattr(m, k), v]) for k, v in ext.items()}
        )
        self.lm_capacity = P_new

    def grow_keyframes(self, min_capacity: int):
        """Double the keyframe axis until it holds `min_capacity`."""
        if min_capacity <= self.kf_capacity:
            return
        W_new = self.kf_capacity
        while W_new < min_capacity:
            W_new *= 2
        add = W_new - self.kf_capacity
        K, Kr = self.keys_per_kf, self.right_obs_per_kf
        m = self.arrays
        ext = _kf_fields(add, K, Kr, self.device)
        self.arrays = dataclasses.replace(
            m, **{k: torch.cat([getattr(m, k), v]) for k, v in ext.items()}
        )
        self.kf_obs_lm = np.concatenate([self.kf_obs_lm, np.full((add, K), -1, np.int64)])
        self.kf_obs_r_lm = np.concatenate(
            [self.kf_obs_r_lm, np.full((add, Kr), -1, np.int64)]
        )
        self.kf_frame_idx = np.concatenate([self.kf_frame_idx, np.full(add, -1, np.int64)])
        self.kf_poses_host = np.concatenate(
            [self.kf_poses_host, np.tile(np.eye(4, dtype=np.float32), (add, 1, 1))]
        )
        self.kf_capacity = W_new

    def covisible_kfs(self, kf_slot: int, max_n: int = 10, min_weight: int = 15) -> np.ndarray:
        """Covisibility neighbors by shared-landmark count (reference
        KeyFrame::calcConnections), sorted by weight, excluding self."""
        weights = self.covis_weights(kf_slot)
        if weights is None:
            return np.zeros((0,), np.int64)
        others = np.arange(self.n_keyframes)
        cand = others[(weights >= min_weight) & (others != kf_slot)]
        cand = cand[np.argsort(-weights[cand])]
        if len(cand) == 0:
            prev = kf_slot - 1
            return np.array([prev], np.int64) if prev >= 0 else np.zeros((0,), np.int64)
        return cand[:max_n]

    def covis_weights(self, kf_slot: int) -> np.ndarray | None:
        """Shared-landmark counts of every KF against `kf_slot`."""
        ids = self.kf_obs_lm[kf_slot]
        ids = ids[ids >= 0]
        if len(ids) == 0 or self.n_keyframes <= 1:
            return None
        tbl = self.kf_obs_lm[: self.n_keyframes]
        shared = np.isin(tbl, ids) & (tbl >= 0)
        return shared.sum(axis=1).astype(np.int64)

    def observers_of(self, lm_ids: np.ndarray, exclude: np.ndarray, max_n: int) -> np.ndarray:
        """KF slots outside `exclude` that observe any of `lm_ids`, by
        observation count descending (stable), at most `max_n`: the gauge
        anchors of local BA (reference src/OptimizationBA.cpp:445-516)."""
        if len(lm_ids) == 0 or self.n_keyframes == 0:
            return np.zeros((0,), np.int64)
        tbl = self.kf_obs_lm[: self.n_keyframes]
        counts = (np.isin(tbl, lm_ids) & (tbl >= 0)).sum(axis=1)
        counts[np.asarray(exclude, np.int64)] = 0
        cand = np.nonzero(counts > 0)[0]
        cand = cand[np.argsort(-counts[cand], kind="stable")]
        return cand[:max_n].astype(np.int64)
