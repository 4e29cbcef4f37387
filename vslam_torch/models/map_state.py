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
