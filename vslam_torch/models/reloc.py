"""Relocalization: descriptor retrieval against every keyframe (port of
vslam_tpu/models/reloc.py; the reference has none).

When the tracker has refused `reseed_after` consecutive solves, the current
frame's descriptors are matched against the observation tables of every
keyframe (one masked Hamming sweep, a +-1 matmul per keyframe chunk), the
best-voted keyframe is verified by a PnP-style motion-only solve, and its
pose re-anchors tracking on the old map. Everything but the vote argmax and
the accept decision stays on the map's device.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.ops import hamming, lm

RETRIEVAL_DESC_THR = 50.0  # Hamming distance counted as a vote
MIN_VOTES = 50  # matched keys needed to accept a retrieved keyframe
MIN_INLIER_FRAC = 0.25  # verified-inlier fraction of ratio-tested matches
VOTE_CHUNK = 16  # keyframes per matmul: bounds the (chunk, N, K) distances


def keyframe_votes(
    obs_desc: torch.Tensor,  # (W, K, 8) packed per-KF key descriptors
    obs_valid: torch.Tensor,  # (W, K) bool
    kf_valid: torch.Tensor,  # (W,) bool
    frame_desc: torch.Tensor,  # (N, 256) int8 +-1 current-frame descriptors
    frame_valid: torch.Tensor,  # (N,) bool
) -> torch.Tensor:
    """(W,) int64 votes: how many current-frame keys have a Hamming match
    < RETRIEVAL_DESC_THR among keyframe w's keys. The keyframes go in
    chunks of VOTE_CHUNK (the JAX version's lax.map), so the (N, W*K)
    distance matrix never materializes. The +-1 dot products are exact
    integers in float32."""
    fd = frame_desc.to(torch.float32)
    n_bits = frame_desc.shape[1]
    out = []
    for c in range(0, obs_desc.shape[0], VOTE_CHUNK):
        kd = hamming.unpack_signed(obs_desc[c : c + VOTE_CHUNK]).to(torch.float32)  # (w, K, 256)
        d = (n_bits - fd @ kd.transpose(1, 2)) * 0.5  # (w, N, K)
        ok = frame_valid[None, :, None] & obs_valid[c : c + VOTE_CHUNK, None, :]
        best = torch.amin(torch.where(ok, d, 1e9), dim=2)  # (w, N)
        votes = torch.sum(best < RETRIEVAL_DESC_THR, dim=1)
        out.append(torch.where(kf_valid[c : c + VOTE_CHUNK], votes, 0))
    return torch.cat(out)


def _verify_candidate(m, kf_slot: int, keys_xy, keys_desc, keys_valid, K, baseline):
    """PnP-style verification of a retrieved keyframe: the frame's keys
    matched to the keyframe's landmark-bearing keys by descriptor, with a
    ratio test whose second-best lies outside 3 px of the best (multi-octave
    duplicates of one corner would veto true matches), then one
    single-start motion-only LM from the keyframe's pose. `K` (3, 3) may be
    host data: the solve takes it as float32 on the keys' device. Returns
    (T_opt (4, 4), n_inliers, n_matches) as tensors."""
    K = torch.as_tensor(K, dtype=torch.float32, device=keys_xy.device)
    kd = hamming.unpack_signed(m.obs_desc[kf_slot])
    kv = m.obs_valid[kf_slot] & (m.obs_lm[kf_slot] >= 0)
    d = hamming.hamming_matrix(keys_desc, kd, keys_valid, kv)
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    kxy = m.obs_uv[kf_slot][:, :2]
    best_xy = kxy[torch.clamp(best, 0, kxy.shape[0] - 1)]
    near = torch.sum((kxy[None, :, :] - best_xy[:, None, :]) ** 2, dim=-1) < 9.0
    second_d = torch.amin(torch.where(near, hamming.INVALID, d), dim=1)
    match = (best_d <= RETRIEVAL_DESC_THR) & (best_d <= 0.8 * second_d)
    lm_ids = m.obs_lm[kf_slot][torch.where(match, best, 0)]
    P = m.lm_pos.shape[0]
    safe_lm = torch.clamp(lm_ids, 0, P - 1)
    match = match & (lm_ids >= 0) & m.lm_valid[safe_lm]
    N = keys_xy.shape[0]
    obs = torch.cat([keys_xy[:, :2], keys_xy.new_full((N, 1), -1.0)], dim=-1)
    none = torch.zeros((N,), dtype=torch.bool, device=keys_xy.device)
    T_opt, _, inl, _, _ = lm.motion_only_ba(
        m.kf_pose[kf_slot][None], m.lm_pos[safe_lm], obs, torch.ones_like(keys_xy[:, 0]),
        none, none, match, K, baseline, max_iters=50,
    )
    return T_opt[0], torch.sum(inl[0]), torch.sum(match)


def retrieve(world, keys, n_keyframes: int, K, baseline=0.0, min_inliers: int = 25):
    """Best keyframe slot for the current frame's keys (extract.Keys of one
    image), geometrically verified. Returns (slot, votes, T_opt) with slot
    -1 (and T_opt None) when no keyframe clears MIN_VOTES, or when the
    verification finds fewer than `min_inliers` inliers, fewer than
    MIN_INLIER_FRAC of its matches, or a non-finite pose."""
    # the live keyframe prefix on the JAX version's doubling menu of sizes
    Wc = 16
    while Wc < n_keyframes and Wc < world.kf_capacity:
        Wc *= 2
    Wc = min(Wc, world.kf_capacity)
    m = world.arrays
    votes = np.zeros(max(world.kf_capacity, Wc), np.int64)
    votes[:Wc] = keyframe_votes(
        m.obs_desc[:Wc], m.obs_valid[:Wc], m.kf_valid[:Wc], keys.desc, keys.valid
    ).cpu().numpy()
    votes[n_keyframes:] = 0
    best = int(np.argmax(votes))  # the first maximum, as numpy's
    if votes[best] < MIN_VOTES:
        return -1, int(votes[best]), None
    K_t = torch.as_tensor(K, dtype=torch.float32).to(keys.xy.device)
    T_opt, n_inl, n_match = _verify_candidate(
        m, best, keys.xy, keys.desc, keys.valid, K_t, float(baseline)
    )
    T_opt = T_opt.cpu().numpy()
    n_inl, n_match = int(n_inl), int(n_match)
    if n_inl < min_inliers or n_inl < MIN_INLIER_FRAC * n_match or not np.isfinite(T_opt).all():
        return -1, int(votes[best]), None
    return best, int(votes[best]), T_opt
