"""Loop closure: detection, landmark merge, pose-graph correction (port of
vslam_tpu/models/loop_closure.py; the reference's loop-closure state is
vestigial, include/Map.h:122-127).

1. DETECT: the new keyframe's stored descriptors sweep every keyframe's
   table (models/reloc.keyframe_votes), the `min_gap` keyframes on either
   side and the covisible set excluded; the peak must be backed by a
   neighbour's votes.
2. VERIFY: the candidate's landmark-bearing keys matched to the new
   keyframe's, then a motion-only LM from the old keyframe's pose
   (reloc._verify_candidate): the new camera's pose in the old part of the
   map, the loop edge's measurement.
3. CORRECT: a pose graph over all keyframes (models/pose_graph): the
   odometry chain from the current estimates plus the loop edge (and up
   to 3 earlier accepted ones); Sim(3) in mono, where scale drifts too.
4. MERGE + RE-ANCHOR: duplicate landmarks merge old <- new by an id remap
   over the observation tables, and every landmark moves with its first
   observing keyframe's correction.

Everything but the vote argmax, the gates and the host mirrors stays on
the map's device. Two consecutive agreeing detections are needed before a
closure is applied, and a closure must merge MIN_MERGED duplicate pairs.

The JAX closer takes the map's ``update_lock``; the port's WorldMap has
none. Both facades run the closer on the main thread right after a BA
result is consumed, when no BA is in flight, so nothing contends for the
map: :meth:`LoopCloser.close` asserts it when it is given the facade.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.geometry import sim3
from vslam_torch.models import map_state, pose_graph, reloc
from vslam_torch.ops import hamming
from vslam_torch.utils import trajectory

MIN_GAP = 12  # keyframes that must separate a loop pair (else it is covisibility)
ODO_WEIGHT = 100.0  # 1/sigma of the chain edges (reference sigma 0.01)
LOOP_WEIGHT = 100.0
# duplicate-landmark pairs a closure must find: a real revisit re-observes
# old structure, so dozens of its new landmarks are duplicates of old ones;
# an aliased verification finds few (vslam_tpu loop_closure.py:113-120: on
# the bench circuit genuine closures merged 95-152 pairs, one bad edge 21)
MIN_MERGED = 30
LOOP_EDGES = 4  # loop-edge slots: the new edge + up to 3 accepted ones
DENSE_MAX_KF = 128  # above this many keyframes the chain solver is used


def _apply_correction(
    m: map_state.MapArrays,
    new_poses: torch.Tensor,  # (Wg, 4, 4) pose-graph output (padded)
    kf_valid: torch.Tensor,  # (Wg,) bool
    delta: torch.Tensor,  # (Wg, 4, 4) T_new @ inv(T_old) per keyframe
    lm_anchor: torch.Tensor,  # (P,) int64 first observing KF (or 0)
    lm_touch: torch.Tensor,  # (P,) bool landmarks to move
    remap: torch.Tensor,  # (P,) int64 landmark id remap (identity + merges)
    merged_away: torch.Tensor,  # (P,) bool ids merged into another id
) -> map_state.MapArrays:
    """One write-back, in place: keyframe poses, moved landmarks, the
    observation tables' id remap, merged slots invalidated and their
    descriptor sums folded into their targets.

    The JAX version drops invalid rows by an out-of-range index
    (``mode="drop"``); here they are masked. Nothing that can collide is
    scattered except the integer sums (exact in any order): each target's
    majority descriptor is recomputed from its own slot's sum."""
    W, Wg = m.kf_pose.shape[0], new_poses.shape[0]
    k = min(W, Wg)
    kf_pose = torch.where(kf_valid[:k, None, None], new_poses[:k], m.kf_pose[:k])

    d = delta[torch.clamp(lm_anchor, 0, Wg - 1)]  # (P, 4, 4)
    moved = (d[:, :3, :3] @ m.lm_pos[:, :, None])[:, :, 0] + d[:, :3, 3]
    lm_pos = torch.where(lm_touch[:, None], moved, m.lm_pos)

    def remapped(ids):
        return torch.where(ids >= 0, remap[torch.clamp(ids, min=0)], -1)

    obs_lm, obs_r_lm = remapped(m.obs_lm), remapped(m.obs_r_lm)

    # each merged-away landmark's descriptor accumulator goes to its target
    # (writeback_ba subtracts a killed observation's descriptor from the
    # landmark it names: the merged observations now name the target)
    P = m.lm_pos.shape[0]
    tgt = torch.where(merged_away, remap, P - 1)  # zero contributions elsewhere
    lm_bitsum = m.lm_bitsum.clone().index_put_(
        (tgt,), torch.where(merged_away[:, None], m.lm_bitsum, 0), accumulate=True
    )
    lm_nobs = m.lm_nobs.clone().index_put_(
        (tgt,), torch.where(merged_away, m.lm_nobs, 0), accumulate=True
    )
    is_tgt = torch.zeros((P + 1,), dtype=torch.bool, device=remap.device)
    is_tgt.index_fill_(0, torch.where(merged_away, remap, P), True)
    maj = torch.where(lm_bitsum > 0, 1, torch.where(lm_bitsum < 0, -1, m.lm_desc.to(torch.int16)))
    lm_desc = torch.where(is_tgt[:P, None], maj.to(torch.int8), m.lm_desc)

    m.kf_pose[:k] = kf_pose
    m.lm_pos.copy_(lm_pos)
    m.obs_lm.copy_(obs_lm)
    m.obs_r_lm.copy_(obs_r_lm)
    m.lm_valid &= ~merged_away
    m.lm_bitsum.copy_(lm_bitsum)
    m.lm_nobs.copy_(lm_nobs)
    m.lm_desc.copy_(lm_desc)
    return m


class LoopCloser:
    def __init__(self, world: map_state.WorldMap, K, baseline, min_votes: int = 60,
                 min_inliers: int = 30, min_gap: int = MIN_GAP, system=None):
        """`system`: the facade that owns the closer; when given, a closure
        asserts that no async BA is in flight (see the module docstring)."""
        self.world = world
        self.K = torch.as_tensor(np.asarray(K, np.float32)).to(world.device)
        self.baseline = float(baseline)
        self.min_votes = min_votes
        self.min_inliers = min_inliers
        self.min_gap = min_gap
        self.system = system
        self.closures = 0
        self._last_cand = None  # (kf_slot, old_kf) of the last detection
        # detection stays off until this keyframe slot after an applied
        # closure (4 keyframes: the next ones would re-derive the same
        # edge; a longer cooldown left the bench circuit's last 0.2 lap
        # uncorrected, vslam_tpu loop_closure.py:132-141)
        self.cooldown_kfs = 4
        self._cooldown_until = -1
        # accepted loop-edge measurements: each later graph includes up to
        # 3 of them, so a new closure cannot re-open an old seam
        self._edges: list[tuple[int, int, np.ndarray]] = []

    # ------------------------------------------------------------------
    def detect(self, kf_slot: int) -> tuple[int, np.ndarray | None]:
        """Candidate old keyframe for a loop at `kf_slot`, with the verified
        pose of kf_slot's camera in the old map region. (-1, None) if
        none."""
        w = self.world
        n = w.n_keyframes
        if n < self.min_gap + 2 or kf_slot < self.min_gap:
            return -1, None
        if kf_slot < self._cooldown_until:
            return -1, None
        m = w.arrays
        desc = hamming.unpack_signed(m.obs_desc[kf_slot])
        valid = m.obs_valid[kf_slot]
        xy = m.obs_uv[kf_slot][:, :2]
        # the live keyframe prefix on a doubling menu of sizes
        Wc = 16
        while Wc < n and Wc < w.kf_capacity:
            Wc *= 2
        Wc = min(Wc, w.kf_capacity)
        votes = np.zeros(max(w.kf_capacity, Wc), np.int64)
        votes[:Wc] = reloc.keyframe_votes(
            m.obs_desc[:Wc], m.obs_valid[:Wc], m.kf_valid[:Wc], desc, valid
        ).cpu().numpy()
        votes[n:] = 0
        # exclusions: the min_gap keyframes on both sides (detection runs
        # after the async consume, so newer keyframes can exist) and every
        # keyframe covisible at the reference's weight (KeyFrame.cpp:133)
        votes_raw = votes.copy()
        votes[max(0, kf_slot - self.min_gap) : kf_slot + self.min_gap + 1] = 0
        votes[w.covisible_kfs(kf_slot, max_n=n, min_weight=15)] = 0
        best = int(np.argmax(votes))  # the first maximum, as numpy's
        if votes[best] < self.min_votes:
            return -1, None
        # contiguity support on the raw votes: a revisit re-observes a run
        # of old keyframes, an aliasing spike is solitary
        lo, hi = max(0, best - 2), min(n, best + 3)
        neighbors = np.delete(votes_raw[lo:hi], best - lo)
        if (neighbors >= self.min_votes // 2).sum() < 1:
            return -1, None
        T_opt, n_inl, n_match = reloc._verify_candidate(
            m, best, xy, desc, valid, self.K, self.baseline
        )
        n_inl, n_match = int(n_inl), int(n_match)
        if n_inl < self.min_inliers or n_inl < reloc.MIN_INLIER_FRAC * n_match:
            return -1, None
        T_opt = T_opt.cpu().numpy()
        if not np.isfinite(T_opt).all():
            return -1, None
        return best, T_opt

    # ------------------------------------------------------------------
    def close(self, kf_slot: int, old_kf: int, T_loop: np.ndarray) -> dict | None:
        """Apply the closure: the pose graph over all keyframes with the
        loop edge inv(pose_old) @ T_loop between (old_kf, kf_slot), the
        landmarks moved with their anchor keyframes, the duplicate merge.
        Returns re-anchoring info ({kf_slot, old_pose, new_pose, ...}) for
        the tracker, or None when the merge gate or a non-finite graph
        refuses the closure."""
        if self.system is not None:
            assert self.system._pending_ba is None, "loop closure with a BA in flight"
        w = self.world
        dev = w.device
        n = w.n_keyframes
        mono = self.baseline == 0.0
        old_last = w.kf_poses_host[kf_slot].copy()

        # structural gate, before any map mutation
        pairs = self._merge_pairs(kf_slot, old_kf)
        if len(pairs) < MIN_MERGED:
            print(
                f"[loop_closure] REJECT edge {old_kf}->{kf_slot}: only "
                f"{len(pairs)} duplicate landmarks (< {MIN_MERGED}) — aliased verification"
            )
            return None

        # ---- pose graph ----
        Wg = 1
        while Wg < n:
            Wg *= 2
        poses = np.tile(np.eye(4, dtype=np.float32), (Wg, 1, 1))
        poses[:n] = w.kf_poses_host[:n]
        valid = np.zeros(Wg, bool)
        valid[:n] = True
        inv_poses = np.linalg.inv(poses[:n])
        chain_rel = np.tile(np.eye(4, dtype=np.float32), (max(Wg - 1, 1), 1, 1))
        chain_rel[: n - 1] = np.einsum("kij,kjl->kil", inv_poses[:-1], poses[1:n])
        chain_w = np.zeros(max(Wg - 1, 1), np.float32)
        chain_w[: n - 1] = ODO_WEIGHT
        rel_loop = inv_poses[old_kf] @ T_loop

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

        poses_t = t(poses)
        if mono:
            # Sim(3) graph (Strasdat / ORB-SLAM): the loop edge's relative
            # scale from a scaled Umeyama fit of the duplicate pairs;
            # landmarks take the full Sim(3) delta, poses its SE(3) part
            lm_pos = w.arrays.lm_pos.cpu().numpy()
            new_ids = np.asarray([a for a, _ in pairs])
            old_ids = np.asarray([b for _, b in pairs])
            R_c, t_c, s_c = trajectory.umeyama_alignment(
                lm_pos[new_ids], lm_pos[old_ids], with_scale=True
            )
            S_corr = np.eye(4, dtype=np.float32)
            S_corr[:3, :3] = (s_c * R_c).astype(np.float32)
            S_corr[:3, 3] = t_c.astype(np.float32)
            # measured loop edge Z = S_o^-1 S_corr S_n (at the optimum
            # S_n' = S_corr S_n with S_o held)
            Z_loop = (np.linalg.inv(poses[old_kf]) @ S_corr @ poses[kf_slot]).astype(np.float32)
            loop = self._loop_edge_arrays(old_kf, kf_slot, Z_loop)
            S_opt, err = pose_graph.optimize_sim3_chain(
                poses_t, t(valid), t(chain_rel), t(chain_w), *(t(a) for a in loop), iters=30
            )
            new_poses = sim3.to_se3(S_opt)
            delta = S_opt @ sim3.inverse(poses_t)
            edge = Z_loop
        else:
            loop = self._loop_edge_arrays(old_kf, kf_slot, rel_loop)
            if n > DENSE_MAX_KF:
                new_poses, err = pose_graph.optimize_chain(
                    poses_t, t(valid), t(chain_rel), t(chain_w), *(t(a) for a in loop), iters=25
                )
            else:
                li, lj, lrel, lw = loop
                E = Wg + len(li)  # n - 1 chain edges + loop edges, padded
                ei = np.zeros(E, np.int64)
                ej = np.zeros(E, np.int64)
                rel = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
                ew = np.zeros(E, np.float32)
                ei[: n - 1], ej[: n - 1] = np.arange(n - 1), np.arange(1, n)
                rel[: n - 1] = chain_rel[: n - 1]
                ew[: n - 1] = ODO_WEIGHT
                s = slice(n - 1, n - 1 + len(li))
                ei[s], ej[s], rel[s], ew[s] = li, lj, lrel, lw
                new_poses, err = pose_graph.optimize(
                    poses_t, t(valid), t(ei), t(ej), t(rel), t(ew), iters=25
                )
            edge = rel_loop
        new_poses_np = new_poses.cpu().numpy()
        if not mono:
            delta = t(np.einsum("kij,kjl->kil", new_poses_np, np.linalg.inv(poses)))
        err = float(err)
        if not (np.isfinite(err) and np.isfinite(new_poses_np[:n]).all()):
            # a diverged graph must never reach the map
            return None

        # ---- landmark anchors: the first observing keyframe, left and
        # right tables (a right-only landmark must move with its keyframe)
        P = w.lm_capacity
        anchor = np.full(P, -1, np.int64)
        for k in range(n - 1, -1, -1):  # descending: the earliest keyframe wins
            ids = w.kf_obs_lm[k]
            anchor[ids[ids >= 0]] = k
            ids_r = w.kf_obs_r_lm[k]
            anchor[ids_r[ids_r >= 0]] = k
        touched = anchor >= 0

        # ---- duplicate merge (the old id wins) ----
        remap = np.arange(P, dtype=np.int64)
        merged = np.zeros(P, bool)
        for new_id, old_id in pairs:
            if new_id != old_id and not merged[old_id]:
                remap[new_id] = old_id
                merged[new_id] = True

        _apply_correction(
            w.arrays, new_poses, t(valid), delta, t(np.maximum(anchor, 0)),
            t(touched), t(remap), t(merged),
        )
        w.kf_poses_host[:n] = new_poses_np[:n]
        live = w.kf_obs_lm >= 0
        w.kf_obs_lm[live] = remap[w.kf_obs_lm[live]]
        live_r = w.kf_obs_r_lm >= 0
        w.kf_obs_r_lm[live_r] = remap[w.kf_obs_r_lm[live_r]]
        self.closures += 1
        # persist the accepted edge (Sim(3)-valued in mono) for later graphs
        self._edges.append((old_kf, kf_slot, np.array(edge, np.float32)))
        return {
            "kf_slot": kf_slot,
            "old_kf": old_kf,
            "old_pose": old_last,
            "new_pose": w.kf_poses_host[kf_slot].copy(),
            "pose_graph_error": err,
            "n_merged": int(merged.sum()),
            "path": "sim3" if mono else ("chain" if n > DENSE_MAX_KF else "dense"),
        }

    def _loop_edge_arrays(self, old_kf: int, kf_slot: int, rel: np.ndarray):
        """Padded LOOP_EDGES-slot loop-edge arrays: the new edge in slot 0
        plus up to 3 accepted ones (close() persists the new edge only once
        it is written back)."""
        L = LOOP_EDGES
        li = np.zeros(L, np.int64)
        lj = np.zeros(L, np.int64)
        lrel = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        lw = np.zeros(L, np.float32)
        li[0], lj[0], lrel[0], lw[0] = old_kf, kf_slot, rel, LOOP_WEIGHT
        for k, (i, j, z) in enumerate(self._edges[-(L - 1):], start=1):
            li[k], lj[k], lrel[k], lw[k] = i, j, z, LOOP_WEIGHT
        return li, lj, lrel, lw

    def _merge_pairs(self, kf_new: int, kf_old: int) -> list[tuple[int, int]]:
        """(new_lm, old_lm) pairs: the two keyframes' keys matched by
        descriptor where both carry landmarks (on the host, as JAX's)."""
        w = self.world
        m = w.arrays
        dn = hamming.unpack_signed_np(m.obs_desc[kf_new].cpu().numpy()).astype(np.int32)
        do = hamming.unpack_signed_np(m.obs_desc[kf_old].cpu().numpy()).astype(np.int32)
        vn = m.obs_valid[kf_new].cpu().numpy()
        vo = m.obs_valid[kf_old].cpu().numpy()
        ln = w.kf_obs_lm[kf_new]
        lo = w.kf_obs_lm[kf_old]
        d = (dn.shape[1] - dn @ do.T) * 0.5  # Hamming
        d[~vn | (ln < 0)] = 1e9
        d[:, ~vo | (lo < 0)] = 1e9
        best = np.argmin(d, axis=1)
        bd = d[np.arange(len(best)), best]
        ok = bd <= reloc.RETRIEVAL_DESC_THR
        return [
            (int(ln[i]), int(lo[best[i]]))
            for i in np.nonzero(ok)[0]
            if ln[i] >= 0 and lo[best[i]] >= 0
        ]

    # ------------------------------------------------------------------
    def try_close(self, kf_slot: int) -> dict | None:
        """Detect at `kf_slot`; apply a closure only when the previous
        detection (at most 3 keyframes back) retrieved the same old region
        (within 4 keyframes), the consecutive-detection rule of ORB-SLAM's
        detector."""
        old_kf, T_loop = self.detect(kf_slot)
        if old_kf < 0:
            return None
        prev = self._last_cand
        self._last_cand = (kf_slot, old_kf)
        if prev is None or kf_slot - prev[0] > 3 or abs(old_kf - prev[1]) > 4:
            return None
        r = self.close(kf_slot, old_kf, T_loop)
        if r is not None:
            self._last_cand = None  # do not chain off a just-closed loop
            self._cooldown_until = kf_slot + self.cooldown_kfs
        return r
