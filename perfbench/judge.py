"""The plain reference and the comparison that decides ``correct``.

The system estimates a trajectory and a map from images; the benchmark
made those images itself, from an exact world (scene.py, drawn from the
seed), so the reference is that world, worked out again in float64
NumPy from the same seed and traffic: the camera's pose at every frame,
and the planar textured patches every landmark must lie on. The
program's outputs are read only to be judged against it:

- every frame of every drive of the window: the pose the tracker
  recorded (``VSlamSystem.trajectory()``), against the true pose relative
  to the drive's first frame (the system's world is its first camera);
- every drive's map as it stands when the drive ends or the window
  closes: each valid keyframe's pose against the true pose of its frame,
  and each valid landmark's distance from the nearest patch of the world;
- the local BA's own guarantee where the last one left each drive's map:
  the landmarks the newest keyframe observes sit where their observations
  put them. No exact world says where a landmark's least-squares position
  lies, so this reference starts from the program's own map (its
  keyframe poses, landmark positions and observations) and re-solves each
  of those landmarks in float64 (``structure_gaps``).

Nothing here imports the program or takes anything it made but those
outputs. The limits are a cell's own (``limits/<cell>.json``); PERF.md
gives the readings each was set from.
"""

from __future__ import annotations

import math

import numpy as np

from perfbench.scene import Rig

PATCH_HALF = 0.175  # half the side of a patch, scene.SyntheticScene.patch_phys / 2


def _relative_truth(poses_c2w: np.ndarray, n: int) -> np.ndarray:
    P = np.asarray(poses_c2w[:n], np.float64)
    return np.linalg.inv(P[0]) @ P


def _rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle (deg) of Ra^T Rb, from atan2 of its skew and symmetric parts
    (exact for small angles, unlike arccos of the trace)."""
    D = np.swapaxes(Ra, -1, -2) @ Rb
    v = np.stack([D[..., 2, 1] - D[..., 1, 2], D[..., 0, 2] - D[..., 2, 0], D[..., 1, 0] - D[..., 0, 1]], -1)
    c = np.trace(D, axis1=-2, axis2=-1) - 1.0
    return np.degrees(np.arctan2(np.linalg.norm(v, axis=-1), c))


def trajectory_errors(traj: np.ndarray, poses_c2w: np.ndarray) -> dict:
    """Per-frame errors of one drive's (F, 4, 4) trajectory: translation
    (m), rotation (deg), and the frame-to-frame translation error (m)."""
    T = np.asarray(traj, np.float64)
    G = _relative_truth(poses_c2w, len(T))
    trans = np.linalg.norm(T[:, :3, 3] - G[:, :3, 3], axis=-1)
    rot = _rot_deg(T[:, :3, :3], G[:, :3, :3])
    dT = np.linalg.inv(T[:-1]) @ T[1:]
    dG = np.linalg.inv(G[:-1]) @ G[1:]
    step = np.linalg.norm(dT[:, :3, 3] - dG[:, :3, 3], axis=-1)
    return {"trans": trans, "rot": rot, "step": step}


def surface_distance(pts: np.ndarray, centres: np.ndarray, block: int = 1024) -> np.ndarray:
    """Each point's distance (m) from the nearest square patch (side
    2 * PATCH_HALF, facing -z, centred at `centres`)."""
    out = np.empty(len(pts))
    for s in range(0, len(pts), block):
        d = pts[s:s + block, None, :] - centres[None, :, :]
        ex = np.maximum(np.abs(d[..., 0]) - PATCH_HALF, 0.0)
        ey = np.maximum(np.abs(d[..., 1]) - PATCH_HALF, 0.0)
        out[s:s + block] = np.sqrt(np.min(ex * ex + ey * ey + d[..., 2] ** 2, axis=1))
    return out


def map_errors(snapshot: dict, scene) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One drive's map against the world: each valid keyframe's position
    error (m), each valid landmark's distance from the nearest patch (m),
    and that distance over the landmark's range from the newest
    keyframe's true camera (at least 0.3 m)."""
    P0 = np.asarray(scene.poses_c2w[0], np.float64)
    G = np.linalg.inv(P0) @ np.asarray(scene.poses_c2w, np.float64)
    kf_pose = np.asarray(snapshot["kf_pose"], np.float64)
    kf_err = np.linalg.norm(kf_pose[:, :3, 3] - G[snapshot["kf_frame"], :3, 3], axis=-1)
    lm = np.asarray(snapshot["lm_pos"], np.float64)
    if not len(lm):
        return kf_err, np.zeros(0), np.zeros(0)
    dist = surface_distance(lm @ P0[:3, :3].T + P0[:3, 3], np.asarray(scene.points_w, np.float64))
    last = G[snapshot["kf_frame"].max(), :3, 3] if len(kf_pose) else np.zeros(3)
    return kf_err, dist, dist / np.maximum(np.linalg.norm(lm - last, axis=-1), 0.3)


def structure_gaps(snapshot: dict, system: dict, iters: int = 20) -> np.ndarray:
    """For every landmark that the keyframe of the drive's last local BA
    observes and that two keyframes or more observe: the share of its
    reprojection cost that a float64 re-solve of its position removes,
    the keyframes' poses held. Only the keyframes the tracker has handed
    to the mapper count (the BA has seen them).
    The cost is the local BA's: pixel errors of the left projection, the
    right image's x on a stereo key and the right projection on a
    right-only key, weighted 1/scale^(2 octave) by the configuration's
    pyramid. A landmark the BA solved reads near 0; one it left where
    triangulation put it reads what the BA would have removed."""
    s = snapshot
    if s["ba_kf"] not in s["kf_slot"]:
        return np.zeros(0)
    rig = Rig.from_system(system)
    fx, fy, cx, cy = rig.K
    b, scale = rig.baseline, float(system["FE"]["imScale"])
    newest = int(np.flatnonzero(s["kf_slot"] == s["ba_kf"])[0])
    seen = np.concatenate([s["obs_lm"][newest], s["obs_r_lm"][newest]])
    target = np.intersect1d(seen[seen >= 0], s["lm_slot"])
    if not len(target):
        return np.zeros(0)
    T_cw = np.linalg.inv(np.asarray(s["kf_pose"], np.float64))
    rows = []  # (keyframe, landmark, [u, v, u_r], octave, stereo, right-only)
    for tbl, uv, octv, right in ((s["obs_lm"], s["obs_uv"], s["obs_oct"], False),
                                 (s["obs_r_lm"], s["obs_r_uv"], s["obs_r_oct"], True)):
        kf, key = np.nonzero(np.isin(tbl, target) & np.isin(s["kf_slot"], s["handed"])[:, None])
        obs = np.zeros((len(kf), 3))
        obs[:, :uv.shape[-1]] = uv[kf, key]
        stereo = np.zeros(len(kf), bool) if right else s["obs_stereo"][kf, key].astype(bool)
        rows.append((kf, np.searchsorted(target, tbl[kf, key]), obs, octv[kf, key], stereo,
                     np.full(len(kf), right)))
    kf, lm, obs, octv, stereo, right = (np.concatenate(c) for c in zip(*rows))
    R, t = T_cw[kf, :3, :3], T_cw[kf, :3, 3]
    w2 = scale ** (-2.0 * octv)
    n = len(target)
    # only landmarks that two keyframes or more observe
    pairs = np.unique(np.stack([lm, kf]), axis=1)
    multi = np.bincount(pairs[0], minlength=n) >= 2
    X = np.asarray(s["lm_pos"], np.float64)[np.searchsorted(s["lm_slot"], target)]
    front = np.einsum("oij,oj->oi", R, X[lm])[:, 2] + t[:, 2] > 0.05
    keep = multi[lm] & front
    kf, lm, obs, stereo, right, R, t, w2 = (a[keep] for a in (kf, lm, obs, stereo, right, R, t, w2))

    def residual(X, jac=False):
        pc = np.einsum("oij,oj->oi", R, X[lm]) + t
        x, y, z = pc[:, 0], pc[:, 1], np.maximum(pc[:, 2], 0.05)
        xl = np.where(right, x - b, x)
        r = np.stack([fx * xl / z + cx - obs[:, 0], fy * y / z + cy - obs[:, 1],
                      np.where(stereo, fx * (x - b) / z + cx - obs[:, 2], 0.0)], -1)
        cost = np.bincount(lm, w2 * np.sum(r * r, -1), minlength=n)
        if not jac:
            return cost
        J = np.zeros((len(lm), 3, 3))  # d residual / d camera point
        J[:, 0, 0], J[:, 0, 2] = fx / z, -fx * xl / z ** 2
        J[:, 1, 1], J[:, 1, 2] = fy / z, -fy * y / z ** 2
        st = stereo.astype(np.float64)
        J[:, 2, 0], J[:, 2, 2] = st * fx / z, -st * fx * (x - b) / z ** 2
        J = J @ R
        H = np.zeros((n, 3, 3))
        g = np.zeros((n, 3))
        np.add.at(H, lm, w2[:, None, None] * np.swapaxes(J, 1, 2) @ J)
        np.add.at(g, lm, w2[:, None] * np.einsum("oji,oj->oi", J, r))
        return cost, H, g

    c0 = residual(X)
    c, lam = c0.copy(), np.full(n, 1e-6)
    for _ in range(iters):
        _, H, g = residual(X, jac=True)
        diag = np.einsum("nii->ni", H)
        Hd = H + (lam[:, None] * (diag + 1e-12))[:, :, None] * np.eye(3)
        step = np.linalg.solve(Hd[multi], -g[multi][..., None])[..., 0]
        Xn = X.copy()
        Xn[multi] = X[multi] + step
        cn = residual(Xn)
        better = cn < c
        X[better] = Xn[better]
        c = np.where(better, cn, c)
        lam = np.where(better, lam * 0.1, lam * 10.0)
    ok = multi & (c0 > 0)
    return 1.0 - c[ok] / c0[ok]


def numbers(drives: list[dict], scene, system: dict) -> dict:
    """The numbers compared, over every drive of the window: each drive's
    ``traj`` (its trajectory), ``frames`` (how many frames it tracked) and
    ``map`` (its map when it ended, as ``run.snapshot`` takes it); `system`
    the configuration's system block."""
    missing = 0
    trans, rot, step, kf, lm, rel, gap = [], [], [], [], [], [], []
    for d in drives:
        traj, n = np.asarray(d["traj"]), d["frames"]
        ok = np.isfinite(traj).all(axis=(1, 2)) if len(traj) else np.zeros(0, bool)
        missing += n - int(ok[:n].sum())
        if len(traj) >= 2 and ok.all():
            e = trajectory_errors(traj[:n], scene.poses_c2w)
            trans.append(e["trans"])
            rot.append(e["rot"])
            step.append(e["step"])
        k, dist, r = map_errors(d["map"], scene)
        kf.append(k)
        lm.append(dist)
        rel.append(r)
        gap.append(structure_gaps(d["map"], system))
    cat = lambda xs: np.concatenate(xs) if sum(map(len, xs)) else np.array([math.inf])  # noqa: E731
    trans, rot, step, kf, lm, rel, gap = map(cat, (trans, rot, step, kf, lm, rel, gap))
    return {
        "frames_without_pose": missing,
        "traj_max_m": float(trans.max()),
        "traj_rms_m": float(np.sqrt(np.mean(trans ** 2))),
        "rot_max_deg": float(rot.max()),
        "step_max_m": float(step.max()),
        "kf_max_m": float(kf.max()),
        "lm_med_m": float(np.median(lm)),
        "lm_p90_m": float(np.percentile(lm, 90)),
        "lm_rel_med": float(np.median(rel)),
        "ba_gap_med": float(np.median(gap)),
        "ba_landmarks": int(np.isfinite(gap).sum()),
        "keyframes": int(sum(len(d["map"]["kf_pose"]) for d in drives)),
        "landmarks": int(sum(len(d["map"]["lm_pos"]) for d in drives)),
    }


def compare(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number of the cell's
    limits at or under its limit, and no frame without a pose."""
    checks = {"frames_without_pose": {"value": nums["frames_without_pose"], "limit": 0}}
    for name, lim in limits["numbers"].items():
        checks[name] = {"value": nums[name], "limit": lim["limit"]}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
