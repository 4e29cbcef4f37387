"""Trajectory output and evaluation: the reference's KITTI 3x4 dump
(src/System.cpp:87-124), TUM rows, ATE RMSE with optional SE(3)/Sim(3)
Umeyama alignment, and RPE. The port's own copy of
``vslam_tpu/utils/trajectory.py``; the TUM quaternion goes through the
port's se3 on CPU tensors."""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.geometry import se3


def save_kitti_trajectory(path: str, poses: np.ndarray) -> None:
    """poses: (N, 4, 4) camera-to-world. Writes N lines of 12 floats."""
    flat = np.asarray(poses)[:, :3, :].reshape(len(poses), 12)
    np.savetxt(path, flat, fmt="%.9e")


def load_kitti_trajectory(path: str) -> np.ndarray:
    flat = np.loadtxt(path).reshape(-1, 12)
    poses = np.tile(np.eye(4), (len(flat), 1, 1))
    poses[:, :3, :] = flat.reshape(-1, 3, 4)
    return poses


def save_tum_trajectory(path: str, times: np.ndarray, poses: np.ndarray) -> None:
    """TUM format: t tx ty tz qx qy qz qw (EuRoC evaluation)."""
    R = torch.as_tensor(np.asarray(poses)[:, :3, :3], dtype=torch.float32)
    q = se3.rot_to_quat(R).numpy()
    t = np.asarray(poses)[:, :3, 3]
    rows = np.concatenate([np.asarray(times)[:, None], t, q], axis=1)
    np.savetxt(path, rows, fmt="%.9f")


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment est -> gt.

    est, gt: (N, 3). Returns (R, t, s) with gt ~ s * R @ est + t.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (e**2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error RMSE over translation, after optional
    Umeyama alignment."""
    est = np.asarray(est_poses)[:, :3, 3]
    gt = np.asarray(gt_poses)[:, :3, 3]
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> float:
    """Relative pose error RMSE (translation) over frame gaps of `delta`."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = min(len(est), len(gt)) - delta
    errs = []
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        errs.append(np.linalg.norm((np.linalg.inv(dg) @ de)[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0
