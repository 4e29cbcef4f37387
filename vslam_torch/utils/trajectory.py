"""Trajectory evaluation (numpy only): ATE RMSE with optional SE(3)/Sim(3)
Umeyama alignment. The port's own copy of the functions of
``vslam_tpu/utils/trajectory.py`` that it uses."""

from __future__ import annotations

import numpy as np


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
