"""IMU preintegration on-manifold with CombinedImuFactor semantics (port of
vslam_tpu/ops/imu.py).

GTSAM's PreintegratedCombinedMeasurements + CombinedImuFactor as the
reference uses them (src/FeatureTracker.cpp:301-387, 1036-1106):
right-increment preintegration of DeltaR/DeltaV/DeltaP, first-order bias
Jacobians, 9x9 covariance propagation, NavState prediction, and the
whitened 15-dim factor residual between consecutive frames.

Conventions (those of the JAX module): body-frame states T_wb (4, 4), world
velocity v_w (3,), bias = [accel bias (3) | gyro bias (3)]; samples are
(K, 7) rows [dt, wx, wy, wz, ax, ay, az]; gravity is a world-frame vector.

The JAX ``lax.scan`` runs over a fixed 64 rows padded with dt == 0 no-ops.
Here the host drops every row with dt <= 0 before the loop and iterates
over the real rows only, in the same order; the per-row terms that do not
depend on the running state (the rotation increment, the right Jacobian,
hat(a), the gyro noise input) are computed for all rows at once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vslam_torch.geometry import se3


class PreintState(NamedTuple):
    dR: torch.Tensor  # (3, 3)
    dv: torch.Tensor  # (3,)
    dp: torch.Tensor  # (3,)
    dt: torch.Tensor  # ()
    # first-order bias Jacobians
    dR_dbg: torch.Tensor  # (3, 3)
    dv_dba: torch.Tensor  # (3, 3)
    dv_dbg: torch.Tensor  # (3, 3)
    dp_dba: torch.Tensor  # (3, 3)
    dp_dbg: torch.Tensor  # (3, 3)
    cov: torch.Tensor  # (9, 9) [theta, v, p]


class ImuParams(NamedTuple):
    gyro_noise: float  # sigma, rad/s/sqrt(Hz)
    accel_noise: float  # m/s^2/sqrt(Hz)
    gyro_walk: float
    accel_walk: float
    # integration error covariance floor (GTSAM integrationCovariance)
    integration_sigma: float = 1e-4


def _f32_square(x: float) -> float:
    """x**2 rounded as the JAX module computes it, on a float32 scalar."""
    return float(np.float32(x) * np.float32(x))


def _so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-16)
    W = se3.hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye - B * W + C * W2


def empty_preint(device="cpu", dtype=torch.float32) -> PreintState:
    eye = torch.eye(3, dtype=dtype, device=device)
    zero = torch.zeros((3, 3), dtype=dtype, device=device)
    z3 = torch.zeros(3, dtype=dtype, device=device)
    return PreintState(
        dR=eye, dv=z3, dp=z3, dt=torch.zeros((), dtype=dtype, device=device),
        dR_dbg=zero, dv_dba=zero, dv_dbg=zero, dp_dba=zero, dp_dbg=zero,
        cov=torch.zeros((9, 9), dtype=dtype, device=device),
    )


def active_rows(samples) -> np.ndarray:
    """The rows of a (K, 7) host array with dt > 0, in order: the rows the
    JAX scan does not skip."""
    rows = np.asarray(samples, np.float32).reshape(-1, 7)
    return rows[rows[:, 0] > 0.0]


def preintegrate(samples, bias: torch.Tensor, params: ImuParams) -> PreintState:
    """integrateMeasurement over the samples with dt > 0, in order.
    `samples` is a (K, 7) host array (rows with dt <= 0 are no-ops, as in
    the JAX scan) or a tensor of rows that are all active."""
    dev = bias.device
    if isinstance(samples, torch.Tensor):
        rows = samples.to(dev, bias.dtype)
    else:
        rows = torch.as_tensor(active_rows(samples)).to(dev, bias.dtype)
    st = empty_preint(dev, bias.dtype)
    if rows.shape[0] == 0:
        return st
    ba, bg = bias[:3], bias[3:]
    dts = rows[:, 0]
    w = rows[:, 1:4] - bg
    a = rows[:, 4:7] - ba
    wdt = w * dts[:, None]
    dRi = se3.so3_expmap(wdt)  # (K, 3, 3)
    Jr = _so3_right_jacobian(wdt)
    hat_a = se3.hat(a)
    dtc = dts[:, None, None]
    dt2c = dtc * dtc
    Jr_dt = Jr * dtc
    # gyro noise input: Bg = [Jr dt; 0; 0], only its theta block is nonzero
    inv_dt = 1.0 / torch.clamp(dtc, min=1e-9)
    cov_g = _f32_square(params.gyro_noise) * inv_dt
    cov_a = _f32_square(params.accel_noise) * inv_dt
    cov_int = _f32_square(params.integration_sigma) * dtc
    eye3 = torch.eye(3, device=dev)
    zero3 = torch.zeros((3, 3), device=dev)
    noise_g = torch.zeros((rows.shape[0], 9, 9), device=dev)
    noise_g[:, :3, :3] = cov_g * (Jr_dt @ Jr_dt.transpose(-1, -2))
    noise_int = cov_int * torch.eye(9, device=dev)  # (K, 9, 9)

    dR, dv, dp, dt_sum = st.dR, st.dv, st.dp, st.dt
    dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov = (
        st.dR_dbg, st.dv_dba, st.dv_dbg, st.dp_dba, st.dp_dbg, st.cov,
    )
    for k in range(rows.shape[0]):
        dt, dt2 = dtc[k], dt2c[k]  # (1, 1): broadcast as scalars
        Rk = dR
        Ra = Rk @ a[k]
        RH = Rk @ hat_a[k]
        RH_dRdbg = RH @ dR_dbg
        Rdt, Rdt2 = Rk * dt, 0.5 * Rk * dt2
        A = torch.cat(
            [
                torch.cat([dRi[k].T, zero3, zero3], dim=1),
                torch.cat([-RH * dt, eye3, zero3], dim=1),
                torch.cat([-0.5 * RH * dt2, eye3 * dt, eye3], dim=1),
            ],
            dim=0,
        )
        Ba = torch.cat([zero3, Rdt, Rdt2], dim=0)
        cov = A @ cov @ A.T + noise_g[k] + cov_a[k] * (Ba @ Ba.T) + noise_int[k]
        dp_dbg = dp_dbg + dv_dbg * dt - 0.5 * RH_dRdbg * dt2
        dp_dba = dp_dba + dv_dba * dt - Rdt2
        dv_dbg = dv_dbg - RH_dRdbg * dt
        dv_dba = dv_dba - Rdt
        dR_dbg = dRi[k].T @ dR_dbg - Jr_dt[k]
        dp = dp + dv * dt[0] + 0.5 * Ra * dt2[0]
        dv = dv + Ra * dt[0]
        dR = Rk @ dRi[k]
        dt_sum = dt_sum + dts[k]
    return PreintState(
        dR=dR, dv=dv, dp=dp, dt=dt_sum, dR_dbg=dR_dbg, dv_dba=dv_dba,
        dv_dbg=dv_dbg, dp_dba=dp_dba, dp_dbg=dp_dbg, cov=cov,
    )


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x over leading batch dimensions of either operand."""
    return (A @ x[..., None])[..., 0]


def bias_corrected(pre: PreintState, bias_i: torch.Tensor, bias_bar: torch.Tensor):
    """First-order corrected (dR, dv, dp) at bias_i around the
    preintegration linearization point bias_bar. Biases may carry leading
    batch dimensions."""
    dba = bias_i[..., :3] - bias_bar[..., :3]
    dbg = bias_i[..., 3:] - bias_bar[..., 3:]
    dR = pre.dR @ se3.so3_expmap(_mv(pre.dR_dbg, dbg))
    dv = pre.dv + _mv(pre.dv_dba, dba) + _mv(pre.dv_dbg, dbg)
    dp = pre.dp + _mv(pre.dp_dba, dba) + _mv(pre.dp_dbg, dbg)
    return dR, dv, dp


def predict(T_wb_i, v_w_i, pre: PreintState, bias_i, bias_bar, gravity_w):
    """NavState.predict (reference PredictNextPoseIMU,
    src/FeatureTracker.cpp:1036-1106): propagate body pose + velocity."""
    dR, dv, dp = bias_corrected(pre, bias_i, bias_bar)
    Ri = T_wb_i[..., :3, :3]
    pi = T_wb_i[..., :3, 3]
    dt = pre.dt
    Rj = Ri @ dR
    vj = v_w_i + gravity_w * dt + _mv(Ri, dv)
    pj = pi + v_w_i * dt + 0.5 * gravity_w * dt * dt + _mv(Ri, dp)
    return se3.rt_to_mat(Rj, pj), vj


def cov_factor(pre: PreintState) -> torch.Tensor:
    """Lower Cholesky factor of the propagated covariance (+1e-10 I), NaN
    where the factorization fails (as jnp.linalg.cholesky), without a host
    sync on the error check."""
    cov = pre.cov + 1e-10 * torch.eye(9, dtype=pre.cov.dtype, device=pre.cov.device)
    L, info = torch.linalg.cholesky_ex(cov)
    return torch.where(info == 0, L, float("nan"))


def _whitened(T_wb_i, v_w_i, bias_i, T_wb_j, v_w_j, bias_j, pre, bias_bar, gravity_w, params, L):
    """(white (..., 15), r_R (..., 3), L, sig_inv (6,)): the whitened
    residual, its raw rotation part, the covariance factor and the bias
    rows' inverse sigmas."""
    dR, dv, dp = bias_corrected(pre, bias_i, bias_bar)
    Ri, pi = T_wb_i[..., :3, :3], T_wb_i[..., :3, 3]
    Rj, pj = T_wb_j[..., :3, :3], T_wb_j[..., :3, 3]
    RiT = Ri.transpose(-1, -2)
    dt = pre.dt

    r_R = se3.so3_logmap(dR.transpose(-1, -2) @ RiT @ Rj)
    r_v = _mv(RiT, v_w_j - v_w_i - gravity_w * dt) - dv
    r_p = _mv(RiT, pj - pi - v_w_i * dt - 0.5 * gravity_w * dt * dt) - dp
    r9 = torch.cat([r_R, r_v, r_p], dim=-1)

    if L is None:
        L = cov_factor(pre)
    white9 = torch.linalg.solve_triangular(L, r9[..., None], upper=False)[..., 0]

    # bias random walk over the interval: sigma^2 = walk^2 * dt
    safe_dt = torch.clamp(dt, min=1e-6)
    sig_ba = float(np.float32(params.accel_walk)) * torch.sqrt(safe_dt)
    sig_bg = float(np.float32(params.gyro_walk)) * torch.sqrt(safe_dt)
    r_b = bias_j - bias_i
    white_b = torch.cat([r_b[..., :3] / sig_ba, r_b[..., 3:] / sig_bg], dim=-1)
    sig_inv = torch.cat([(1.0 / sig_ba).expand(3), (1.0 / sig_bg).expand(3)])
    return torch.cat([white9, white_b], dim=-1), r_R, L, sig_inv


def combined_residual(
    T_wb_i, v_w_i, bias_i, T_wb_j, v_w_j, bias_j, pre: PreintState, bias_bar,
    gravity_w, params: ImuParams, L: torch.Tensor | None = None,
) -> torch.Tensor:
    """Whitened 15-dim CombinedImuFactor residual [r_R, r_v, r_p, r_ba,
    r_bg]: the preintegration terms whitened with the inverse Cholesky
    factor of the propagated covariance (`L`, from :func:`cov_factor`
    when not given), the bias random walk with the walk sigmas over the
    interval. The states may carry leading batch dimensions."""
    return _whitened(
        T_wb_i, v_w_i, bias_i, T_wb_j, v_w_j, bias_j, pre, bias_bar, gravity_w, params, L
    )[0]


def combined_residual_and_jacobian(
    T_wb_i, v_w_i, bias_i, T_wb_j, v_w_j, bias_j, pre: PreintState, bias_bar,
    gravity_w, params: ImuParams, L: torch.Tensor | None = None,
):
    """:func:`combined_residual` (unbatched states) and its (15, 15)
    Jacobian with respect to the j state [omega_b, rho_b, dv_j, db_j], the
    body pose perturbed on the right, T_wb_j Exp([omega_b, rho_b]).

    The corrections dR, dv, dp use the frozen bias_i, so only r_R, r_v,
    r_p and the bias rows depend on the j state:
    dr_R/domega_b = J_r^{-1}(r_R), dr_v/dv_j = Ri^T, dr_p/drho_b = Ri^T Rj,
    whitened by L^{-1}; the bias rows are linear."""
    white, r_R, L, sig_inv = _whitened(
        T_wb_i, v_w_i, bias_i, T_wb_j, v_w_j, bias_j, pre, bias_bar, gravity_w, params, L
    )
    RiT = T_wb_i[:3, :3].T
    J9 = torch.zeros((9, 15), dtype=white.dtype, device=white.device)
    J9[0:3, 0:3] = se3.so3_right_jacobian_inv(r_R)
    J9[3:6, 6:9] = RiT
    J9[6:9, 3:6] = RiT @ T_wb_j[:3, :3]
    J = torch.zeros((15, 15), dtype=white.dtype, device=white.device)
    J[:9] = torch.linalg.solve_triangular(L, J9, upper=False)
    J[9:, 9:] = torch.diag(sig_inv)
    return white, J
