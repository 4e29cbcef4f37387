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
hat(a), the gyro noise input) are computed for all rows at once. A batch
of sequences (a leading S) runs one loop over the longest sequence's rows;
a sequence whose rows ran out keeps its state, as a dt == 0 pad would.
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


def _f32_square(x):
    """x**2 rounded as the JAX module computes it, on a float32 scalar; a
    tensor (per-sequence parameters) is squared as it is."""
    if isinstance(x, torch.Tensor):
        return x * x
    return float(np.float32(x) * np.float32(x))


def _f32(x):
    """A parameter as float32: a Python float rounded, a tensor as it is."""
    return x if isinstance(x, torch.Tensor) else float(np.float32(x))


def _lead(x, nd: int):
    """A per-sequence (S,) parameter tensor with `nd` trailing unit
    dimensions; a float as it is."""
    return x.reshape(x.shape + (1,) * nd) if isinstance(x, torch.Tensor) else x


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


def empty_preint(device="cpu", dtype=torch.float32, batch: tuple = ()) -> PreintState:
    z = dict(dtype=dtype, device=device)
    eye = torch.eye(3, **z).expand(batch + (3, 3))
    zero = torch.zeros(batch + (3, 3), **z)
    z3 = torch.zeros(batch + (3,), **z)
    return PreintState(
        dR=eye, dv=z3, dp=z3, dt=torch.zeros(batch, **z),
        dR_dbg=zero, dv_dba=zero, dv_dbg=zero, dp_dba=zero, dp_dbg=zero,
        cov=torch.zeros(batch + (9, 9), **z),
    )


def active_rows(samples) -> np.ndarray:
    """The rows of a (K, 7) host array with dt > 0, in order: the rows the
    JAX scan does not skip."""
    rows = np.asarray(samples, np.float32).reshape(-1, 7)
    return rows[rows[:, 0] > 0.0]


def preintegrate(samples, bias: torch.Tensor, params: ImuParams) -> PreintState:
    """integrateMeasurement over the samples with dt > 0, in order.
    `samples` is a (K, 7) host array (rows with dt <= 0 are no-ops, as in
    the JAX scan) or a tensor of rows that are all active.

    Batched: a (S, 6) `bias` preintegrates S sequences at once, `samples`
    then being S host row arrays (a list, or an (S, K, 7) array) or an
    (S, K, 7) tensor of active rows; the fields carry the leading S and the
    parameters may be (S,) tensors. Each sequence's active rows move to
    the front; a sequence whose rows ran out keeps its state (the JAX
    scan's dt == 0 pads), without touching the others."""
    dev = bias.device
    if bias.ndim == 1:
        samples = samples[None] if isinstance(samples, torch.Tensor) else [samples]
        return PreintState(*(x[0] for x in preintegrate(samples, bias[None], params)))
    S = bias.shape[0]
    if isinstance(samples, torch.Tensor):
        rows = samples.to(dev, bias.dtype)
        counts = np.full(S, rows.shape[1])
    else:
        act = [active_rows(x) for x in samples]
        counts = np.array([len(r) for r in act])
        pad = np.zeros((S, int(counts.max(initial=0)), 7), np.float32)
        for i, r in enumerate(act):
            pad[i, : len(r)] = r
        rows = torch.as_tensor(pad).to(dev, bias.dtype)
    st = empty_preint(dev, bias.dtype, (S,))
    n_rows = rows.shape[1]
    if n_rows == 0:
        return st
    ba, bg = bias[:, None, :3], bias[:, None, 3:]
    dts = rows[..., 0]  # (S, K)
    w = rows[..., 1:4] - bg
    a = rows[..., 4:7] - ba
    wdt = w * dts[..., None]
    dRi = se3.so3_expmap(wdt)  # (S, K, 3, 3)
    dRiT = dRi.transpose(-1, -2)
    Jr = _so3_right_jacobian(wdt)
    hat_a = se3.hat(a)
    dtc = dts[..., None, None]  # (S, K, 1, 1)
    dt2c = dtc * dtc
    Jr_dt = Jr * dtc
    # gyro noise input: Bg = [Jr dt; 0; 0], only its theta block is nonzero
    inv_dt = 1.0 / torch.clamp(dtc, min=1e-9)
    cov_g = _lead(_f32_square(params.gyro_noise), 3) * inv_dt
    cov_a = _lead(_f32_square(params.accel_noise), 3) * inv_dt
    cov_int = _lead(_f32_square(params.integration_sigma), 3) * dtc
    eye3 = torch.eye(3, device=dev).expand(S, 3, 3)
    zero3 = torch.zeros((S, 3, 3), device=dev)
    noise_g = torch.zeros((S, n_rows, 9, 9), device=dev)
    noise_g[..., :3, :3] = cov_g * (Jr_dt @ Jr_dt.transpose(-1, -2))
    noise_int = cov_int * torch.eye(9, device=dev)  # (S, K, 9, 9)

    cur = list(st)  # dR, dv, dp, dt, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov
    for k in range(n_rows):
        dR, dv, dp, dt_sum, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov = cur
        dt, dt2 = dtc[:, k], dt2c[:, k]  # (S, 1, 1): broadcast as scalars
        Rk = dR
        Ra = (Rk @ a[:, k, :, None])[..., 0]
        RH = Rk @ hat_a[:, k]
        RH_dRdbg = RH @ dR_dbg
        Rdt, Rdt2 = Rk * dt, 0.5 * Rk * dt2
        A = torch.cat(
            [
                torch.cat([dRiT[:, k], zero3, zero3], dim=-1),
                torch.cat([-RH * dt, eye3, zero3], dim=-1),
                torch.cat([-0.5 * RH * dt2, eye3 * dt, eye3], dim=-1),
            ],
            dim=-2,
        )
        Ba = torch.cat([zero3, Rdt, Rdt2], dim=-2)
        new = [
            Rk @ dRi[:, k],
            dv + Ra * dt[..., 0],
            dp + dv * dt[..., 0] + 0.5 * Ra * dt2[..., 0],
            dt_sum + dts[:, k],
            dRiT[:, k] @ dR_dbg - Jr_dt[:, k],
            dv_dba - Rdt,
            dv_dbg - RH_dRdbg * dt,
            dp_dba + dv_dba * dt - Rdt2,
            dp_dbg + dv_dbg * dt - 0.5 * RH_dRdbg * dt2,
            A @ cov @ A.transpose(-1, -2) + noise_g[:, k]
            + cov_a[:, k] * (Ba @ Ba.transpose(-1, -2)) + noise_int[:, k],
        ]
        live = counts > k
        if not live.all():  # some sequence's rows ran out: it keeps its state
            m = torch.as_tensor(live, device=dev)
            new = [torch.where(m.reshape((S,) + (1,) * (x.ndim - 1)), x, c) for x, c in zip(new, cur)]
        cur = new
    return PreintState(*cur)


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
    dt = pre.dt[..., None]
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
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def _whitened(T_wb_i, v_w_i, bias_i, T_wb_j, v_w_j, bias_j, pre, bias_bar, gravity_w, params, L):
    """(white (..., 15), r_R (..., 3), L, sig_inv (..., 6)): the whitened
    residual, its raw rotation part, the covariance factor and the bias
    rows' inverse sigmas."""
    dR, dv, dp = bias_corrected(pre, bias_i, bias_bar)
    Ri, pi = T_wb_i[..., :3, :3], T_wb_i[..., :3, 3]
    Rj, pj = T_wb_j[..., :3, :3], T_wb_j[..., :3, 3]
    RiT = Ri.transpose(-1, -2)
    dt = pre.dt[..., None]

    r_R = se3.so3_logmap(dR.transpose(-1, -2) @ RiT @ Rj)
    r_v = _mv(RiT, v_w_j - v_w_i - gravity_w * dt) - dv
    r_p = _mv(RiT, pj - pi - v_w_i * dt - 0.5 * gravity_w * dt * dt) - dp
    r9 = torch.cat([r_R, r_v, r_p], dim=-1)

    if L is None:
        L = cov_factor(pre)
    white9 = torch.linalg.solve_triangular(L, r9[..., None], upper=False)[..., 0]

    # bias random walk over the interval: sigma^2 = walk^2 * dt
    safe_dt = torch.clamp(dt, min=1e-6)
    sig_ba = _lead(_f32(params.accel_walk), 1) * torch.sqrt(safe_dt)
    sig_bg = _lead(_f32(params.gyro_walk), 1) * torch.sqrt(safe_dt)
    r_b = bias_j - bias_i
    white_b = torch.cat([r_b[..., :3] / sig_ba, r_b[..., 3:] / sig_bg], dim=-1)
    lead = sig_ba.shape[:-1]
    sig_inv = torch.cat([(1.0 / sig_ba).expand(lead + (3,)), (1.0 / sig_bg).expand(lead + (3,))], dim=-1)
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
    """:func:`combined_residual` and its (..., 15, 15) Jacobian with respect
    to the j state [omega_b, rho_b, dv_j, db_j], the body pose perturbed on
    the right, T_wb_j Exp([omega_b, rho_b]).

    The corrections dR, dv, dp use the frozen bias_i, so only r_R, r_v,
    r_p and the bias rows depend on the j state:
    dr_R/domega_b = J_r^{-1}(r_R), dr_v/dv_j = Ri^T, dr_p/drho_b = Ri^T Rj,
    whitened by L^{-1}; the bias rows are linear."""
    white, r_R, L, sig_inv = _whitened(
        T_wb_i, v_w_i, bias_i, T_wb_j, v_w_j, bias_j, pre, bias_bar, gravity_w, params, L
    )
    lead = white.shape[:-1]
    z = dict(dtype=white.dtype, device=white.device)
    RiT = T_wb_i[..., :3, :3].transpose(-1, -2)
    J9 = torch.zeros(lead + (9, 15), **z)
    J9[..., 0:3, 0:3] = se3.so3_right_jacobian_inv(r_R)
    J9[..., 3:6, 6:9] = RiT
    J9[..., 6:9, 3:6] = RiT @ T_wb_j[..., :3, :3]
    J = torch.zeros(lead + (15, 15), **z)
    J[..., :9, :] = torch.linalg.solve_triangular(L, J9, upper=False)
    J[..., 9:, 9:] = torch.diag_embed(sig_inv)
    return white, J
