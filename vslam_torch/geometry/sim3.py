"""Sim(3): similarity transforms for monocular loop closure (port of
vslam_tpu/geometry/sim3.py).

A mono map drifts in scale as well as in pose, and an SE(3) loop edge
cannot absorb a scale error; the mono closure optimizes over Sim(3)
(Strasdat et al., "Scale Drift-Aware Large Scale Monocular SLAM").

Representation: a (..., 4, 4) matrix [[s R, t], [0, 1]]; composition is
a matmul and the scale is det(sR)^(1/3). Tangents are [omega (3), nu (3),
sigma (1)], rotation first as in geometry/se3. Everything broadcasts over
leading batch dimensions. The small-angle and small-sigma branches are the
JAX version's, value for value.
"""

from __future__ import annotations

import torch

from vslam_torch.geometry import se3

_EPS = 1e-6


_hat = se3.hat


def _calc_W(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) 'left Jacobian' W with t = W @ nu (Strasdat's closed
    form: W = C I + A [w]x + B [w]x^2, A, B, C the moments
    int_0^1 u^n e^{sigma u} exp(u [w]x) du), with Taylor values below
    _EPS in theta or sigma. (..., 3), (...,) -> (..., 3, 3)."""
    theta = torch.linalg.norm(omega, dim=-1)
    s = torch.exp(sigma)
    Om = _hat(omega)
    Om2 = Om @ Om

    small_sig = torch.abs(sigma) < _EPS
    small_th = theta < _EPS
    # safe denominators (the selected branch never uses the unsafe one)
    sg = torch.where(small_sig, torch.ones_like(sigma), sigma)
    th = torch.where(small_th, torch.ones_like(theta), theta)

    C = torch.where(small_sig, 1.0 + 0.5 * sigma, (s - 1.0) / sg)

    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a = s * sin_t
    b = s * cos_t
    c = theta * theta + sigma * sigma
    c_safe = torch.where(small_sig & small_th, torch.ones_like(c), c)

    A_ss = (1.0 - cos_t) / (th * th)  # sigma ~ 0
    A_ls_st = ((sigma - 1.0) * s + 1.0) / (sg * sg)  # theta ~ 0
    A_gen = (a * sigma + (1.0 - b) * theta) / (th * c_safe)
    A = torch.where(
        small_th,
        torch.where(small_sig, torch.full_like(theta, 0.5), A_ls_st),
        torch.where(small_sig, A_ss, A_gen),
    )

    B_ss = (theta - sin_t) / (th * th * th)
    B_ls_st = ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0) / (sg**3)
    B_gen = (C - ((b - 1.0) * sigma + a * theta) / c_safe) / (th * th)
    B = torch.where(
        small_th,
        torch.where(small_sig, torch.full_like(theta, 1.0 / 6.0), B_ls_st),
        torch.where(small_sig, B_ss, B_gen),
    )

    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return C[..., None, None] * eye + A[..., None, None] * Om + B[..., None, None] * Om2


def expmap(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) exp: (..., 7) [omega, nu, sigma] -> (..., 4, 4)."""
    omega, nu, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = se3.so3_expmap(omega)
    s = torch.exp(sigma)
    W = _calc_W(omega, sigma)
    t = (W @ nu[..., None])[..., 0]
    return se3.rt_to_mat(s[..., None, None] * R, t)


def scale_of(M: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (...,) similarity scale s = det(sR)^(1/3)."""
    d = torch.linalg.det(M[..., :3, :3])
    return torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)


def logmap(M: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 7) [omega, nu, sigma]."""
    s = scale_of(M)
    R = M[..., :3, :3] / s[..., None, None]
    sigma = torch.log(s)
    omega = se3.so3_logmap(R)
    W = _calc_W(omega, sigma)
    nu = torch.linalg.solve_ex(W, M[..., :3, 3:4])[0][..., 0]  # no host sync
    return torch.cat([omega, nu, sigma[..., None]], dim=-1)


def inverse(M: torch.Tensor) -> torch.Tensor:
    """Closed-form Sim(3) inverse: (s, R, t) -> (1/s, R^T, -(1/s) R^T t)."""
    s = scale_of(M)
    R = M[..., :3, :3] / s[..., None, None]
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * (Rt @ M[..., :3, 3:4])[..., 0]
    return se3.rt_to_mat(s_inv[..., None, None] * Rt, t_inv)


def retract(M: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right retraction M * exp(xi) (the geometry/se3 convention)."""
    return M @ expmap(xi)


def from_se3(T: torch.Tensor, s=1.0) -> torch.Tensor:
    """SE(3) pose + scale -> Sim(3) matrix."""
    s = torch.as_tensor(s, dtype=T.dtype, device=T.device)
    return se3.rt_to_mat(s[..., None, None] * T[..., :3, :3], T[..., :3, 3])


def to_se3(M: torch.Tensor) -> torch.Tensor:
    """Corrected camera pose from an optimized Sim(3) state: R and the
    world translation, the scale dropped (it belongs to the map
    correction: landmarks take the full Sim(3) delta), ORB-SLAM's
    CorrectedSim3 -> SE3 convention for cam-to-world poses."""
    s = scale_of(M)
    R = M[..., :3, :3] / s[..., None, None]
    return se3.rt_to_mat(R, M[..., :3, 3])


def adjoint(M: torch.Tensor) -> torch.Tensor:
    """Ad_M for tangents [omega, nu, sigma]: M Exp(xi) M^-1 =
    Exp(Ad_M xi). (..., 4, 4) -> (..., 7, 7)
    [[R, 0, 0], [t^ R, s R, -t], [0, 0, 1]]."""
    s = scale_of(M)
    sR, t = M[..., :3, :3], M[..., :3, 3]
    R = sR / s[..., None, None]
    z3 = torch.zeros_like(R)
    z31 = torch.zeros_like(t)[..., None]
    top = torch.cat([R, z3, z31], dim=-1)
    mid = torch.cat([_hat(t) @ R, sR, -t[..., None]], dim=-1)
    bot = torch.cat([torch.zeros_like(top[..., :1, :6]), torch.ones_like(top[..., :1, :1])], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def ad(xi: torch.Tensor) -> torch.Tensor:
    """The Lie bracket matrix ad_xi of sim(3) for xi = [omega, nu, sigma]:
    [xi, eta] = ad_xi eta. (..., 7) -> (..., 7, 7)
    [[omega^, 0, 0], [nu^, omega^ + sigma I, -nu], [0, 0, 0]]."""
    Wo, Wn = _hat(xi[..., :3]), _hat(xi[..., 3:6])
    sig = xi[..., 6][..., None, None]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    z3 = torch.zeros_like(Wo)
    z31 = torch.zeros_like(Wo[..., :1])
    top = torch.cat([Wo, z3, z31], dim=-1)
    mid = torch.cat([Wn, Wo + sig * eye, -xi[..., 3:6, None]], dim=-1)
    bot = torch.zeros_like(top[..., :1, :])
    return torch.cat([top, mid, bot], dim=-2)
