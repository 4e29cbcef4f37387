"""Batched SE(3) / SO(3) / quaternion operations (port of
vslam_tpu/geometry/se3.py).

Poses are 4x4 camera-to-world matrices T with ``p_world = T @ p_local``;
tangents are xi = [omega (3), v (3)] (rotation first, GTSAM Pose3::Expmap).
All functions broadcast over leading batch dimensions. The small-angle
branches are the reference's, value for value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_expmap(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3), Taylor-guarded at 0."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS**2)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye3(W) + A * W + B * W2


def so3_logmap(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (theta in [0, pi]), via
    the quaternion (stable near pi)."""
    q = rot_to_quat(R)
    qv = q[..., :3]
    qw = q[..., 3]
    sign = torch.where(qw < 0, -1.0, 1.0)
    qv = qv * sign[..., None]
    qw = qw * sign
    norm_v = torch.linalg.norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(norm_v, qw)
    small = norm_v < 1e-7
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS), theta / (norm_v + _EPS))
    return qv * scale[..., None]


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS**2)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    return _eye3(W) + B * W + C * W2


def se3_expmap(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: xi = (..., 6) [omega, v] -> (..., 4, 4) transform."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_expmap(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_logmap(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [omega, v]."""
    w = so3_logmap(T[..., :3, :3])
    Jinv = torch.linalg.inv_ex(_so3_left_jacobian(w))[0]  # never singular; no host sync
    v = (Jinv @ T[..., :3, 3:4])[..., 0]
    return torch.cat([w, v], dim=-1)


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """J_r^{-1}(phi): Log(Exp(phi) Exp(d)) ~ phi + J_r^{-1}(phi) d. (3,) ->
    (3, 3). The phi^2 coefficient 1/theta^2 - (1 + cos)/(2 theta sin)
    cancels in float32 for small angles, so below 0.5 rad its series is
    used (next term theta^6 / 1209600)."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS**2)
    W = hat(phi)
    closed = 1.0 / theta2 - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta))
    series = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    c = torch.where(theta2 < 0.25, series, closed)
    return _eye3(W) + 0.5 * W + c * (W @ W)


def se3_right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """J_r^{-1}(xi) of SE(3) for xi = [omega, v]: Log(Exp(xi) Exp(d)) ~ xi +
    J_r^{-1}(xi) d. (6,) -> (6, 6), the series I + ad/2 + ad^2/12 -
    ad^4/720 in ad_xi = [[omega^, 0], [v^, omega^]] (next term ad^6 /
    30240): for the small residuals of a prior factor."""
    Wo, Wv = hat(xi[..., :3]), hat(xi[..., 3:])
    ad = torch.cat(
        [torch.cat([Wo, torch.zeros_like(Wo)], dim=-1), torch.cat([Wv, Wo], dim=-1)], dim=-2
    )
    ad2 = ad @ ad
    eye = torch.eye(6, dtype=xi.dtype, device=xi.device)
    return eye + 0.5 * ad + ad2 / 12.0 - (ad2 @ ad2) / 720.0


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """Ad_T for tangents [omega, v]: T Exp(xi) T^-1 = Exp(Ad_T xi).
    (4, 4) -> (6, 6) [[R, 0], [t^ R, R]]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return torch.cat(
        [torch.cat([R, torch.zeros_like(R)], dim=-1), torch.cat([hat(t) @ R, R], dim=-1)], dim=-2
    )


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) via a quaternion round
    trip (see vslam_tpu/geometry/se3.py: one projection per frame stops a
    dead-reckon streak from squaring the rotation's scale drift)."""
    q = rot_to_quat(T[..., :3, :3])
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return rt_to_mat(quat_to_rot(q), T[..., :3, 3])


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # bottom row [0, 0, 0, 1] built on the device: a host tensor here would
    # cost a host->device copy (and a stream sync) per pose
    T = F.pad(top, (0, 0, 0, 1))
    T[..., 3, 3] = 1.0
    return T


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse. (..., 4, 4) -> (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) or (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.ndim >= T.ndim:  # (..., N, 3): batched point sets
        return pts @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ pts[..., None])[..., 0] + t


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right retraction a la GTSAM: T * exp(xi)."""
    return T @ se3_expmap(xi)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) [x, y, z, w] -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) [x, y, z, w]
    (branchless Shepperd: every case is computed, the max-denominator one
    is selected)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 0.5
    q0 = torch.stack([(m21 - m12), (m02 - m20), (m10 - m01), 4.0 * qw0 * qw0], dim=-1) / (
        4.0 * qw0[..., None]
    )
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 0.5
    q1 = torch.stack(
        [4.0 * qx1 * qx1, (m01 + m10), (m02 + m20), (m21 - m12)], dim=-1
    ) / (4.0 * qx1[..., None])
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 0.5
    q2 = torch.stack(
        [(m01 + m10), 4.0 * qy2 * qy2, (m12 + m21), (m02 - m20)], dim=-1
    ) / (4.0 * qy2[..., None])
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 0.5
    q3 = torch.stack(
        [(m02 + m20), (m12 + m21), 4.0 * qz3 * qz3, (m10 - m01)], dim=-1
    ) / (4.0 * qz3[..., None])

    case = torch.where(
        tr > 0.0,
        0,
        torch.where((m00 > m11) & (m00 > m22), 1, torch.where(m11 > m22, 2, 3)),
    )
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4 cases, 4)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
