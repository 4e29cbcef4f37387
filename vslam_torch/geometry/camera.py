"""Camera models, stereo rigs and rectification (port of
vslam_tpu/geometry/camera.py; reference include/Camera.h:54-107,
src/Camera.cpp:46-119, and the dataset loop's cv::initUndistortRectifyMap /
cv::remap precompute, src/VIOSlam.cpp:282-306).

The rectify map is computed once on the host (numpy, float64; the port's
own copy of the JAX module's numpy code). The per-frame remap is a
bilinear gather on the frame's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vslam_torch.utils.config import ConfigFile


@dataclasses.dataclass
class Camera:
    """Pinhole camera with plumb-bob distortion (reference Camera,
    include/Camera.h:54-79): a rectified rig uses fx/fy/cx/cy; otherwise
    D/K/R/P define the undistort+rectify map and P the rectified
    intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: np.ndarray  # (5,) k1 k2 p1 p2 k3
    K: np.ndarray | None = None  # (3,3) raw intrinsics (unrectified rigs)
    D: np.ndarray | None = None  # (5,) raw distortion
    R: np.ndarray | None = None  # (3,3) rectifying rotation
    P: np.ndarray | None = None  # (3,4) rectified projection
    T_body_cam: np.ndarray | None = None  # (4,4) body->camera extrinsic (T_bc1)

    @classmethod
    def from_config(cls, conf: ConfigFile, section: str) -> "Camera":
        fx = float(conf.get(section, "fx"))
        fy = float(conf.get(section, "fy"))
        cx = float(conf.get(section, "cx"))
        cy = float(conf.get(section, "cy"))
        dist = np.array(
            [float(conf.get(section, k, default=0.0)) for k in ("k1", "k2", "p1", "p2", "k3")]
        )
        K = conf.get_matrix(section, "K", default=None)
        D = conf.get_matrix(section, "D", default=None)
        R = conf.get_matrix(section, "R", default=None)
        P = conf.get_matrix(section, "P", default=None)
        if D is not None:
            D = D.reshape(-1)
        return cls(fx, fy, cx, cy, dist, K=K, D=D, R=R, P=P)

    @property
    def intrinsics(self) -> np.ndarray:
        """Rectified 3x3 K (from P when present)."""
        if self.P is not None:
            return self.P[:, :3].copy()
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]])


@dataclasses.dataclass
class StereoCamera:
    """Stereo rig (reference include/Camera.h:81-107); the right camera
    sits at +baseline along x."""

    left: Camera
    right: Camera
    width: int
    height: int
    fps: float
    baseline: float
    extrinsics: np.ndarray  # (4,4) left->right camera transform

    @classmethod
    def from_config(cls, conf: ConfigFile) -> "StereoCamera":
        left = Camera.from_config(conf, "Camera_l")
        try:
            right = Camera.from_config(conf, "Camera_r")
        except KeyError:  # monocular configs may omit the right camera
            right = left
        width = int(conf.get("Camera", "width"))
        height = int(conf.get("Camera", "height"))
        fps = float(conf.get("Camera", "fps"))
        baseline = float(conf.get("Camera", "bl"))
        ext = np.eye(4)
        ext[0, 3] = baseline
        T_bc = conf.get_matrix("T_bc1", default=None)
        if T_bc is not None:
            left.T_body_cam = T_bc
            right.T_body_cam = T_bc.copy()
            right.T_body_cam[0, 3] += baseline
        return cls(left, right, width, height, fps, baseline, ext)


def _distort_normalized(x: np.ndarray, y: np.ndarray, D: np.ndarray):
    """Plumb-bob distortion of normalized coordinates (k1 k2 p1 p2 k3)."""
    k1, k2, p1, p2, k3 = D[:5]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def init_undistort_rectify_map(
    K: np.ndarray, D: np.ndarray, R: np.ndarray, P: np.ndarray, width: int, height: int
) -> np.ndarray:
    """(H, W, 2) float32 source-pixel map (x_src, y_src), the semantics of
    cv::initUndistortRectifyMap: back-project each rectified pixel through
    P, rotate by R^-1 into the raw camera, distort, project through K."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    rays = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(R).T
    xd, yd = _distort_normalized(rays[..., 0] / rays[..., 2], rays[..., 1] / rays[..., 2], D)
    map_x = K[0, 0] * xd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    return np.stack([map_x, map_y], axis=-1).astype(np.float32)


def remap_bilinear(image: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """cv::remap(INTER_LINEAR, BORDER_CONSTANT=0) as a gather on the
    image's device. image: (H, W) float; src_map: (H, W, 2) (x, y)."""
    H, W = image.shape
    x, y = src_map[..., 0], src_map[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

    def sample(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = image[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return torch.where(valid, v, 0.0)

    top = sample(y0i, x0i) * (1.0 - wx) + sample(y0i, x0i + 1) * wx
    bot = sample(y0i + 1, x0i) * (1.0 - wx) + sample(y0i + 1, x0i + 1) * wx
    return top * (1.0 - wy) + bot * wy


def project(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of (..., 3) camera-frame points -> (..., 2)."""
    z = pts_cam[..., 2:3]
    uv = pts_cam[..., :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return torch.stack([uv[..., 0] * K[0, 0] + K[0, 2], uv[..., 1] * K[1, 1] + K[1, 2]], dim=-1)


def backproject(K: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`project`: pixels (..., 2) + depth (...) -> (..., 3)."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0] * depth
    y = (uv[..., 1] - K[1, 2]) / K[1, 1] * depth
    return torch.stack([x, y, depth], dim=-1)
