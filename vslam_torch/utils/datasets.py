"""IMU binning and the gravity init (the port's own copy of two host-only
helpers of vslam_tpu/utils/datasets.py:91-112; the KITTI and EuRoC loaders
come with the dataset driver)."""

from __future__ import annotations

import numpy as np


def bin_imu_per_frame(imu: np.ndarray, frame_times: np.ndarray) -> list[np.ndarray]:
    """Assign IMU samples to frames: frame i gets the samples with t in
    (t_{i-1}, t_i] (the first frame everything up to t_0), as the per-frame
    binning loop at reference src/VIOSlam.cpp:238-272. Returns a list of
    (K_i, 7) [t, gyro, accel] arrays."""
    bins: list[np.ndarray] = []
    prev = -np.inf
    for t in frame_times:
        mask = (imu[:, 0] > prev) & (imu[:, 0] <= t)
        bins.append(imu[mask])
        prev = t
    return bins


def gravity_from_first_accel(imu: np.ndarray) -> np.ndarray:
    """Gravity init exactly as the reference (src/VIOSlam.cpp:274): the axis
    permutation {a_y, -a_x, a_z} of the first accel sample, which assumes
    EuRoC's sensor mounting."""
    a = imu[0, 4:7]
    return np.array([a[1], -a[0], a[2]], dtype=np.float64)
