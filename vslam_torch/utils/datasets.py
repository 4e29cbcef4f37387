"""Dataset readers: KITTI odometry and EuRoC MAV (the port of
vslam_tpu/utils/datasets.py).

Host-side replacement for the reference drivers' dataset plumbing
(reference src/VIOSlam.cpp:141-316): directory enumeration (KITTI
``image_0/ image_1/``, EuRoC ``cam0/data/`` + ``data.csv``), IMU CSV
parsing, per-frame IMU binning (reference src/VIOSlam.cpp:238-272), and
gravity init from the first accelerometer sample (the reference's axis
permutation ``{a_y, -a_x, a_z}``, src/VIOSlam.cpp:274).

Frames come through the native IO runtime (vslam_torch.native) when it
builds here: worker threads decode (and, given maps, rectify) PNGs ahead
of the tracking loop and hand over (H, W) uint8 frames. Without it,
frames are decoded with PIL as (H, W) float32, and an unrectified rig is
remapped on the device by the facade. Both give the same pixels.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from vslam_torch.utils.config import ConfigFile


def _native():
    """The native IO module, or None when it cannot build or load here."""
    from vslam_torch import native

    return native if native.available() else None


@dataclasses.dataclass
class ImuSample:
    t: float  # seconds
    gyro: np.ndarray  # (3,) rad/s
    accel: np.ndarray  # (3,) m/s^2


@dataclasses.dataclass
class Frame:
    index: int
    t: float  # seconds
    left: np.ndarray  # (H, W) grayscale in [0, 255]: uint8 (native) or float32 (PIL)
    right: np.ndarray | None  # (H, W) or None in mono mode
    imu: np.ndarray  # (K, 7) [t, wx, wy, wz, ax, ay, az] samples since previous frame


def _load_gray(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.float32)


def _parse_imu_csv_py(path: str) -> np.ndarray:
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            vals = [float(p) for p in parts[:7]]
            vals[0] *= 1e-9  # ns -> s
            rows.append(vals)
    return np.asarray(rows, dtype=np.float64)


def load_imu_csv(path: str) -> np.ndarray:
    """EuRoC imu0/data.csv -> (N, 7) [t_sec, wx, wy, wz, ax, ay, az].

    Replicates reference getAllIMUData (src/VIOSlam.cpp:23-73): timestamps
    are nanoseconds in column 0, gyro in 1:4, accel in 4:7. Parsed by the
    native runtime when it is available, in Python otherwise."""
    nat = _native()
    if nat is not None:
        try:
            return nat.parse_imu_csv(path)
        except IOError:
            pass  # a file the C parser refuses -> the Python parser
    return _parse_imu_csv_py(path)


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


def _prefetched_frames(left_paths, right_paths, times, bins, maps):
    """Frames through the native readahead pipeline, strictly in order.
    `maps` = (lx, ly, rx, ry) float32 source-coordinate maps or None."""
    nat = _native()
    if maps is not None:
        h, w = maps[0].shape
    else:
        h, w = nat.probe_png(left_paths[0])
    pf = nat.Prefetcher(list(left_paths), list(right_paths) if right_paths else None,
                        h, w, maps=maps, threads=3)
    try:
        for idx, left, right in pf:
            yield Frame(
                index=idx,
                t=float(times[idx]),
                left=left,
                right=right,
                imu=bins[idx] if bins is not None else np.zeros((0, 7)),
            )
    finally:
        pf.close()


def _can_prefetch(paths) -> bool:
    return _native() is not None and all(p.endswith(".png") for p in paths[:1])


def _no_native_error() -> str:
    from vslam_torch import native

    return native.build_error() or "native runtime unavailable"


def _frames(lefts, rights, times, bins, maps, prefetch) -> Iterator[Frame]:
    """The frames of one sequence: prefetched when asked and possible, else
    decoded with PIL (which cannot rectify on the host)."""
    if prefetch and _can_prefetch(lefts):
        yield from _prefetched_frames(lefts, rights, times, bins, maps)
        return
    if maps is not None:
        raise RuntimeError(f"IO-side rectification needs the native runtime: {_no_native_error()}")
    for i in range(len(lefts)):
        yield Frame(
            index=i,
            t=float(times[i]),
            left=_load_gray(lefts[i]),
            right=_load_gray(rights[i]) if rights is not None else None,
            imu=bins[i] if bins is not None else np.zeros((0, 7)),
        )


class KittiDataset:
    """KITTI odometry grayscale sequence: image_0/ (left), image_1/ (right),
    times.txt. Layout per reference src/VIOSlam.cpp:187-193."""

    def __init__(self, root: str, extension: str = ".png"):
        self.root = root
        self.left_dir = os.path.join(root, "image_0")
        self.right_dir = os.path.join(root, "image_1")
        self.names = sorted(n for n in os.listdir(self.left_dir) if n.endswith(extension))
        times_file = os.path.join(root, "times.txt")
        if os.path.isfile(times_file):
            self.times = np.loadtxt(times_file, dtype=np.float64).reshape(-1)[: len(self.names)]
        else:
            self.times = np.arange(len(self.names), dtype=np.float64) * 0.1
        self.imu = np.zeros((0, 7))

    def __len__(self) -> int:
        return len(self.names)

    def frames(self, limit: int | None = None, maps=None, prefetch: bool = True) -> Iterator[Frame]:
        n = len(self.names) if limit is None else min(limit, len(self.names))
        lefts = [os.path.join(self.left_dir, nm) for nm in self.names[:n]]
        rights = [os.path.join(self.right_dir, nm) for nm in self.names[:n]]
        return _frames(lefts, rights, self.times, None, maps, prefetch)


class EurocDataset:
    """EuRoC MAV: mav0/cam0/data/ + data.csv timestamps, imu0/data.csv.
    Layout per reference src/VIOSlam.cpp:194-205, 222-276."""

    def __init__(self, mav0_root: str, extension: str = ".png", mono: bool = False):
        self.root = mav0_root
        self.mono = mono
        names, times = [], []
        with open(os.path.join(mav0_root, "cam0", "data.csv"), "r") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, name = line.split(",")[:2]
                names.append(name.strip())
                times.append(float(ts) * 1e-9)
        self.names = names
        self.times = np.asarray(times)
        imu_csv = os.path.join(mav0_root, "imu0", "data.csv")
        self.imu = load_imu_csv(imu_csv) if os.path.isfile(imu_csv) else np.zeros((0, 7))
        self._bins = bin_imu_per_frame(self.imu, self.times) if len(self.imu) else None

    def __len__(self) -> int:
        return len(self.names)

    def frames(self, limit: int | None = None, maps=None, prefetch: bool = True) -> Iterator[Frame]:
        n = len(self.names) if limit is None else min(limit, len(self.names))
        lefts = [os.path.join(self.root, "cam0", "data", nm) for nm in self.names[:n]]
        rights = None
        if not self.mono:
            rights = [os.path.join(self.root, "cam1", "data", nm) for nm in self.names[:n]]
        return _frames(lefts, rights, self.times, self._bins, maps, prefetch)


def open_dataset(conf: ConfigFile, data_root: str | None = None):
    """The dataset named by a config (reference-style dispatch on the
    ``dataset`` key, src/VIOSlam.cpp:187-205)."""
    path = conf.get("imagesPath")
    if data_root is not None and not os.path.isabs(path):
        path = os.path.join(data_root, path)
    ext = str(conf.get("fileExtension", default=".png"))
    if conf.dataset.upper() == "KITTI":
        return KittiDataset(path, ext)
    return EurocDataset(path, ext, mono=int(conf.get("slamMode")) == 2)
