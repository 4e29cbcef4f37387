"""Native (C++) host-side data pipeline, bound with ctypes (the port's own
copy of vslam_tpu/native).

``io_native.cc`` holds grayscale PNG decode (libpng), bilinear
rectification of uint8 frames, the EuRoC IMU CSV parse and a
multi-threaded readahead prefetcher; the reference does the same work
inline on its tracking thread (src/VIOSlam.cpp:23-73, 282-306). At first
use the source is compiled with ``g++ ... -lpng -lpthread`` into
``_build/`` (listed in .gitignore), keyed by a hash of the source and the
flags. Nothing is built when this module is imported. Without a compiler
or libpng, :func:`available` is false and :func:`build_error` says why;
the dataset readers then decode with PIL.

Usage:
    from vslam_torch import native
    if native.available():
        img = native.read_png_gray(path)
        pf = native.Prefetcher(lefts, rights, h, w, maps=None, threads=3)
        idx, left, right = pf.next()
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "io_native.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-std=c++17", "-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-lpng", "-lpthread")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # name: (argtypes, restype)
    "vt_png_probe": ([ctypes.c_char_p, _i32p, _i32p], ctypes.c_int),
    "vt_png_read_gray": (
        [ctypes.c_char_p, _u8p, _i32p, _i32p, ctypes.c_int, ctypes.c_int], ctypes.c_int,
    ),
    "vt_remap_bilinear_u8": (
        [_u8p, ctypes.c_int, ctypes.c_int, _f32p, _f32p, _u8p, ctypes.c_int, ctypes.c_int], None,
    ),
    "vt_parse_imu_csv": ([ctypes.c_char_p, _f64p, ctypes.c_long], ctypes.c_long),
    "vt_prefetch_create": (
        [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
         _f32p, _f32p, _f32p, _f32p, ctypes.c_int, ctypes.c_int],
        ctypes.c_void_p,
    ),
    "vt_prefetch_next": ([ctypes.c_void_p, _u8p, _u8p], ctypes.c_long),
    "vt_prefetch_destroy": ([ctypes.c_void_p], None),
}


def library_path() -> pathlib.Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"_io_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile io_native.cc unless an up-to-date build exists; raises with
    the compiler's stderr when it fails. The library is written under a
    temporary name and renamed, so a concurrent build never loads half a
    file."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({proc.returncode}): {proc.stderr[-800:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _load() -> tuple[ctypes.CDLL | None, str | None]:
    """(the loaded library, None), or (None, why it cannot be had)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        return None, str(e)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib, None


def available() -> bool:
    return _load()[0] is not None


def build_error() -> str | None:
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib, err = _load()
    if lib is None:
        raise RuntimeError(err)
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _f32(a: np.ndarray | None):
    if a is None:
        return ctypes.cast(None, _f32p)
    return a.ctypes.data_as(_f32p)


def probe_png(path: str) -> tuple[int, int]:
    """(height, width) of a PNG without decoding it."""
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().vt_png_probe(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"vt_png_probe({path}) failed rc={rc}")
    return h.value, w.value


def read_png_gray(path: str, max_h: int = 4096, max_w: int = 8192) -> np.ndarray:
    """Decode a PNG to (H, W) uint8 grayscale (any color type converted)."""
    ph, pw = probe_png(path)
    out = np.empty((min(ph, max_h), min(pw, max_w)), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().vt_png_read_gray(path.encode(), _u8(out), ctypes.byref(h), ctypes.byref(w), ph, pw)
    if rc != 0:
        raise IOError(f"vt_png_read_gray({path}) failed rc={rc}")
    return out[: h.value, : w.value]


def remap_bilinear_u8(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """cv::remap-style bilinear resampling of a uint8 image with float32
    coordinate maps (BORDER_CONSTANT=0)."""
    src = np.ascontiguousarray(src, np.uint8)
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    if map_x.shape != map_y.shape or map_x.ndim != 2 or src.ndim != 2:
        raise ValueError(f"remap_bilinear_u8: src {src.shape}, maps {map_x.shape} {map_y.shape}")
    oh, ow = map_x.shape
    dst = np.empty((oh, ow), np.uint8)
    _lib().vt_remap_bilinear_u8(
        _u8(src), src.shape[0], src.shape[1], _f32(map_x), _f32(map_y), _u8(dst), oh, ow
    )
    return dst


def parse_imu_csv(path: str, max_rows: int = 1 << 22) -> np.ndarray:
    """EuRoC imu0/data.csv -> (N, 7) float64 [t_sec, gyro, accel] rows."""
    out = np.empty((max_rows, 7), np.float64)
    n = _lib().vt_parse_imu_csv(path.encode(), out.ctypes.data_as(_f64p), max_rows)
    if n < 0:
        raise IOError(f"vt_parse_imu_csv({path}) failed")
    return out[:n].copy()


class Prefetcher:
    """Multi-threaded decode(+rectify) readahead over an image sequence.

    Worker threads decode frames out of order; :meth:`next` delivers them
    strictly in order. `maps` is an optional (map_lx, map_ly, map_rx,
    map_ry) float32 tuple of (height, width) source coordinates, applied as
    rectification after decode (the reference's initUndistortRectifyMap +
    remap, src/VIOSlam.cpp:282-306)."""

    def __init__(
        self,
        left_paths: list[str],
        right_paths: list[str] | None,
        height: int,
        width: int,
        maps=None,
        threads: int = 3,
        queue_cap: int = 6,
    ):
        self._hd = None
        self._lib = _lib()
        self.h, self.w = height, width
        self.stereo = bool(right_paths)
        mxl = myl = mxr = myr = None
        if maps is not None:
            mxl, myl, mxr, myr = (
                None if m is None else np.ascontiguousarray(m, np.float32) for m in maps
            )
            for m in (mxl, myl, mxr, myr):
                if m is not None and m.shape != (height, width):
                    raise ValueError(f"Prefetcher: map {m.shape} != frame {(height, width)}")
        self._hd = self._lib.vt_prefetch_create(
            "\n".join(left_paths).encode(),
            "\n".join(right_paths).encode() if right_paths else b"",
            height, width, _f32(mxl), _f32(myl), _f32(mxr), _f32(myr), threads, queue_cap,
        )
        self.n = len(left_paths)

    def next(self):
        """(index, left, right|None); index == -1 past the end."""
        left = np.empty((self.h, self.w), np.uint8)
        right = np.empty((self.h, self.w), np.uint8) if self.stereo else None
        idx = self._lib.vt_prefetch_next(self._hd, _u8(left), _u8(left if right is None else right))
        if idx < 0:
            return -1, None, None
        return idx, left, right

    def close(self):
        if self._hd:
            self._lib.vt_prefetch_destroy(self._hd)
            self._hd = None

    def __del__(self):
        self.close()

    def __iter__(self):
        while True:
            idx, left, right = self.next()
            if idx < 0:
                return
            yield idx, left, right
