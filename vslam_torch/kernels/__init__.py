"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file exposes a plain C entry point. At first use the
sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library under ``_build/`` (listed in .gitignore), keyed by a hash of the
sources and flags, and loaded with ``ctypes``. Nothing is built when this
module is imported, and nothing here runs on a machine without a CUDA
toolkit: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# entry point -> argument types; restype is always int (a cudaError_t)
SIGNATURES = {
    # level table (host int64 rows: img, h, w, first), n_levels, x0, y0,
    # out, B, N, P, Pw, stream
    "extract_windows_levels_f32": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    # T0; (pointer, batch stride) of pts, obs, inv_sigma2, stereo, right,
    # valid, K; baseline (pointer, stride), its value; B, M, max_iters;
    # T_out, chi2, inliers, stereo_out, err, lam, iters; stream
    "motion_only_lm_f32": (
        _P, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L,
        _P, _L, _F, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P,
    ),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of vslam_torch are built from csrc/ at first use"
    )


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[pathlib.Path, float]:
    """Compile csrc/*.cu into one shared library unless an up-to-date build
    exists. Returns (library path, seconds spent compiling; 0 if cached)."""
    sources = _sources()
    lib = BUILD_DIR / f"libvslam_kernels_{_digest(sources)}.so"
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, dt


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
