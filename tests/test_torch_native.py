"""The port's native IO runtime (vslam_torch/native, its own copy of the C++
source, built into its own git-ignored directory) against vslam_tpu.native
on the same files and arrays: PNG probe and decode, the uint8 bilinear
remap, the IMU CSV parse and the prefetcher's order and rectification.
Every output must be byte-equal."""

import pathlib

import numpy as np
import pytest
from PIL import Image

from vslam_torch import native as tnat
from vslam_tpu import native as jnat

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def both_built():
    assert tnat.available(), tnat.build_error()
    if not jnat.available():
        pytest.skip(f"vslam_tpu native IO unavailable: {jnat.build_error()}")


def test_build_lands_in_the_ignored_directory():
    """The port builds its own source into vslam_torch/native/_build/, which
    .gitignore lists; it never loads vslam_tpu's library."""
    lib = tnat.library_path()
    assert lib.is_file() and lib.parent == REPO / "vslam_torch" / "native" / "_build"
    assert tnat.SRC == REPO / "vslam_torch" / "native" / "io_native.cc"
    assert "vslam_torch/native/_build/" in (REPO / ".gitignore").read_text().split()
    assert tnat.build_error() is None


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P", "I;16"])
def test_png_decode_matches(tmp_path, mode):
    """Gray, color (BT.601 luma), alpha, palette and 16-bit PNGs decode to
    the same uint8 bytes in both packages."""
    rng = np.random.default_rng(len(mode))
    h, w = 37, 53
    if mode == "L":
        im = Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8), "L")
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16))
    else:
        rgb = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB")
        im = rgb.convert(mode) if mode != "P" else rgb.quantize(64)
    path = str(tmp_path / f"x_{mode.replace(';', '')}.png")
    im.save(path)
    assert tnat.probe_png(path) == jnat.probe_png(path) == (h, w)
    a, b = tnat.read_png_gray(path), jnat.read_png_gray(path)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (h, w)
    np.testing.assert_array_equal(a, b)


def test_remap_matches():
    """A rectification-like map with samples inside, on the border and far
    outside (BORDER_CONSTANT 0)."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (41, 67), dtype=np.uint8)
    ys, xs = np.mgrid[0:45, 0:60].astype(np.float32)
    mx = (xs * 1.13 - 3.7 + rng.normal(0, 0.4, xs.shape)).astype(np.float32)
    my = (ys * 0.97 + 1.3 + rng.normal(0, 0.4, ys.shape)).astype(np.float32)
    mx[0, :5] = [-1.5, -0.5, 66.5, 67.0, 1e6]
    my[1, :3] = [-0.99, 40.2, -1e6]
    a = tnat.remap_bilinear_u8(img, mx, my)
    b = jnat.remap_bilinear_u8(img, mx, my)
    assert a.shape == (45, 60)
    np.testing.assert_array_equal(a, b)


def test_imu_csv_matches(tmp_path):
    """Comment lines, blank lines, spaces after commas, a short row (skipped)
    and nanosecond timestamps."""
    rows = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z", ""]
    rng = np.random.default_rng(9)
    t0 = 1403636579758555392
    for j in range(40):
        v = rng.normal(0, 1, 6)
        rows.append(f"{t0 + j * 5_000_000}," + ", ".join(f"{x:.17g}" for x in v))
        if j == 7:
            rows += ["", "   # a comment", "1,2,3"]
    p = tmp_path / "data.csv"
    p.write_text("\n".join(rows) + "\n")
    a, b = tnat.parse_imu_csv(str(p)), jnat.parse_imu_csv(str(p))
    assert a.shape == (40, 7) and a.dtype == np.float64
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rectify", [False, True], ids=["plain", "rectified"])
def test_prefetcher_matches(tmp_path, rectify):
    """12 stereo frames through both prefetchers (3 threads, a readahead of
    6): the same indices in order and the same bytes, with and without
    the host rectification maps."""
    rng = np.random.default_rng(11)
    h, w = 30, 44
    lefts, rights = [], []
    for i in range(12):
        for side, out in (("l", lefts), ("r", rights)):
            p = str(tmp_path / f"{side}{i:03d}.png")
            Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8), "L").save(p)
            out.append(p)
    maps = None
    if rectify:
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        maps = (xs * 1.02 - 0.3, ys + 0.4, xs + 0.7, ys * 0.98)
    got = []
    for mod in (tnat, jnat):
        pf = mod.Prefetcher(lefts, rights, h, w, maps=maps, threads=3)
        try:
            got.append([(i, l.tobytes(), r.tobytes()) for i, l, r in pf])
        finally:
            pf.close()
    assert [g[0] for g in got[0]] == list(range(12))
    assert got[0] == got[1]
    if not rectify:
        first = np.frombuffer(got[0][0][1], np.uint8).reshape(h, w)
        np.testing.assert_array_equal(first, np.asarray(Image.open(lefts[0])))


def test_mono_prefetcher_matches(tmp_path):
    """Left images only (the EuRoC mono layout): right is None in both."""
    rng = np.random.default_rng(12)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"m{i}.png")
        Image.fromarray(rng.integers(0, 256, (16, 24), dtype=np.uint8), "L").save(p)
        paths.append(p)
    out = []
    for mod in (tnat, jnat):
        pf = mod.Prefetcher(paths, None, 16, 24)
        out.append([(i, l.tobytes(), r) for i, l, r in pf])
        pf.close()
    assert out[0] == out[1] and len(out[0]) == 5 and all(r is None for _, _, r in out[0])
