"""The port's dataset readers (vslam_torch/utils/datasets.py) against
vslam_tpu's on the same directories: the KITTI layout of
tests/test_driver.py:23-52 and the EuRoC layout of tests/test_io.py:42-73.
Names, times, IMU rows and bins, gravity and frames must be equal, frames
exactly (np.array_equal), on the PIL path and on the native prefetch path."""

import os

import numpy as np
import pytest
from PIL import Image

from vslam_torch.utils import datasets as tds
from vslam_torch.utils.config import ConfigFile as TConfig
from vslam_tpu.utils import datasets as jds, synthetic
from vslam_tpu.utils.config import ConfigFile as JConfig

W, H, N_KITTI = 320, 240, 10


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """tests/test_driver.py's sequence: 10 rendered stereo frames as uint8
    PNGs in image_0/, image_1/, times.txt, and its config."""
    root = tmp_path_factory.mktemp("kitti_seq")
    scene = synthetic.make_scene(n_frames=N_KITTI, n_points=400, width=W, height=H, fps=10.0, seed=7)
    for sub in ("image_0", "image_1"):
        os.makedirs(root / sub)
    for f in range(N_KITTI):
        for right, sub in ((False, "image_0"), (True, "image_1")):
            img = np.clip(scene.render(f, right=right), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / sub / f"{f:06d}.png")
    np.savetxt(root / "times.txt", scene.times)
    (root / "config.yaml").write_text(
        f'rectified: true\nslamMode: 1\ndataset: "KITTI"\nimagesPath: "{root}"\n'
        f"Camera: {{width: {W}, height: {H}, fps: 10.0, bl: 0.12}}\n"
    )
    return root


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    """tests/test_io.py's minimal EuRoC layout (3 frames of 8x10, 30 IMU
    rows at 200 Hz), plus a comment line and a blank line in the IMU file
    and a mono config."""
    root = tmp_path_factory.mktemp("euroc") / "mav0"
    for cam in ("cam0", "cam1"):
        os.makedirs(root / cam / "data")
    rows = []
    for i in range(3):
        ts = 1403636579763555584 + i * 50000000
        name = f"{ts}.png"
        rows.append(f"{ts},{name}")
        for cam in ("cam0", "cam1"):
            Image.fromarray(np.full((8, 10), i * 10 + (cam == "cam1"), np.uint8)).save(
                root / cam / "data" / name
            )
    (root / "cam0" / "data.csv").write_text("#ts,name\n" + "\n".join(rows) + "\n")
    os.makedirs(root / "imu0")
    t0 = 1403636579763555584
    imu_rows = [f"{t0 + int(j * 5e6)},0.01,0.02,0.03,9.8,0.1,{0.2 + j * 1e-3:.4f}" for j in range(30)]
    imu_rows.insert(12, "")
    imu_rows.insert(20, "# a comment")
    (root / "imu0" / "data.csv").write_text("#header\n" + "\n".join(imu_rows) + "\n")
    return root


def _frames_equal(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert fa.index == fb.index and fa.t == fb.t
        np.testing.assert_array_equal(fa.left, fb.left)
        assert fa.left.dtype == fb.left.dtype
        if fb.right is None:
            assert fa.right is None
        else:
            np.testing.assert_array_equal(fa.right, fb.right)
        np.testing.assert_array_equal(fa.imu, fb.imu)


@pytest.mark.parametrize("prefetch", [False, True], ids=["pil", "native"])
def test_kitti_loader_matches(kitti_dir, prefetch):
    td, jd = tds.KittiDataset(str(kitti_dir)), jds.KittiDataset(str(kitti_dir))
    assert td.names == jd.names and len(td) == N_KITTI
    np.testing.assert_array_equal(td.times, jd.times)
    tf = list(td.frames(prefetch=prefetch))
    _frames_equal(tf, list(jd.frames(prefetch=prefetch)))
    assert tf[0].left.dtype == (np.uint8 if prefetch else np.float32)
    _frames_equal(list(td.frames(limit=4, prefetch=prefetch)), list(jd.frames(limit=4, prefetch=prefetch)))


def test_kitti_native_and_pil_frames_agree(kitti_dir):
    """uint8 from the prefetcher and float32 from PIL hold the same pixels."""
    td = tds.KittiDataset(str(kitti_dir))
    for a, b in zip(td.frames(prefetch=True), td.frames(prefetch=False)):
        np.testing.assert_array_equal(a.left.astype(np.float32), b.left)
        np.testing.assert_array_equal(a.right.astype(np.float32), b.right)


@pytest.mark.parametrize("prefetch", [False, True], ids=["pil", "native"])
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_euroc_loader_matches(euroc_dir, prefetch, mono):
    td = tds.EurocDataset(str(euroc_dir), mono=mono)
    jd = jds.EurocDataset(str(euroc_dir), mono=mono)
    assert td.names == jd.names and len(td) == 3
    np.testing.assert_array_equal(td.times, jd.times)
    assert td.imu.shape == (30, 7)
    np.testing.assert_array_equal(td.imu, jd.imu)
    for a, b in zip(td._bins, jd._bins):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.gravity_from_first_accel(td.imu), jds.gravity_from_first_accel(jd.imu))
    tf = list(td.frames(prefetch=prefetch))
    _frames_equal(tf, list(jd.frames(prefetch=prefetch)))
    assert len(tf[1].imu) == 10  # 50 ms at 200 Hz


def test_rectify_without_native_is_refused(kitti_dir):
    """Host rectification needs the prefetcher: with prefetch off, maps raise
    in both packages."""
    maps = tuple(np.zeros((H, W), np.float32) for _ in range(4))
    for mod in (tds, jds):
        with pytest.raises(RuntimeError, match="IO-side rectification"):
            next(iter(mod.KittiDataset(str(kitti_dir)).frames(maps=maps, prefetch=False)))


def test_load_imu_csv_matches(euroc_dir, monkeypatch):
    """The native parse and the Python parse of a file with comment and blank
    lines agree with each other and with vslam_tpu's."""
    path = str(euroc_dir / "imu0" / "data.csv")
    native = tds.load_imu_csv(path)
    np.testing.assert_array_equal(native, jds.load_imu_csv(path))
    monkeypatch.setattr(tds, "_native", lambda: None)
    monkeypatch.setattr(jds, "_native", lambda: None)
    py = tds.load_imu_csv(path)
    np.testing.assert_array_equal(py, jds.load_imu_csv(path))
    np.testing.assert_array_equal(py, native)


def test_open_dataset_matches(kitti_dir, euroc_dir):
    t = tds.open_dataset(TConfig(str(kitti_dir / "config.yaml")))
    j = jds.open_dataset(JConfig(str(kitti_dir / "config.yaml")))
    assert type(t).__name__ == type(j).__name__ == "KittiDataset" and t.names == j.names
    cfg = euroc_dir.parent / "mono.yaml"
    cfg.write_text('dataset: "EuRoC"\nimagesPath: "mav0"\nslamMode: 2\n')
    t = tds.open_dataset(TConfig(str(cfg)), data_root=str(euroc_dir.parent))
    j = jds.open_dataset(JConfig(str(cfg)), data_root=str(euroc_dir.parent))
    assert type(t).__name__ == type(j).__name__ == "EurocDataset"
    assert t.mono and j.mono and t.root == j.root and t.names == j.names
