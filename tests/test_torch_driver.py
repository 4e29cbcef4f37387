"""The port's synthetic driver (``python -m vslam_torch.run_synthetic``) on
the CPU: a few frames of the EuRoC-geometry scene at its full width
through the async facade (the loop circuit with loop closure on), the
scene table and config it shares with examples/run_synthetic.py, --viz,
and the dataset driver's --shards."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import yaml

from vslam_torch import run_dataset, run_synthetic
from vslam_torch.utils.config import ConfigFile

torch.set_num_threads(2)  # xdist runs several workers on one box

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    """examples/run_synthetic.py as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        "example_run_synthetic", os.path.join(REPO, "examples", "run_synthetic.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "argv, scene, n",
    [([], "euroc", 4), (["--global-ba"], "euroc", 8), (["--scene", "mono"], "mono", 9)],
)
def test_driver_runs_on_the_cpu(capsys, argv, scene, n):
    """A few frames of the 752x480 scenes (1024 features): EuRoC-geometry
    stereo with the async BA, the same with a global BA after it, and the
    monocular-inertial lateral scene (its IMU bootstrap, the init
    triangulation, tracked frames): a finite trajectory close to the exact
    ground truth, and the example's [result] line."""
    r = run_synthetic.main(["--device", "cpu", "--frames", str(n)] + argv)
    out = capsys.readouterr().out
    assert f"[result] {n} frames" in out and "ATE RMSE vs exact GT" in out
    assert r["device"] == "cpu" and r["frames"] == n and r["scene"] == scene
    assert np.isfinite(r["ate_m"]) and r["ate_m"] < 0.05
    assert r["keyframes"] >= 1 and r["landmarks"] > 100 and r["fps"] > 0
    if "--global-ba" in argv:
        assert r["ba_runs"] >= 1 and np.isfinite(r["global_ba_error"])
        assert abs(r["ate_m"] - r["ate_before_global_ba_m"]) < 0.01


def test_driver_loop_scene_runs_on_the_cpu(capsys):
    """--scene loop builds the circuit at its 512x384 width with loop
    closure on (256 keyframe slots) and reports its closures. The circuit
    spreads its 1.1 laps over the frames asked for, so 6 frames turn ~66
    degrees each: no tracking holds there and no closure can fire; the
    circuit itself runs on the card (chip_smoke.py phase 16) and in the
    slow test of tests/test_torch_loop_closure.py."""
    r = run_synthetic.main(["--device", "cpu", "--frames", "6", "--scene", "loop"])
    out = capsys.readouterr().out
    assert "[scene] closed circuit + loop closure: 512x384" in out
    assert "[result] 6 frames" in out and "| loop closures: 0" in out
    assert r["scene"] == "loop" and r["frames"] == 6 and r["loop_closures"] == 0
    assert np.isfinite(r["ate_m"]) and r["keyframes"] >= 1


def test_driver_scenes_and_config_match_the_example(tmp_path):
    """The scene table and the config are examples/run_synthetic.py's."""
    ex = _example()
    assert run_synthetic.SCENES == ex.SCENES
    for name, (W, H, fps, _, nfeat, _) in ex.SCENES.items():
        (tmp_path / name).mkdir()
        with open(ex._write_config(tmp_path / name, W, H, fps, nfeat, 1)) as f:
            theirs = yaml.safe_load(f)
        assert run_synthetic.config(W, H, fps, nfeat, 1) == theirs
        assert ConfigFile.from_dict(theirs).slam_mode == 1


def test_driver_viz_writes_the_viewer(tmp_path, capsys):
    """--viz writes the map viewer after the run (examples/run_synthetic.py:125-131):
    one frustum per keyframe, the trajectory, the landmarks."""
    html = tmp_path / "m.html"
    r = run_synthetic.main(["--device", "cpu", "--frames", "4", "--viz", str(html)])
    assert f"[viz] -> {html}" in capsys.readouterr().out
    page = html.read_text()
    data = json.loads(page[page.index("const DATA = ") + 13 : page.index(";\n", page.index("const DATA = "))])
    assert len(data["frusta"]) == r["keyframes"] and len(data["traj"]) == 4
    assert len(data["points"]) == len(data["active"]) > 100


@pytest.mark.parametrize("argv, item", [pytest.param(["--shards", "2"], "A12", id="shards-A12")])
def test_driver_options_not_ported_raise(tmp_path, argv, item):
    """The dataset driver's --shards N (ROADMAP A12, the mesh-sharded BA,
    once not ported) runs: 4 frames of a 320x240 KITTI-layout sequence with
    the bundle adjustments over 2 virtual CPU shards."""
    from PIL import Image

    from vslam_torch.utils import synthetic

    W, H, n = 320, 240, 4
    scene = synthetic.make_scene(n_frames=n, n_points=400, width=W, height=H, fps=10.0, seed=7)
    for right, sub in ((False, "image_0"), (True, "image_1")):
        os.makedirs(tmp_path / sub)
        for f in range(n):
            img = np.clip(scene.render(f, right=right), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / sub / f"{f:06d}.png")
    np.savetxt(tmp_path / "times.txt", scene.times)
    conf = run_synthetic.config(W, H, 10.0, 512, 1)
    conf["imagesPath"] = str(tmp_path)
    conf["FE"]["nLevels"] = 4
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump(conf))
    out = tmp_path / "traj.txt"
    r = run_dataset.main([str(cfg), "--device", "cpu", "--out", str(out)] + argv)
    assert r["frames"] == n, item
    assert np.loadtxt(out).shape == (n, 12)
