"""The port's synthetic driver (``python -m vslam_torch.run_synthetic``) on
the CPU: a few frames of the EuRoC-geometry scene at its full width
through the async facade, the scene table and config it shares with
examples/run_synthetic.py, and the options that are not ported yet."""

import importlib.util
import os

import numpy as np
import pytest
import torch
import yaml

from vslam_torch import run_synthetic
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


@pytest.mark.parametrize("argv, item", [(["--scene", "loop"], "A10"), (["--viz", "m.html"], "A8")])
def test_driver_options_not_ported_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        run_synthetic.main(["--device", "cpu"] + argv)
