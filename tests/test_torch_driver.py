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


def test_driver_runs_on_the_cpu(capsys):
    """Four frames of the 752x480 EuRoC-geometry scene (1024 features,
    async BA): a finite trajectory close to the exact ground truth, and
    the example's [result] line."""
    r = run_synthetic.main(["--device", "cpu", "--frames", "4"])
    out = capsys.readouterr().out
    assert "[result] 4 frames" in out and "ATE RMSE vs exact GT" in out
    assert r["device"] == "cpu" and r["frames"] == 4 and r["scene"] == "euroc"
    assert np.isfinite(r["ate_m"]) and r["ate_m"] < 0.05
    assert r["keyframes"] >= 1 and r["landmarks"] > 100 and r["fps"] > 0


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


@pytest.mark.parametrize(
    "argv, item",
    [(["--scene", "mono"], "A9"), (["--scene", "loop"], "A10"), (["--viz", "m.html"], "A8"),
     (["--global-ba"], "A11")],
)
def test_driver_options_not_ported_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        run_synthetic.main(["--device", "cpu"] + argv)
