"""Host-only numpy helpers shared with vslam_tpu, loaded by file path.

``vslam_tpu/utils/synthetic.py`` (scene + renderer) and
``vslam_tpu/utils/trajectory.py`` (ATE) import only numpy at module top, so
the port reuses them as they are. They are loaded straight from their files
(``importlib.util.spec_from_file_location``) so ``vslam_tpu/__init__.py``,
which imports jax, never runs. ``trajectory.save_tum_trajectory`` imports
jax lazily and is not used by the port.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib
import sys
from types import ModuleType

_UTILS = pathlib.Path(__file__).resolve().parents[2] / "vslam_tpu" / "utils"


@functools.cache
def load(name: str) -> ModuleType:
    """Load ``vslam_tpu/utils/<name>.py`` as a standalone module."""
    if name not in ("synthetic", "trajectory"):
        raise ValueError(f"not a numpy-only host module: {name!r}")
    path = _UTILS / f"{name}.py"
    mod_name = f"vslam_torch.utils._host_{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered before exec: dataclasses resolves annotations through
    # sys.modules[cls.__module__]
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def make_scene(*args, **kwargs):
    """``vslam_tpu.utils.synthetic.make_scene`` (numpy only)."""
    return load("synthetic").make_scene(*args, **kwargs)


def ate_rmse(*args, **kwargs) -> float:
    """``vslam_tpu.utils.trajectory.ate_rmse`` (numpy only)."""
    return load("trajectory").ate_rmse(*args, **kwargs)
