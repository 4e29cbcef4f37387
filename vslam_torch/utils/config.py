"""YAML configuration system (port of vslam_tpu/utils/config.py).

Same schema and accessors as the reference loader. Two differences: PyYAML
is imported only when a file is actually loaded (the GPU machine is not
promised PyYAML), and :meth:`ConfigFile.from_dict` builds a config from a
plain dict with no file at all.
"""

from __future__ import annotations

import enum
import os
from typing import Any, Sequence

import numpy as np


class SlamMode(enum.IntEnum):
    """reference include/System.h:21-26."""

    STEREO_IMU = 0
    STEREO = 1
    MONOCULAR = 2  # mono + IMU
    MONO_IMU = 2  # alias (same mode; the reference's monocular requires IMU)


class ConfigFile:
    """Typed YAML accessor mirroring ConfigFile::getValue<T>(a, b, c)
    (reference include/Settings.h:19-28) with up-to-N-level nesting."""

    _MISSING = object()

    def __init__(self, path: str, search_dirs: Sequence[str] = ()):  # noqa: D401
        resolved = self._resolve(path, search_dirs)
        if resolved is None:
            raise FileNotFoundError(
                f"Config file not found: {path!r} (searched cwd and {list(search_dirs)})"
            )
        import yaml

        with open(resolved, "r") as f:
            data = yaml.safe_load(f)
        self._init(data, resolved)

    @classmethod
    def from_dict(cls, data: dict, path: str = "<dict>") -> "ConfigFile":
        """A config from an already-parsed mapping (no file, no PyYAML)."""
        cfg = cls.__new__(cls)
        cfg._init(data, path)
        return cfg

    def _init(self, data: Any, path: str):
        self.path = path
        self.data: dict[str, Any] = data
        self.bad_file = data is None
        if self.bad_file:
            raise ValueError(f"Config file is empty: {path}")

    @staticmethod
    def _resolve(path: str, search_dirs: Sequence[str]) -> str | None:
        if os.path.isfile(path):
            return path
        for d in search_dirs:
            cand = os.path.join(d, path)
            if os.path.isfile(cand):
                return cand
        here = os.path.join(os.path.dirname(__file__), "..", "..", "configs", path)
        if os.path.isfile(here):
            return os.path.normpath(here)
        return None

    def get(self, *keys: str, default: Any = _MISSING) -> Any:
        node: Any = self.data
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                if default is not ConfigFile._MISSING:
                    return default
                raise KeyError(f"Missing config key: {'.'.join(keys)} in {self.path}")
            node = node[k]
        return node

    # C++-style alias used in docs/tests for parity with the reference API.
    getValue = get

    def get_matrix(self, *keys: str, default: Any = _MISSING) -> np.ndarray | Any:
        """Read a {rows, cols, data} block (e.g. T_bc1, Camera_l.K) as an
        ndarray, matching the cv::FileStorage-style blocks in the configs."""
        node = self.get(*keys, default=ConfigFile._MISSING if default is ConfigFile._MISSING else None)
        if node is None:
            return default
        rows, cols = int(node["rows"]), int(node["cols"])
        return np.asarray(node["data"], dtype=np.float64).reshape(rows, cols)

    @property
    def slam_mode(self) -> SlamMode:
        return SlamMode(int(self.get("slamMode")))

    @property
    def rectified(self) -> bool:
        return bool(self.get("rectified", default=True))

    @property
    def dataset(self) -> str:
        return str(self.get("dataset", default="KITTI"))
