"""One run's input: a configuration's rig under a traffic mix, rendered
from the seed.

The configuration (``configs/<name>.json``) and the traffic
(``traffic/<name>.json``) are found by the names ``BENCHMARK.json`` gives
a cell. The frames are rendered anew in every run, by the frozen generator
(scene.py) in a pool of spawned processes, one per core, as 8-bit images
(what a camera delivers): every run's set-up pays the same render.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import pathlib

import numpy as np

from perfbench import scene as scene_mod

HERE = pathlib.Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under this folder (kind: configs, traffic,
    limits)."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Sequence:
    config: dict
    traffic: dict
    seed: int
    scene: scene_mod.SyntheticScene  # the exact world: poses, landmarks, IMU
    left: np.ndarray  # (N, H, W) uint8
    right: np.ndarray  # (N, H, W) uint8

    @property
    def n_frames(self) -> int:
        return len(self.left)

    def imu_rows(self, i: int) -> np.ndarray | None:
        """The (K, 7) [t, gyro, accel] IMU rows after frame i-1 up to and
        including frame i (None for frame 0 and for a rig without IMU)."""
        if i == 0 or "IMU" not in self.config["system"]:
            return None
        t = self.scene.imu[:, 0]
        lo, hi = self.scene.times[i - 1], self.scene.times[i]
        sel = (t > lo + 1e-9) & (t <= hi + 1e-9)
        return self.scene.imu[sel]


_WORKER_SCENE = None


def _worker_init(rig, traffic, seed):
    global _WORKER_SCENE
    _WORKER_SCENE = scene_mod.make_sequence(rig, traffic, seed)


def _render(job):
    i, right = job
    img = _WORKER_SCENE.render(i, right=right)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def render_frames(sc: scene_mod.SyntheticScene, rig, traffic, seed, processes: int):
    """Every view of the sequence, (N, H, W) uint8 left and right."""
    n = len(sc.times)
    jobs = [(i, r) for i in range(n) for r in (False, True)]
    if processes <= 1:
        global _WORKER_SCENE
        _WORKER_SCENE = sc
        imgs = [_render(j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes, initializer=_worker_init, initargs=(rig, traffic, seed)) as pool:
            imgs = pool.map(_render, jobs, chunksize=max(1, len(jobs) // (4 * processes)))
    stack = np.stack(imgs).reshape(n, 2, sc.height, sc.width)
    return np.ascontiguousarray(stack[:, 0]), np.ascontiguousarray(stack[:, 1])


def load(config_name: str, traffic_name: str, seed: int, *, processes: int | None = None,
         overrides: dict | None = None) -> Sequence:
    """The sequence of (configuration, traffic, seed), rendered.
    `overrides` replaces top-level keys of the traffic and merges into the
    configuration's system (the CPU tests' small sizes)."""
    config = load_json("configs", config_name)
    traffic = load_json("traffic", traffic_name)
    if overrides:
        traffic = {**traffic, **overrides.get("traffic", {})}
        config = {**config, "system": _merge(config["system"], overrides.get("system", {}))}
    rig = scene_mod.Rig.from_system(config["system"])
    sc = scene_mod.make_sequence(rig, traffic, seed)
    if processes is None:
        processes = len(os.sched_getaffinity(0))
    left, right = render_frames(sc, rig, traffic, seed, processes)
    return Sequence(config=config, traffic=traffic, seed=seed, scene=sc, left=left, right=right)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out
