"""Carry map and tracker state across from vslam_tpu.

The system has no learned weights: what carries across is the BRIEF
pattern (numpy, shared by construction), the map, the tracker state and a
bundle-adjustment problem. The functions take the JAX objects already fetched to numpy
(``jax.tree.map(np.asarray, ...)``), so this module imports no JAX.

dtype changes: int32 -> int64 (torch indexing), packed uint32 descriptor
words -> int64 words holding the same 32 bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vslam_torch.models import map_state
from vslam_torch.ops import imu, schur


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype in (np.int32, np.uint32):
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy()).to(device)


def map_arrays_from_jax(arrays: dict, device) -> map_state.MapArrays:
    """A vslam_tpu ``MapArrays`` as a dict of numpy arrays (field name ->
    array) -> the port's MapArrays on `device`."""
    names = [f.name for f in dataclasses.fields(map_state.MapArrays)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"MapArrays fields missing: {sorted(missing)}")
    return map_state.MapArrays(**{k: _tensor(arrays[k], device) for k in names})


def tracker_state_from_jax(state: dict, host: dict, device) -> tuple[dict, dict]:
    """A vslam_tpu tracker's device state (``StereoTracker._state``: pose,
    prev_pose, vel, bias, active{ids, pos, desc, maxdist, mindist, valid},
    miss_age) and host bookkeeping (active_ids, miss_age, frame_records,
    new_kf_slots; for a ``MonoTracker`` also initialized, bootstrap_slots,
    gate_slots, needs_init_triangulation), as numpy -> (the port's state
    dict on `device`, host bookkeeping with the port's dtypes). `state` may
    be None: a mono tracker still in its bootstrap has no device state."""
    state_t = None
    if state is not None:
        state_t = {
            k: _tensor(state[k], device) for k in ("pose", "prev_pose", "vel", "bias", "miss_age")
        }
        state_t["active"] = {k: _tensor(v, device) for k, v in state["active"].items()}
    host_t = {
        "active_ids": np.asarray(host["active_ids"], np.int64).copy(),
        "miss_age": np.asarray(host["miss_age"], np.int64).copy(),
        "frame_records": [
            (int(s), np.asarray(rel, np.float32).copy()) for s, rel in host["frame_records"]
        ],
        "new_kf_slots": [int(s) for s in host["new_kf_slots"]],
    }
    for k in ("bootstrap_slots", "gate_slots"):
        if k in host:
            host_t[k] = [int(s) for s in host[k]]
    for k in ("initialized", "needs_init_triangulation"):
        if k in host:
            host_t[k] = bool(host[k])
    return state_t, host_t


def imu_const_from_jax(imu_const, device) -> tuple:
    """A vslam_tpu tracker's IMU constants (``StereoTracker._imu_const``:
    gravity_w (3,), T_bc (4, 4), ImuParams), as numpy -> the port's
    (gravity_w, T_bc) tensors on `device` and its ImuParams of floats:
    the last three entries of ``_track_step``'s `imu` argument."""
    gravity_w, T_bc, params = imu_const
    return (
        _tensor(np.asarray(gravity_w, np.float32), device),
        _tensor(np.asarray(T_bc, np.float32), device),
        imu.ImuParams(*(float(x) for x in params)),
    )


def ba_problem_from_jax(problem: dict, device) -> schur.BAProblem:
    """A vslam_tpu ``schur.BAProblem`` as a dict of numpy arrays (field
    name -> array, e.g. ``{k: np.asarray(v) for k, v in p._asdict().items()}``)
    -> the port's BAProblem on `device`."""
    missing = set(schur.BAProblem._fields) - set(problem)
    if missing:
        raise KeyError(f"BAProblem fields missing: {sorted(missing)}")
    return schur.BAProblem(**{k: _tensor(problem[k], device) for k in schur.BAProblem._fields})
