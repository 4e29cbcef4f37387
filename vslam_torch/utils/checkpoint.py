"""Checkpoint / resume of the full SLAM state (the port of
vslam_tpu/utils/checkpoint.py).

The file layout is the JAX package's, so a checkpoint written by either
package loads in the other: an .npz with one ``map.<field>`` array per
MapArrays field, the ``host.*`` mirrors, the tracker's ``trk.*`` runtime
state and a ``meta_json`` blob. The JAX map holds its index fields as
int32 and its packed descriptor words as uint32, the port as int64
(map_state.py): on write the arrays take JAX's dtypes, on load they are
widened again and placed on the world's device.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from vslam_torch.models import map_state
from vslam_torch.ops import hamming

FORMAT_VERSION = 3  # v3: obs_desc stored bit-packed (W, K, 8) uint32
# v2: majority-descriptor accumulator fields (lm_bitsum, lm_nobs);
#     obs_desc in the +-1 int8 (W, K, 256) form, packed on load

# the MapArrays fields whose on-file dtype (vslam_tpu/models/map_state.py)
# differs from the port's int64
FILE_DTYPES = {
    "obs_oct": np.int32,
    "obs_lm": np.int32,
    "obs_r_oct": np.int32,
    "obs_r_lm": np.int32,
    "obs_desc": np.uint32,  # 32-bit words; the port's int64 words hold the same bits
}


def _to_file(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    return a.astype(FILE_DTYPES[name]) if name in FILE_DTYPES else a


def _from_file(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype in (np.int32, np.uint32):
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save_checkpoint(path: str, world: map_state.WorldMap, tracker=None) -> None:
    """Write the map (and, given one, the tracker's runtime state) to `path`
    (.npz). The tracker's pipeline is drained first; the caller drains any
    BA in flight (``VSlamSystem.exit()``). Atomic: written to a temporary
    file, then renamed."""
    if tracker is not None:
        tracker.flush()
    m = world.arrays
    blobs = {f"map.{f.name}": _to_file(f.name, getattr(m, f.name)) for f in dataclasses.fields(m)}
    blobs.update(
        {
            "host.kf_obs_lm": world.kf_obs_lm,
            "host.kf_obs_r_lm": world.kf_obs_r_lm,
            "host.kf_frame_idx": world.kf_frame_idx,
            "host.kf_poses": world.kf_poses_host,
            # the JAX world's first-observer mirror: it is never written
            # there (all -1), and the port has none
            "host.lm_first_kf": np.full(world.lm_capacity, -1, np.int64),
        }
    )
    meta = {
        "version": FORMAT_VERSION,
        "n_landmarks": world.n_landmarks,
        "n_keyframes": world.n_keyframes,
        "lm_capacity": world.lm_capacity,
        "kf_capacity": world.kf_capacity,
        "keys_per_kf": world.keys_per_kf,
    }
    if tracker is not None:
        blobs.update(
            {
                "trk.pose": tracker.pose,
                "trk.prev_pose": tracker.prev_pose,
                "trk.active_ids": tracker.active_ids,
                "trk.miss_age": tracker.miss_age,
                "trk.velocity": tracker.velocity,
                "trk.bias": tracker.bias,
            }
        )
        meta.update(
            {
                "frame_idx": tracker.frame_idx,
                "last_kf_tracked": tracker.last_kf_tracked,
                "last_kf_frame": tracker.last_kf_frame,
                "last_kf_slot": tracker.last_kf_slot,
                "new_kf_slots": tracker.new_kf_slots,
                "frame_records": [[int(s), rel.tolist()] for s, rel in tracker.frame_records],
            }
        )
    blobs["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"  # savez appends .npz unless present
    np.savez_compressed(tmp, **blobs)
    os.replace(tmp, path)


def load_checkpoint(path: str, world: map_state.WorldMap, tracker=None) -> dict:
    """Restore state saved by :func:`save_checkpoint` (by either package)
    into `world`, on its device (and into `tracker` if given, whose device
    state is rebuilt on its own device). Returns the metadata dict."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta_json"]).decode())
    if meta["version"] not in (2, FORMAT_VERSION):
        raise ValueError(f"checkpoint version {meta['version']} != {FORMAT_VERSION}")
    if meta["keys_per_kf"] != world.keys_per_kf:
        raise ValueError(
            f"checkpoint keys_per_kf={meta['keys_per_kf']} does not match world "
            f"keys_per_kf={world.keys_per_kf}"
        )
    # a checkpoint taken after the map grew restores into a smaller world
    # by growing it first; a smaller checkpoint cannot be adopted (the
    # restored arrays define the capacity)
    if meta["lm_capacity"] > world.lm_capacity:
        world.grow_landmarks(meta["lm_capacity"])
    if meta["kf_capacity"] > world.kf_capacity:
        world.grow_keyframes(meta["kf_capacity"])
    for cap in ("lm_capacity", "kf_capacity"):
        if meta[cap] != getattr(world, cap):
            raise ValueError(
                f"checkpoint {cap}={meta[cap]} does not match world {cap}={getattr(world, cap)}"
            )
    kwargs = {
        f.name: _from_file(data[f"map.{f.name}"], world.device)
        for f in dataclasses.fields(world.arrays)
    }
    if meta["version"] == 2:
        kwargs["obs_desc"] = hamming.pack_signed(kwargs["obs_desc"])
    world.arrays = map_state.MapArrays(**kwargs)
    world.kf_obs_lm = data["host.kf_obs_lm"].copy()
    if "host.kf_obs_r_lm" in data:
        world.kf_obs_r_lm = data["host.kf_obs_r_lm"].copy()
    world.kf_frame_idx = data["host.kf_frame_idx"].copy()
    world.kf_poses_host = data["host.kf_poses"].copy()
    world.n_landmarks = meta["n_landmarks"]
    world.n_keyframes = meta["n_keyframes"]
    if tracker is not None and "trk.pose" in data:
        tracker.pose = data["trk.pose"].copy()
        tracker.prev_pose = data["trk.prev_pose"].copy()
        tracker.active_ids = data["trk.active_ids"].copy()
        tracker.miss_age = data["trk.miss_age"].copy()
        tracker.velocity = data["trk.velocity"].copy()
        tracker.bias = data["trk.bias"].copy()
        tracker.frame_idx = meta["frame_idx"]
        tracker.last_kf_tracked = meta["last_kf_tracked"]
        tracker.last_kf_frame = meta["last_kf_frame"]
        tracker.last_kf_slot = meta["last_kf_slot"]
        tracker.new_kf_slots = list(meta["new_kf_slots"])
        tracker.frame_records = [
            (int(s), np.asarray(rel, np.float32)) for s, rel in meta["frame_records"]
        ]
        # rebuild the device-resident state for the next step
        tracker._D = np.eye(4, dtype=np.float32)
        tracker._pending.clear()
        tracker._kf_pending = None
        tracker._state = tracker._fresh_state(tracker.pose)
        tracker._state["prev_pose"] = tracker._to_device(tracker.prev_pose)
    return meta
