"""The port's checkpoint (vslam_torch/utils/checkpoint.py) on the CPU: the
roundtrip and capacity adoption of tests/test_persistence.py:28-67, and
the file layout shared with vslam_tpu/utils/checkpoint.py: a JAX
checkpoint loads in the port with arrays equal to convert.world_from_jax
of the JAX world, a port checkpoint loads in JAX bit for bit (descriptor
words with bit 31 set included), and a version-2 file loads in both."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from vslam_torch.models import convert, map_state as tms, tracker as ttr
from vslam_torch.ops import hamming as tham
from vslam_torch.utils import checkpoint as tck
from vslam_tpu.models import map_state as jms, tracker as jtr
from vslam_tpu.utils import checkpoint as jck, synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
WORLD = dict(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
N_TRACKED = 6
TRACKER_FIELDS = ("pose", "prev_pose", "active_ids", "miss_age", "velocity", "bias")
TRACKER_META = ("frame_idx", "last_kf_tracked", "last_kf_frame", "last_kf_slot", "new_kf_slots")


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(n_frames=8, n_points=400, width=320, height=240, fps=10.0, seed=7)


def _torch_tracker(scene, world=None):
    world = world or tms.WorldMap(**WORLD, device="cpu")
    return ttr.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height, world,
        ttr.TrackerParams(**PARAMS), device="cpu",
    )


def _jax_tracker(scene, world=None):
    world = world or jms.WorldMap(**WORLD)
    return jtr.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height, world,
        jtr.TrackerParams(**PARAMS),
    )


def _tracked(make, scene):
    trk = make(scene)
    for f in range(N_TRACKED):
        trk.track(scene.render(f), scene.render(f, right=True))
    return trk


@pytest.fixture(scope="module")
def torch_trk(scene):
    return _tracked(_torch_tracker, scene)


@pytest.fixture(scope="module")
def jax_trk(scene):
    return _tracked(_jax_tracker, scene)


def _np_arrays(world) -> dict:
    """A world's map arrays as numpy, by field name (either package)."""
    return {
        f.name: (lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))(
            getattr(world.arrays, f.name)
        )
        for f in dataclasses.fields(world.arrays)
    }


def _assert_same_state(a, b):
    """Map arrays (bitwise, the file dtypes taken into account), host mirrors,
    counts and tracker fields of two (world, tracker) pairs."""
    (wa, ta), (wb, tb) = a, b
    xa, xb = _np_arrays(wa), _np_arrays(wb)
    for name in xa:
        np.testing.assert_array_equal(xa[name].astype(np.int64) if name in tck.FILE_DTYPES else xa[name],
                                      xb[name].astype(np.int64) if name in tck.FILE_DTYPES else xb[name],
                                      err_msg=name)
    for name in ("kf_obs_lm", "kf_obs_r_lm", "kf_frame_idx", "kf_poses_host"):
        np.testing.assert_array_equal(getattr(wa, name), getattr(wb, name), err_msg=name)
    assert (wa.n_landmarks, wa.n_keyframes) == (wb.n_landmarks, wb.n_keyframes)
    for name in TRACKER_FIELDS:
        np.testing.assert_array_equal(getattr(ta, name), getattr(tb, name), err_msg=name)
    for name in TRACKER_META:
        assert getattr(ta, name) == getattr(tb, name), name
    assert len(ta.frame_records) == len(tb.frame_records)
    for (sa, ra), (sb, rb) in zip(ta.frame_records, tb.frame_records):
        assert sa == sb
        np.testing.assert_array_equal(ra, rb)


def test_checkpoint_roundtrip_bitexact(tmp_path, scene):
    """Save, restore into a fresh world and tracker: the same state bit for
    bit, the tracker's device state rebuilt, and the next tracked frame
    agrees (within tests/test_persistence.py:48's 1e-5)."""
    trk = _tracked(_torch_tracker, scene)
    path = str(tmp_path / "ckpt.npz")
    tck.save_checkpoint(path, trk.world, trk)
    trk2 = _torch_tracker(scene)
    meta = tck.load_checkpoint(path, trk2.world, trk2)
    assert meta["n_keyframes"] == trk.world.n_keyframes >= 2 and meta["version"] == 3
    _assert_same_state((trk.world, trk), (trk2.world, trk2))
    assert not trk2._pending and trk2._kf_pending is None
    assert torch.equal(trk2._state["pose"], torch.from_numpy(trk.pose))
    assert torch.equal(trk2._state["prev_pose"], torch.from_numpy(trk.prev_pose))
    p_a = trk.track(scene.render(N_TRACKED), scene.render(N_TRACKED, right=True))
    p_b = trk2.track(scene.render(N_TRACKED), scene.render(N_TRACKED, right=True))
    np.testing.assert_allclose(p_a, p_b, atol=1e-5)


def test_checkpoint_capacity_adoption(tmp_path, torch_trk):
    """A checkpoint of a larger map grows a smaller world to match; a
    keys_per_kf mismatch raises."""
    world = torch_trk.world
    path = str(tmp_path / "ckpt.npz")
    tck.save_checkpoint(path, world)
    other = tms.WorldMap(lm_capacity=4096, kf_capacity=16, keys_per_kf=512, device="cpu")
    tck.load_checkpoint(path, other)
    assert (other.lm_capacity, other.kf_capacity) == (world.lm_capacity, world.kf_capacity)
    assert other.n_keyframes == world.n_keyframes
    np.testing.assert_array_equal(other.kf_obs_lm, world.kf_obs_lm)
    assert torch.equal(other.arrays.obs_desc, world.arrays.obs_desc)
    bad = tms.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=256, device="cpu")
    with pytest.raises(ValueError, match="keys_per_kf"):
        tck.load_checkpoint(path, bad)


def test_jax_checkpoint_loads_in_the_port(tmp_path, scene, jax_trk):
    """vslam_tpu's file -> the port: arrays torch.equal to
    convert.world_from_jax of the JAX world, tracker fields equal, the
    device state rebuilt from the restored map."""
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, jax_trk.world, jax_trk)
    trk = _torch_tracker(scene)
    meta = tck.load_checkpoint(path, trk.world, trk)
    assert meta["frame_idx"] == N_TRACKED
    conv = convert.world_from_jax(jax_trk.world, "cpu")
    for f in dataclasses.fields(conv.arrays):
        a, b = getattr(trk.world.arrays, f.name), getattr(conv.arrays, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    _assert_same_state((trk.world, trk), (jax_trk.world, jax_trk))
    ids = torch.from_numpy(trk.active_ids)
    assert torch.equal(trk._state["active"]["pos"], trk.world.arrays.lm_pos[ids.clamp(min=0)])


def _with_high_bits(trk, scene, path):
    """A copy of the port's tracked state whose first descriptor words have
    bit 31 set, saved to `path`."""
    copy = _torch_tracker(scene)
    tmp = path + ".src.npz"
    tck.save_checkpoint(tmp, trk.world, trk)
    tck.load_checkpoint(tmp, copy.world, copy)
    copy.world.arrays.obs_desc[0, 0, :3] = torch.tensor([0x80000001, 0xFFFFFFFF, 0xDEADBEEF])
    tck.save_checkpoint(path, copy.world, copy)
    return copy


def test_port_checkpoint_loads_in_jax(tmp_path, scene, torch_trk):
    """The port's file -> vslam_tpu: every array equal bit for bit (int32 /
    uint32 on file), the 32-bit words with bit 31 set included, and the
    same file back in the port gives the port's int64 words."""
    path = str(tmp_path / "port.npz")
    src = _with_high_bits(torch_trk, scene, path)
    data = np.load(path)
    assert data["map.obs_desc"].dtype == np.uint32 and data["map.obs_lm"].dtype == np.int32
    assert list(data["map.obs_desc"][0, 0, :3]) == [0x80000001, 0xFFFFFFFF, 0xDEADBEEF]
    jt = _jax_tracker(scene)
    jck.load_checkpoint(path, jt.world, jt)
    _assert_same_state((jt.world, jt), (src.world, src))
    assert np.asarray(jt.world.arrays.obs_desc).dtype == np.uint32
    back = _torch_tracker(scene)
    tck.load_checkpoint(path, back.world, back)
    assert torch.equal(back.world.arrays.obs_desc, src.world.arrays.obs_desc)
    assert back.world.arrays.obs_desc[0, 0, :3].tolist() == [0x80000001, 0xFFFFFFFF, 0xDEADBEEF]


def test_version2_file_loads_in_both(tmp_path, scene, torch_trk):
    """A v2 file (obs_desc as +-1 int8, (W, K, 256)) is packed on load: the
    same words in the port as the v3 file, and the same in JAX."""
    v3 = str(tmp_path / "v3.npz")
    src = _with_high_bits(torch_trk, scene, v3)
    data = dict(np.load(v3))
    data["map.obs_desc"] = tham.unpack_signed_np(data["map.obs_desc"])
    meta = json.loads(bytes(data["meta_json"]).decode())
    meta["version"] = 2
    data["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    v2 = str(tmp_path / "v2.npz")
    np.savez(v2, **data)
    t = _torch_tracker(scene)
    assert tck.load_checkpoint(v2, t.world, t)["version"] == 2
    assert torch.equal(t.world.arrays.obs_desc, src.world.arrays.obs_desc)
    jt = _jax_tracker(scene)
    jck.load_checkpoint(v2, jt.world, jt)
    np.testing.assert_array_equal(np.asarray(jt.world.arrays.obs_desc).astype(np.int64),
                                  src.world.arrays.obs_desc.numpy())
