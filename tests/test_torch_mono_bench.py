"""The bench's mono-inertial scene (bench.py:175-241: seed 11, 900 points,
20 fps, distinct texture, lateral motion; 1024 features, 8 levels, 4096
active) at half its 752x480 size, through MonoTracker and the mapper's
mono triangulation in both packages on the CPU, as far as the init
triangulation and two frames past it: the same bootstrap views and gates,
the same init frame and the same init landmarks."""

import numpy as np
import torch

from vslam_torch.models import local_mapper as tlm, map_state as tms, tracker as ttr
from vslam_tpu.models import local_mapper as jlm, map_state as jms, tracker as jtr
from vslam_tpu.utils import datasets, synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

W, H = 376, 240  # half of bench.py:185's 752x480
PARAMS = dict(n_features=1024, n_levels=8, active_size=4096)
WORLD = dict(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)
N_FRAMES = 12


def _dt_rows(bins, f):
    """bench.py:206-214's per-frame [dt, gyro, accel] rows."""
    rows = bins[f]
    if rows is None or len(rows) == 0:
        return None
    t = rows[:, 0]
    dts = np.diff(np.concatenate([[t[0] - 1.0 / 200.0], t]))
    return np.concatenate([np.maximum(dts, 0)[:, None], rows[:, 1:7]], axis=1).astype(np.float32)


def _run(port: bool, scene, frames, bins) -> dict:
    """bench.py:218-228's step over the frames; returns the bootstrap,
    the init handoff and the poses."""
    pkg, maps, mapper_mod = (ttr, tms, tlm) if port else (jtr, jms, jlm)
    dev = dict(device="cpu") if port else {}
    K = scene.K.astype(np.float32)
    world = maps.WorldMap(**WORLD, **dev)
    imu_cfg = pkg.ImuConfig(
        gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3, hz=200.0,
        T_bc=np.eye(4, dtype=np.float32), gravity_w=synthetic.GRAVITY_W.astype(np.float32),
    )
    trk = pkg.MonoTracker(K, W, H, world, pkg.TrackerParams(**PARAMS), imu_cfg=imu_cfg, **dev)
    trk.velocity = scene.velocities[0].astype(np.float32)
    mapper = mapper_mod.LocalMapper(world, K, 0.0, mapper_mod.LocalMapperConfig(n_levels=8))
    out = {"init_ids": None, "poses": []}
    for f, img in enumerate(frames):
        nk = len(trk.new_kf_slots)
        out["poses"].append(np.asarray(trk.track(img, imu=_dt_rows(bins, f))))
        if trk.needs_init_triangulation:
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            out["init_ids"], out["init_frame"] = np.asarray(ids), f
            trk.add_active(ids)
            trk.needs_init_triangulation = False
            trk.last_kf_tracked = max(len(ids), 1)
        elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
            trk.add_active(mapper.find_new_points(trk.new_kf_slots[-1], mono=True))
    out["trk"] = trk
    return out


def test_bench_mono_scene_init_matches_jax():
    """Identical bootstrap_slots, gate_slots, init frame and init landmark
    ids; every pose within 1e-3 (tests/test_torch_mono.py's tracked-pose
    tolerance). The counts are printed beside the chip run's (752x480)."""
    scene = synthetic.make_scene(n_frames=N_FRAMES, n_points=900, width=W, height=H, fps=20.0,
                                 seed=11, texture="distinct", motion="lateral")
    frames = [scene.render(f) for f in range(N_FRAMES)]
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    j, t = _run(False, scene, frames, bins), _run(True, scene, frames, bins)
    jt, tt = j["trk"], t["trk"]
    print(f"[bench mono {W}x{H}] views {tt.bootstrap_slots} gates {tt.gate_slots} "
          f"init frame {t['init_frame']} init landmarks {len(t['init_ids'])} (JAX {len(j['init_ids'])})")
    assert tt.initialized and jt.initialized
    assert tt.bootstrap_slots == jt.bootstrap_slots and tt.gate_slots == jt.gate_slots
    assert t["init_frame"] == j["init_frame"] < N_FRAMES - 2
    np.testing.assert_array_equal(t["init_ids"], j["init_ids"])
    np.testing.assert_allclose(np.stack(t["poses"]), np.stack(j["poses"]), atol=1e-3, rtol=0)
