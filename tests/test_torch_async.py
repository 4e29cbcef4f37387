"""The port's async local BA (``VSlamSystem(async_ba=True)``) against
vslam_tpu on the CPU, on tests/test_torch_mapper.py's scene (320x240, 512
features, 4 levels, 12 frames, seed 7). With ``deterministic_ba_latency``
both packages follow one schedule: phase A at the keyframe, the write-back
behind the second tracked frame after it, the consume before the third.
On this scene that schedule gives another trajectory than the sync mapper
(checked), so the comparison holds the schedule, not only the BA. Also: a
keyframe while a BA is in flight (forced consume), ``exit()`` draining,
the readiness-polled mode, an error on the worker thread, and the worker
path against the sync path."""

import numpy as np
import pytest
import torch
import yaml

from vslam_torch.models import local_mapper as tlm, system as tsys, tracker as ttr
from vslam_torch.utils import trajectory as ttraj
from vslam_torch.utils.config import ConfigFile as TConfig
from vslam_tpu.models import system as jsys, tracker as jtr
from vslam_tpu.utils import synthetic, trajectory as jtraj
from vslam_tpu.utils.config import ConfigFile as JConfig

torch.set_num_threads(2)  # xdist runs several workers on one box

W, H = 320, 240
FX, BL = 460.0, 0.12
N_FRAMES = 12
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
CAPS = dict(lm_capacity=8192, kf_capacity=64)


def _config() -> dict:
    cam = {"fx": FX, "fy": FX, "cx": W / 2.0, "cy": H / 2.0}
    return {
        "rectified": True, "slamMode": 1, "dataset": "KITTI",
        "imagesPath": "/nonexistent", "fileExtension": ".png",
        "Camera": {"width": W, "height": H, "fps": 10.0, "bl": BL},
        "Camera_l": dict(cam), "Camera_r": dict(cam),
        "FE": {"nFeatures": 512, "nLevels": 4, "imScale": 1.2, "edgeThreshold": 19,
               "maxFastThreshold": 20, "minFastThreshold": 7},
    }


@pytest.fixture(scope="module")
def scene():
    s = synthetic.make_scene(n_frames=N_FRAMES, n_points=400, width=W, height=H, fps=10.0, seed=7)
    s.frames = [(s.render(f), s.render(f, right=True)) for f in range(N_FRAMES)]
    return s


@pytest.fixture(scope="module")
def jconf(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "config.yaml"
    path.write_text(yaml.safe_dump(_config()))
    return str(path)


def _system(port: bool, jconf: str, async_ba=True, latency=2, deterministic=True):
    if port:
        s = tsys.VSlamSystem(TConfig.from_dict(_config()), async_ba=async_ba, **CAPS,
                             tracker_params=ttr.TrackerParams(**PARAMS), device="cpu")
    else:
        s = jsys.VSlamSystem(JConfig(jconf), async_ba=async_ba, **CAPS,
                             tracker_params=jtr.TrackerParams(**PARAMS))
    s.ba_latency_frames = latency
    s.deterministic_ba_latency = deterministic
    return s


def _run(sys_, scene) -> dict:
    """Track every frame, logging each consume as (frame count, forced),
    and whether a BA was still in flight when exit() began."""
    log = []
    consume = sys_._consume_ba_results

    def logged(force=False):
        had = sys_._pending_ba is not None
        consume(force)
        if had and sys_._pending_ba is None:
            log.append((sys_._frame_count, force))

    sys_._consume_ba_results = logged
    for left, right in scene.frames:
        sys_.track_stereo(left, right)
    in_flight_at_exit = sys_._pending_ba is not None
    sys_.exit()
    return {"sys": sys_, "poses": sys_.trajectory(), "consumes": log,
            "in_flight_at_exit": in_flight_at_exit}


@pytest.fixture(scope="module")
def runs(scene, jconf):
    out = {
        "jax_sync": _run(_system(False, jconf, async_ba=False), scene),
        "jax": _run(_system(False, jconf), scene),
        "torch": _run(_system(True, jconf), scene),
        # a consume latency past the keyframe spacing: the next keyframe
        # arrives with a BA in flight and forces its consume
        "jax_late": _run(_system(False, jconf, latency=4), scene),
        "torch_late": _run(_system(True, jconf, latency=4), scene),
    }
    return out


def _assert_same(rt, rj, scene):
    ts, js = rt["sys"], rj["sys"]
    assert ts.tracker.new_kf_slots == js.tracker.new_kf_slots
    n = js.world.n_keyframes
    np.testing.assert_array_equal(ts.world.kf_frame_idx[:n], js.world.kf_frame_idx[:n])
    assert ts.mapper.ba_count == js.mapper.ba_count >= 2
    # the allocator's high-water mark: phase A's spawn slots stay allocated
    # until the consume, so keyframes in between allocate above them
    assert ts.world.n_landmarks == js.world.n_landmarks
    assert rt["consumes"] == rj["consumes"]
    assert rt["poses"].shape == rj["poses"].shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(rt["poses"], rj["poses"], atol=1e-3, rtol=0)
    gt = scene.poses_c2w[:N_FRAMES]
    ate_j = jtraj.ate_rmse(rj["poses"], gt, align=False)
    ate_t = ttraj.ate_rmse(rt["poses"], gt, align=False)
    assert ate_j < 0.03 and ate_t < 0.03, (ate_j, ate_t)
    assert ts._pending_ba is None and js._pending_ba is None


def test_async_system_matches_jax(scene, runs):
    """The deterministic async facade: the same keyframes at the same
    frames, the same BA count, consume points and landmark count, poses
    within 1e-3, both ATEs under 0.03 m; and JAX's async trajectory is not
    its sync one."""
    _assert_same(runs["torch"], runs["jax"], scene)
    assert np.abs(runs["jax"]["poses"] - runs["jax_sync"]["poses"]).max() > 1e-3
    m = runs["torch"]["sys"].mapper.metrics.summary()
    assert m["ba_join"]["count"] == m["ba_worker"]["count"] == runs["torch"]["sys"].mapper.ba_count
    assert m["ba_worker"]["total_s"] > 0.0


def test_forced_consume_and_exit_drain_match_jax(scene, runs):
    """A keyframe while a BA is in flight consumes it first, and exit()
    drains the last one; both packages do it at the same frames."""
    rt, rj = runs["torch_late"], runs["jax_late"]
    _assert_same(rt, rj, scene)
    forced = [c for c in rt["consumes"][:-1] if c[1]]
    assert forced, rt["consumes"]  # at least one forced consume while tracking
    assert rt["in_flight_at_exit"] and rt["consumes"][-1][1]  # exit() drained one


def test_nondeterministic_latency_completes(scene):
    """Readiness-polled consumes: the run completes, its ATE holds, and
    nothing is pending after exit()."""
    r = _run(_system(True, None, deterministic=False), scene)
    s = r["sys"]
    assert r["poses"].shape == (N_FRAMES, 4, 4) and np.isfinite(r["poses"]).all()
    assert ttraj.ate_rmse(r["poses"], scene.poses_c2w[:N_FRAMES], align=False) < 0.03
    assert s._pending_ba is None and s.mapper.ba_count >= 2
    assert s.mapper._pool is None  # exit() stopped the worker


def test_worker_path_matches_sync_mapper(scene):
    """With a zero consume latency the async facade writes each BA back
    and re-anchors before the next tracked frame, as the sync mapper does:
    the worker thread's solve gives the sync keyframe poses bit for bit,
    and the frames too, except the two still in the tracker's pipeline
    when the last BA fires on the last frame: exit() flushes them before
    it drains that BA, so they are re-anchored through their keyframe
    instead of their own pose (1 ulp)."""
    sync = _run(_system(True, None, async_ba=False), scene)
    zero = _run(_system(True, None, latency=0), scene)
    assert zero["sys"].mapper.ba_count == sync["sys"].mapper.ba_count >= 2
    assert zero["sys"].tracker.new_kf_slots == sync["sys"].tracker.new_kf_slots
    assert zero["consumes"][-1] == (N_FRAMES, True)  # the last BA, drained by exit()
    depth = zero["sys"].tracker.params.pipeline_depth
    np.testing.assert_array_equal(zero["sys"].world.kf_poses_host, sync["sys"].world.kf_poses_host)
    np.testing.assert_array_equal(zero["poses"][:-depth], sync["poses"][:-depth])
    np.testing.assert_allclose(zero["poses"], sync["poses"], atol=1e-6, rtol=0)


def test_worker_error_is_raised_at_the_join(scene, monkeypatch):
    """An exception in the worker's solve is raised again where the caller
    joins it (no fallback to the sync path); pending_ready reports the
    finished worker so a polling consume reaches the join."""
    s = _system(True, None, async_ba=False)
    for left, right in scene.frames[:7]:
        s.track_stereo(left, right)
    s.exit()
    m = s.mapper

    def broken(*args, **kwargs):
        raise RuntimeError("solver failed on the worker")

    monkeypatch.setattr(tlm.schur, "local_ba_two_rounds", broken)
    pending = m.run_async_staged(s.tracker.new_kf_slots[-1])
    pending["solve"].exception()  # wait for the worker to finish
    assert tlm.pending_ready(pending)
    pending = m.advance(pending)  # round 1: nothing to join yet
    with pytest.raises(RuntimeError, match="on the worker"):
        m.advance(pending)
    m.close()


def test_deterministic_scope_is_thread_safe():
    """The BA's deterministic-algorithms scope, entered and left by many
    threads at once with a short switch interval: the flag is on inside
    every scope and restored once the last thread has left."""
    import sys
    import threading

    from vslam_torch.ops import schur

    was = torch.are_deterministic_algorithms_enabled()
    bad = []

    def work():
        for _ in range(300):
            with schur._deterministic():
                if not torch.are_deterministic_algorithms_enabled():
                    bad.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad and schur._det_users == 0
    assert torch.are_deterministic_algorithms_enabled() == was
