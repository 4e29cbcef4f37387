"""The port's timing entry (``python -m vslam_torch.bench``) against the
JAX package's ``bench.py`` on the CPU: run_pipeline and measure_ba_solves
of both on one 320x240 scene (16 frames, 6 of warm-up, 512 features, 4
levels), with each package's pending_ready forced true so both consume
every BA at the fixed latency of 2 frames; main() with its sections
replaced by canned results (the JSON line's keys, the budget gates, a
failing section's exit code, no card); the render cache."""

import json
import types

import numpy as np
import pytest
import torch

import bench as jbench
from vslam_torch import bench as tbench
from vslam_torch.models import local_mapper as tlm, tracker as ttr
from vslam_torch.utils import synthetic as tsynthetic
from vslam_tpu.models import local_mapper as jlm, tracker as jtr
from vslam_tpu.utils import synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

N_FRAMES, WARMUP = 16, 6
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
POSE_TOL_M = 1e-3  # tests/test_torch_async.py's tolerance for the async schedule
SOLVES = 2


@pytest.fixture(scope="module")
def scene():
    s = synthetic.make_scene(n_frames=N_FRAMES, n_points=400, width=320, height=240, fps=10.0, seed=7)
    s.pairs = [np.stack([s.render(f), s.render(f, right=True)]).astype(np.uint8) for f in range(N_FRAMES)]
    return s


@pytest.fixture(scope="module")
def runs(scene):
    """Both benches' run_pipeline, then measure_ba_solves, on the same
    uint8 frames; nothing is rendered or written by the benches."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbench, tbench):
            mp.setattr(mod, "_render_frames", lambda sc, n, key: scene.pairs[:n])
        mp.setattr(jlm, "pending_ready", lambda pending: True)
        mp.setattr(tlm, "pending_ready", lambda pending: True)
        out = {}
        for name, mod, params in (("jax", jbench, jtr.TrackerParams(**PARAMS)),
                                  ("torch", tbench, ttr.TrackerParams(**PARAMS))):
            kw = {"device": "cpu"} if mod is tbench else {}
            fps, ate, trk, mapper = mod.run_pipeline(scene, params, N_FRAMES, WARMUP, "unused", **kw)
            r = {"fps": fps, "ate": ate, "trk": trk, "mapper": mapper, "poses": trk.trajectory(),
                 "ba_runs": mapper.ba_count}
            r["solves_per_s"] = mod.measure_ba_solves(trk, mapper, n=SOLVES)
            r["kf_poses"] = np.asarray(trk.world.kf_poses_host)[: trk.world.n_keyframes].copy()
            out[name] = r
    return out


def test_run_pipeline_matches_bench_py(scene, runs):
    """The same keyframes at the same frames, the same BA count, poses
    within 1e-3 m, both ATEs under bench.py's 0.05 m gate."""
    rt, rj = runs["torch"], runs["jax"]
    assert rt["trk"].new_kf_slots == rj["trk"].new_kf_slots
    assert rt["trk"].world.n_keyframes == rj["trk"].world.n_keyframes
    n = rj["trk"].world.n_keyframes
    np.testing.assert_array_equal(rt["trk"].world.kf_frame_idx[:n], rj["trk"].world.kf_frame_idx[:n])
    assert rt["ba_runs"] == rj["ba_runs"] >= 2
    assert rt["poses"].shape == rj["poses"].shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(rt["poses"], rj["poses"], atol=POSE_TOL_M, rtol=0)
    assert rt["ate"] < 0.05 and rj["ate"] < 0.05, (rt["ate"], rj["ate"])
    assert rt["fps"] > 0 and np.isfinite(rt["fps"])
    assert rt["mapper"]._pool is None  # the worker thread is stopped


def test_measure_ba_solves_matches_bench_py(runs):
    """One untimed and SOLVES timed solves on the newest keyframe in both:
    the same BA count after them and keyframe poses within 1e-3 m."""
    rt, rj = runs["torch"], runs["jax"]
    assert rt["mapper"].ba_count == rj["mapper"].ba_count == rj["ba_runs"] + 1 + SOLVES
    assert rt["solves_per_s"] > 0 and rj["solves_per_s"] > 0
    np.testing.assert_allclose(rt["kf_poses"], rj["kf_poses"], atol=POSE_TOL_M, rtol=0)


def _canned(monkeypatch, fail_in=None):
    """Replace main()'s sections and device queries by canned results;
    `fail_in` names a section that raises."""
    trk = types.SimpleNamespace(
        world=types.SimpleNamespace(n_keyframes=14, n_landmarks=1955),
        metrics=types.SimpleNamespace(summary=lambda: {"track": {"p50_ms": 300.0, "p90_ms": 900.0}}),
    )
    mapper = types.SimpleNamespace(ba_count=13)
    fps = iter([2.0, 3.0, 2.5, 1.5])

    def section(name, result):
        def run(*args, **kwargs):
            if name == fail_in:
                raise RuntimeError(f"{name} broke")
            return result() if callable(result) else result
        return run

    monkeypatch.setattr(tbench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbench, "card", lambda: {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"})
    monkeypatch.setattr(tbench, "run_pipeline", section("pipeline", lambda: (next(fps), 0.006, trk, mapper)))
    monkeypatch.setattr(tbench, "measure_ba_solves", section("ba_solves", 4.0))
    monkeypatch.setattr(tbench, "run_loop_circuit", section("loop", (3, 0.03, 0.031)))
    monkeypatch.setattr(tbench, "run_mono_pipeline", section("mono", (1.2, 0.004, trk)))


def _line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_line_has_bench_py_keys(monkeypatch, capsys):
    """A run with room for every section: exit code 0, bench.py's metric,
    and exactly BENCH_r05.json's extra keys plus the card."""
    _canned(monkeypatch)
    monkeypatch.delenv("BENCH_BUDGET_S", raising=False)
    assert tbench.main() == 0
    line = _line(capsys)
    with open("BENCH_r05.json") as f:
        ref = json.load(f)["parsed"]
    assert {k: line[k] for k in ("metric", "unit")} == {k: ref[k] for k in ("metric", "unit")}
    assert set(line) == set(ref)
    assert set(line["extra"]) == set(ref["extra"]) | {"device"}
    assert set(line["extra"]["section_wall_s"]) == set(ref["extra"]["section_wall_s"])
    e = line["extra"]
    assert e["fps_samples"] == [2.0, 2.5, 3.0] and line["value"] == 2.5  # the median of 3
    assert line["vs_baseline"] == 2.5 / 20.0
    assert e["kitti_2048feat_fps"] == 1.5 and e["mono_ate_gate_0p05"] is True
    assert e["device"] == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}


def test_main_over_budget_skips_later_sections(monkeypatch, capsys):
    """With no budget left, one euroc run and ba_solves, then each later
    section is skipped by name; still exit code 0."""
    _canned(monkeypatch)
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    assert tbench.main() == 0
    e = _line(capsys)["extra"]
    assert len(e["fps_samples"]) == 1
    assert {"loop_skipped", "kitti_skipped", "mono_skipped"} <= set(e)
    assert "local_ba_solves_per_s" in e and "loop_closures" not in e


@pytest.mark.parametrize("section", ["ba_solves", "loop", "mono"])
def test_main_failing_section_exits_nonzero(monkeypatch, capsys, section):
    """A section that raises: the line still prints, with the error in
    extra, and main() returns 1 (bench.py would exit 0)."""
    _canned(monkeypatch, fail_in=section)
    monkeypatch.delenv("BENCH_BUDGET_S", raising=False)
    assert tbench.main() == 1
    line = _line(capsys)
    assert line["metric"] == "tracked_frames_per_s_per_chip"
    assert f"{section} broke" in line["extra"]["optional_section_error"]


def test_main_raises_without_a_card(monkeypatch, capsys):
    """No CUDA card: main() raises before any section, and prints nothing."""
    _canned(monkeypatch)
    monkeypatch.setattr(tbench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tbench.main()
    assert capsys.readouterr().out == ""


def test_render_frames_caches_uint8_pairs(tmp_path, monkeypatch):
    """Rendered in worker processes into the cache directory as uint8 L+R
    pairs equal to the scene's own renders; a second call reads the cache
    without starting a worker."""
    s = tsynthetic.make_scene(n_frames=3, n_points=60, width=64, height=48, fps=10.0, seed=2)
    monkeypatch.setattr(tbench, "CACHE_DIR", str(tmp_path))
    frames = tbench._render_frames(s, 3, "tiny")
    assert (tmp_path / "tiny.npz").exists()
    want = [np.stack([s.render(f), s.render(f, right=True)]).astype(np.uint8) for f in range(3)]
    assert len(frames) == 3
    for a, b in zip(frames, want):
        assert a.dtype == np.uint8 and a.shape == (2, 48, 64)
        np.testing.assert_array_equal(a, b)

    def no_pool(*args, **kwargs):
        raise AssertionError("rendered again")

    monkeypatch.setattr(tbench.concurrent.futures, "ProcessPoolExecutor", no_pool)
    for a, b in zip(tbench._render_frames(s, 3, "tiny"), want):
        np.testing.assert_array_equal(a, b)
