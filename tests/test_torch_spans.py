"""The span log and the stage counters of vslam_torch (utils/metrics): the
spans of a short CPU run of the facade nest, serve their frames and name
every stage the run reaches; the log changes nothing the run computes and,
off, adds no op; the stage names reach a profiler's Chrome export; the LM
loops count the iterations they dispatch and the host reads they make.

The scene is tests/test_torch_mapper.py's (320x240, 512 features, 4 levels,
12 frames, seed 7), from the port's own generator: a local BA runs on it."""

import json
import threading

import numpy as np
import pytest
import torch

from vslam_torch.geometry import se3
from vslam_torch.models import system, tracker
from vslam_torch.ops import lm
from vslam_torch.utils import metrics, synthetic
from vslam_torch.utils.config import ConfigFile

torch.set_num_threads(2)  # xdist runs several workers on one box

W, H = 320, 240
FX, BL = 460.0, 0.12
N_FRAMES = 12
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
CAPS = dict(lm_capacity=8192, kf_capacity=64)

# every span name a synchronous stereo run reaches
STEREO_SPANS = {
    "build", "frame", "frame.upload", "track", "track.extract", "track.stereo",
    "track.pose_solve", "track.match", "track.lm", "track.process", "kf_commit",
    "ba", "run", "ba.triangulate", "ba.assemble", "ba.solve", "ba.writeback", "ba.host_update",
}


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
def frames():
    s = synthetic.make_scene(n_frames=N_FRAMES, n_points=400, width=W, height=H, fps=10.0, seed=7)
    return [(s.render(f), s.render(f, right=True)) for f in range(N_FRAMES)]


def _system():
    return system.VSlamSystem(ConfigFile.from_dict(_config()), **CAPS,
                              tracker_params=tracker.TrackerParams(**PARAMS), device="cpu")


def _drive(frames, log: bool) -> dict:
    """Build a facade and track every frame, the span log on or off; the
    spans, the trajectory and the map (host copies)."""
    metrics.span_log(log)
    try:
        sys_ = _system()
        for left, right in frames:
            sys_.track_stereo(left, right)
        spans = metrics.take_spans()
    finally:
        metrics.span_log(False)
    counts = {name: st["count"] for timer in (sys_.metrics, sys_.tracker.metrics, sys_.mapper.metrics)
              for name, st in timer.summary().items()}
    sys_.exit()
    a = sys_.world.arrays
    return {"sys": sys_, "spans": spans, "counts": counts, "traj": sys_.trajectory(),
            "map": {k: getattr(a, k).numpy().copy() for k in ("kf_pose", "lm_pos", "lm_valid", "obs_lm")}}


@pytest.fixture(scope="module")
def runs(frames):
    return {"on": _drive(frames, True), "off": _drive(frames, False)}


def test_spans_nest_and_are_complete(runs):
    r = runs["on"]
    spans, sys_ = r["spans"], r["sys"]
    by_id = {s.id: s for s in spans}
    assert sorted(by_id) == list(range(len(spans)))  # every opened span closed
    assert sys_.mapper.ba_count >= 1
    names = {s.name for s in spans}
    assert STEREO_SPANS <= names, STEREO_SPANS - names
    # one frame span per call, serving frames 0 .. N-1 in order
    assert [s.frame for s in spans if s.name == "frame"] == list(range(N_FRAMES))
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent < 0:
            assert s.name in ("build", "frame"), s
            continue
        up = by_id[s.parent]
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, (s, up)
        # a span serves its parent's frame, but a processing step serves
        # the (older) frame it completes
        if s.name == "track.process":
            assert s.frame < up.frame
        else:
            assert s.frame == up.frame, (s, up)
    tracked = N_FRAMES - 1  # every frame after frame 0 runs the frame step
    assert sum(s.name == "track.pose_solve" for s in spans) == tracked
    assert sum(s.name == "ba" for s in spans) == sys_.mapper.ba_count
    c = sys_.tracker.counters
    assert c.get("lm_iters") >= 2 * c.get("radius_attempts") > 0
    assert c.get("radius_attempts") >= 2 * tracked  # a radius, then the refine pass
    assert c.get("host_reads") > 0 and sys_.mapper.counters.get("host_reads") > 0
    # the stage timers saw the same spans
    assert r["counts"] == {n: sum(s.name == n for s in spans) for n in names}


def test_the_async_solve_is_a_worker_span_timed_on_the_callers_thread(frames, monkeypatch):
    """With the async local BA the rounds are a span of the worker's
    thread (no parent, no frame), and every stage timer is written on the
    caller's thread alone: the solve's seconds are kept at the join."""
    writers = set()
    record = metrics.StageTimer.record

    def spy(self, name, dt):
        writers.add(threading.current_thread().name)
        record(self, name, dt)

    monkeypatch.setattr(metrics.StageTimer, "record", spy)
    metrics.span_log(True)
    try:
        sys_ = system.VSlamSystem(ConfigFile.from_dict(_config()), **CAPS, async_ba=True,
                                  tracker_params=tracker.TrackerParams(**PARAMS), device="cpu")
        for left, right in frames:
            sys_.track_stereo(left, right)
        sys_.exit()
        spans = metrics.take_spans()
    finally:
        metrics.span_log(False)
    assert writers == {threading.current_thread().name}
    solves = [s for s in spans if s.name == "ba.solve"]
    s = sys_.mapper.metrics.summary()
    assert len(solves) == s["ba.solve"]["count"] == s["ba_worker"]["count"] == s["ba_join"]["count"] >= 1
    assert all(x.parent == -1 and x.frame == -1 for x in solves)
    # the seconds kept at the join are the worker's span's
    kept = sorted(sys_.mapper.metrics.samples("ba.solve"))
    assert kept == pytest.approx(sorted((x.end_ns - x.start_ns) / 1e9 for x in solves), rel=0.05, abs=1e-3)


def test_the_log_changes_nothing_computed(runs):
    on, off = runs["on"], runs["off"]
    assert off["spans"] == []
    np.testing.assert_array_equal(on["traj"], off["traj"])
    for k in on["map"]:
        np.testing.assert_array_equal(on["map"][k], off["map"][k])
    assert on["sys"].tracker.new_kf_slots == off["sys"].tracker.new_kf_slots
    for a, b in ((on["sys"].tracker.counters, off["sys"].tracker.counters),
                 (on["sys"].mapper.counters, off["sys"].mapper.counters)):
        assert {k: v for k, v in a.summary().items() if not k.endswith("_per_s")} == \
            {k: v for k, v in b.summary().items() if not k.endswith("_per_s")}


def _aten_ops_of_one_frame(frames, log: bool) -> tuple[dict, list]:
    """The aten ops (name: count) a CPU profiler records over frame 3 of a
    fresh facade (the frame that also processes frame 1), the log on or
    off; and the spans the log holds after it."""
    metrics.span_log(log)
    try:
        sys_ = _system()
        for left, right in frames[:3]:
            sys_.track_stereo(left, right)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            sys_.track_stereo(*frames[3])
        spans = metrics.take_spans()
    finally:
        metrics.span_log(False)
    ops = {e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::")}
    return ops, spans


def test_the_log_adds_no_op(frames):
    on, spans_on = _aten_ops_of_one_frame(frames, True)
    off, spans_off = _aten_ops_of_one_frame(frames, False)
    assert spans_on and spans_off == []
    assert sum(on.values()) > 1000
    assert on == off


def test_stage_names_reach_the_chrome_export(frames, tmp_path):
    sys_ = _system()
    sys_.track_stereo(*frames[0])
    with metrics.trace(str(tmp_path)) as path:
        sys_.track_stereo(*frames[1])
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    want = {"frame", "frame.upload", "track", "track.extract", "track.stereo", "track.pose_solve",
            "track.match", "track.lm"}
    assert want <= names, want - names
    assert metrics.take_spans() == []  # the profiler alone keeps no span


def test_the_log_keeps_nesting_frames_and_threads_apart():
    timer = metrics.StageTimer()
    metrics.span_log(True)
    try:
        with timer.stage("outer", frame=5):
            with timer.stage("inner"):
                pass
            with timer.stage("older", frame=3):
                with timer.stage("leaf"):
                    pass
            worker = threading.Thread(target=_in_stage, args=(timer, "side"))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
        with metrics.span("bare"):
            pass
        spans = metrics.take_spans()
        assert metrics.take_spans() == []  # taken, the log is empty and still on
        with timer.stage("again"):
            pass
        assert [s.name for s in metrics.take_spans()] == ["again"]
    finally:
        metrics.span_log(False)
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["outer", "inner", "older", "leaf", "side", "bare"]
    assert [s.id for s in spans] == list(range(6))
    assert by["outer"].parent == -1 and by["outer"].frame == 5
    assert by["inner"].parent == by["outer"].id and by["inner"].frame == 5
    assert by["older"].parent == by["outer"].id and by["older"].frame == 3
    assert by["leaf"].parent == by["older"].id and by["leaf"].frame == 3
    # another thread's span has no parent here and serves no frame
    assert by["side"].parent == -1 and by["side"].frame == -1
    assert by["bare"].parent == -1
    s = timer.summary()
    assert {k: v["count"] for k, v in s.items()} == {"outer": 1, "inner": 1, "older": 1, "leaf": 1,
                                                     "side": 1, "again": 1}
    # the timer's seconds are the span's own
    assert timer.samples("outer")[0] == pytest.approx((by["outer"].end_ns - by["outer"].start_ns) / 1e9)


def _in_stage(timer, name):
    with timer.stage(name):
        pass


def test_threads_lose_no_span():
    """Many threads open nested spans and count at once, with a short
    switch interval: every span reaches the log once, under its own
    thread's parent, while another thread takes the log; no count is
    lost."""
    import sys

    n_threads, n_each = 16, 200
    timer = metrics.StageTimer()
    counters = metrics.Counters()
    taken: list = []
    stop = threading.Event()

    def work(k):
        for _ in range(n_each):
            with timer.stage(f"outer{k}", frame=k):
                with timer.stage(f"inner{k}"):
                    counters.inc("shared")

    def take():
        while not stop.is_set():
            taken.extend(metrics.take_spans())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    metrics.span_log(True)
    try:
        taker = threading.Thread(target=take)
        taker.start()
        workers = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        stop.set()
        taker.join(timeout=60)
        assert not taker.is_alive() and not any(w.is_alive() for w in workers)
        taken.extend(metrics.take_spans())
    finally:
        metrics.span_log(False)
        sys.setswitchinterval(old)
    assert len(taken) == 2 * n_threads * n_each
    assert sorted(s.id for s in taken) == list(range(len(taken)))
    by_id = {s.id: s for s in taken}
    for s in taken:
        k = int(s.name[5:])
        assert s.frame == k
        if s.name.startswith("inner"):
            assert by_id[s.parent].name == f"outer{k}"
        else:
            assert s.parent == -1
    assert timer.summary()["outer3"]["count"] == n_each
    assert counters.get("shared") == n_threads * n_each


def test_a_span_left_by_an_exception_closes():
    timer = metrics.StageTimer()
    metrics.span_log(True)
    try:
        with pytest.raises(ValueError):
            with timer.stage("raises"):
                raise ValueError("x")
        with timer.stage("after"):
            pass
        spans = metrics.take_spans()
    finally:
        metrics.span_log(False)
    assert [(s.name, s.parent) for s in spans] == [("raises", -1), ("after", -1)]
    assert timer.summary()["raises"]["count"] == 1


@pytest.mark.parametrize("max_iters", [3, 100])
def test_lm_solve_counts_its_iterations_and_reads(max_iters):
    """A pose from 40 noisy points: the host loop's iterations, at least
    the device's largest count, and one read of the done flags every 4."""
    g = torch.Generator().manual_seed(4)
    pts = torch.randn(40, 3, generator=g) + torch.tensor([0.0, 0.0, 6.0])
    T_true = se3.se3_expmap(torch.tensor([[0.02, -0.01, 0.03, 0.1, -0.05, 0.2]]))
    K = torch.tensor([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    pc = se3.transform_points(se3.inverse(T_true), pts[None])[0]
    uv = (pc[:, :2] / pc[:, 2:]) * 400.0 + torch.tensor([160.0, 120.0])
    obs = torch.cat([uv, torch.zeros(40, 1)], dim=-1)
    f = torch.zeros(40, dtype=torch.bool)
    its, reads = [], []
    _, _, _, _, res = lm.motion_only_ba(
        torch.eye(4)[None], pts, obs, torch.ones(40), f, f, ~f, K, 0.1,
        max_iters=max_iters, stats=its, reads=reads,
    )
    assert len(its) == len(reads) == 2  # the two passes
    for n, r in zip(its, reads):
        assert 1 <= n <= max_iters
        assert r == (n - 1) // 4 + (n < max_iters)
    assert int(res.iterations.max()) <= its[1]
