"""CPU tests of the benchmark harness: its files, the frozen generator, the
metric arithmetic and readers, the trace reduction, the JAX guard, and a
short rehearsal of each cell's control flow on the CPU.

    python -m pytest -q perfbench/tests

The test that needs a card is marked ``cuda`` and skips without one.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from scipy.optimize import least_squares

from perfbench import frozen_counts, judge, run, scene, sequence, tracing

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def small_overrides(config_name: str, frames: int, landmarks: int | None = None) -> dict:
    """A cell's rig at half its size (intrinsics halved with it), 512
    features on 4 levels, and a few frames of its traffic."""
    c = sequence.load_json("configs", config_name)["system"]
    system = {"Camera": {"width": c["Camera"]["width"] // 2, "height": c["Camera"]["height"] // 2},
              "FE": {"nFeatures": 512, "nLevels": 4}}
    for cam in ("Camera_l", "Camera_r"):
        d = {k: c[cam][k] / 2 for k in ("fx", "fy", "cx", "cy")}
        if "P" in c[cam]:
            P = np.asarray(c[cam]["P"]["data"], float).reshape(3, 4)
            P[:2] /= 2
            d["P"] = {**c[cam]["P"], "data": P.reshape(-1).tolist()}
        system[cam] = d
    traffic = {"frames": frames}
    if landmarks is not None:
        traffic["landmarks"] = {**sequence.load_json("traffic", _traffic_of(config_name))["landmarks"],
                                "count": landmarks}
    return {"system": system, "traffic": traffic}


def _traffic_of(config_name: str) -> str:
    return next(w["traffic"] for w in BENCH["workloads"] if w["config"] == config_name)


# ---------------------------------------------------------------------------
# files


def test_every_named_file_loads():
    assert BENCH["paths"] == ["perfbench"]
    for c in BENCH["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert sorted(doc["reduced"]) == sorted(c["reduced"])
        assert scene.Rig.from_system(doc["system"]).width > 0
    names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        t = sequence.load_json("traffic", w["traffic"])
        assert t["frames"] > 0 and set(t["motion"]) >= {"velocity", "sway_amp", "rot_amp"}
        lim = sequence.load_json("limits", w["name"])
        assert lim["numbers"], w["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert run.read_metric.__name__  # the reader is loaded by name below
    assert {m["name"] for m in BENCH["end_to_end"]} == {"fps", "frame_p90_ms", "setup_s"}


def test_contract_shapes():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


# ---------------------------------------------------------------------------
# the frozen generator


def _tiny(seed: int):
    rig = scene.Rig(160, 120, (100.0, 100.0, 80.0, 60.0), 0.11, 20.0, 200.0)
    traffic = sequence.load_json("traffic", "drive")
    traffic = {**traffic, "frames": 3, "landmarks": {**traffic["landmarks"], "count": 120}}
    return rig, traffic, scene.make_sequence(rig, traffic, seed)


def test_scene_repeats_for_a_seed_and_differs_between_seeds():
    rig, traffic, a = _tiny(2**31 + 12345)
    _, _, b = _tiny(2**31 + 12345)
    _, _, c = _tiny(7)
    la, ra = sequence.render_frames(a, rig, traffic, 2**31 + 12345, processes=1)
    lb, rb = sequence.render_frames(b, rig, traffic, 2**31 + 12345, processes=1)
    lc, _ = sequence.render_frames(c, rig, traffic, 7, processes=1)
    assert la.dtype == np.uint8 and la.shape == (3, 120, 160)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(a.imu, b.imu)
    assert not np.array_equal(la, lc)
    # the trajectory is the traffic's alone: the same for every seed
    np.testing.assert_array_equal(a.poses_c2w, c.poses_c2w)
    np.testing.assert_array_equal(a.poses_c2w[0], np.eye(4))


def test_imu_rows_cover_each_interval_once():
    rig, traffic, sc = _tiny(5)
    seq = sequence.Sequence(config={"system": {"IMU": {}}}, traffic=traffic, seed=5, scene=sc,
                            left=np.zeros((3, 1, 1), np.uint8), right=np.zeros((3, 1, 1), np.uint8))
    rows = [seq.imu_rows(i) for i in range(3)]
    assert rows[0] is None
    assert [len(r) for r in rows[1:]] == [10, 10]
    assert rows[2][0, 0] > rows[1][-1, 0]


# ---------------------------------------------------------------------------
# metric arithmetic and readers


def test_fps_and_p90_over_a_stall():
    walls = [0.5] * 18 + [0.5, 3.0]  # one frame stalls for 3 s
    rec = {"frames": 20, "window_s": 12.5, "frame_walls_s": walls}
    assert run.read_metric("fps", rec) == pytest.approx(1.6)
    # numpy's linear 90th percentile of 20 samples lies 0.1 of the way
    # from the 18th order statistic (0.5 s) to the 19th (0.5 s): the stall
    # is beyond p90 and does not move it
    assert run.read_metric("frame_p90_ms", rec) == pytest.approx(500.0)
    walls2 = [0.5] * 17 + [3.0, 3.0, 3.0]
    assert run.read_metric("frame_p90_ms", {**rec, "frame_walls_s": walls2}) == pytest.approx(3000.0)


def _events(spec):
    """Fake raw profiler events: (name, device, start_ns, duration_ns)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class E:
        def __init__(self, n, d, s, dur):
            self._v = (n, cuda if d == "cuda" else cpu, s, dur)

        def name(self):
            return self._v[0]

        def device_type(self):
            return self._v[1]

        def start_ns(self):
            return self._v[2]

        def duration_ns(self):
            return self._v[3]

    return [E(*x) for x in spec]


RECORDED = [
    ("aten::add", "cpu", 0, 10_000),
    ("cudaLaunchKernel", "cpu", 1_000, 2_000),
    ("add_kernel", "cuda", 5_000, 100_000),
    ("cudaLaunchKernel", "cpu", 20_000, 2_000),
    ("extract_windows_kernel", "cuda", 50_000, 150_000),  # overlaps the first
    ("aten::item", "cpu", 210_000, 500_000),
    ("cudaStreamSynchronize", "cpu", 600_000, 100_000),
    ("cudaLaunchKernel", "cpu", 705_000, 1_000),
    ("mul_kernel", "cuda", 800_000, 200_000),
]


def test_trace_reduction():
    calls = [([(1, 40, 40)], [2], torch.tensor([[0, 5]], dtype=torch.int32),
              torch.tensor([[0, 0]], dtype=torch.int32), 31)]
    t = tracing.reduce_events(_events(RECORDED), window_s=1e-3, calls=calls)
    assert t["busy_s"] == pytest.approx((200_000 - 5_000 + 200_000) / 1e9)
    assert t["counts"]["kernel_launches"] == 3 and t["counts"]["stream_syncs"] == 1
    assert t["device_ops"][0][0] in ("mul_kernel", "extract_windows_kernel")
    # one gap, 200 us -> 800 us, spent mostly in aten::item's host wait
    assert t["idle_gaps"] == [["aten::item", 600_000 / 1e9]]
    k = t["extract_windows"]
    assert k["kernels"] == 1 and k["kernel_s"] == pytest.approx(150e-6)
    # two 31x31 windows at x 0 and 5 of a 40x40 level: 31 x 36 distinct pixels
    assert k["bytes"] == 4 * (2 * 31 * 31 + 31 * 36 + 2 * 2)


def test_frozen_window_bytes_matches_a_direct_count():
    img = torch.zeros(2, 50, 60)
    x0 = torch.tensor([[0, 40, 3], [10, 10, 55]], dtype=torch.int32)
    y0 = torch.tensor([[0, 0, 30], [5, 5, 40]], dtype=torch.int32)
    idx = frozen_counts.gather_index([img], [3], x0, y0, 11)
    nbytes, covered = frozen_counts.window_bytes(idx, x0, 11)
    mask = torch.zeros(2, 50, 60, dtype=torch.bool)
    for b in range(2):
        for x, y in zip(x0[b].tolist(), y0[b].tolist()):
            x, y = min(max(x, 0), 60 - 11), min(max(y, 0), 50 - 11)
            mask[b, y:y + 11, x:x + 11] = True
    assert covered == int(mask.sum())
    assert nbytes == 4 * (2 * 3 * 11 * 11 + covered + 2 * 2 * 3)


def _record(trace):
    return {"frames": 4, "window_s": 2.0, "frame_walls_s": [0.5] * 4, "setup_s": 30.0,
            "spans": {"track": {"count": 4, "total_s": 1.6}, "run": {"count": 2, "total_s": 1.2}},
            "trace": trace, "device": {"kind": "NVIDIA H100 80GB HBM3"},
            "peaks": json.loads((ROOT / "perfbench" / "peaks.json").read_text())}


def test_readers_on_a_recorded_trace():
    t = {"window_s": 2.0, "busy_s": 0.3, "counts": {"kernel_launches": 80_000},
         "extract_windows": {"kernel_s": 4e-5, "kernels": 4, "calls": 4, "bytes": 80_000_000}}
    rec = _record(t)
    assert run.read_metric("track_ms", rec) == pytest.approx(400.0)
    assert run.read_metric("local_ba_ms", rec) == pytest.approx(600.0)
    assert run.read_metric("launches_per_frame", rec) == pytest.approx(20_000.0)
    assert run.read_metric("device_idle_pct", rec) == pytest.approx(85.0)
    assert run.read_metric("extract_windows_roofline", rec) == pytest.approx(
        100 * 80e6 / 3.35e12 / 4e-5)
    assert run.read_metric("setup_s", rec) == 30.0


def test_readers_find_nothing_without_their_source():
    rec = _record(None)
    rec["spans"]["run"] = {"count": 0, "total_s": 0.0}
    for name in ("local_ba_ms", "launches_per_frame", "device_idle_pct", "extract_windows_roofline"):
        assert run.read_metric(name, rec) is None, name
    t = {"window_s": 2.0, "busy_s": 0.3, "counts": {"kernel_launches": 8},
         "extract_windows": {"kernel_s": 0.0, "kernels": 0, "calls": 0, "bytes": 0}}
    assert run.read_metric("extract_windows_roofline", _record(t)) is None
    unknown = {**_record(t), "device": {"kind": "some other card"}}
    unknown["trace"]["extract_windows"] = {"kernel_s": 1e-5, "kernels": 1, "calls": 1, "bytes": 10}
    assert run.read_metric("extract_windows_roofline", unknown) is None


# ---------------------------------------------------------------------------
# the reference


def _map(kf_pose, kf_frame, lm_pos, obs=None, handed=None, ba_kf=-1):
    """A drive's map as run.snapshot takes it: keyframes in slots 0.., the
    landmarks in slots 0.., stereo observations at octave 0 (obs: (n_kf,
    n_lm, 3) [u_l, v_l, u_r], every keyframe observing every landmark)
    and no right-only ones."""
    n, L = len(kf_pose), len(lm_pos)
    obs = np.zeros((n, 0, 3)) if obs is None else obs
    K = obs.shape[1]
    return {"kf_slot": np.arange(n), "kf_pose": kf_pose, "kf_frame": np.asarray(kf_frame),
            "lm_pos": lm_pos, "lm_slot": np.arange(L),
            "handed": np.arange(n) if handed is None else np.asarray(handed), "ba_kf": ba_kf,
            "obs_uv": obs, "obs_oct": np.zeros((n, K), np.int64), "obs_stereo": np.ones((n, K), bool),
            "obs_lm": np.tile(np.arange(K), (n, 1)), "obs_r_uv": np.zeros((n, 0, 2)),
            "obs_r_oct": np.zeros((n, 0), np.int64), "obs_r_lm": np.zeros((n, 0), np.int64)}


SYSTEM = {"Camera": {"width": 640, "height": 480, "bl": 0.5, "fps": 10.0},
          "Camera_l": {"fx": 500.0, "fy": 500.0, "cx": 320.0, "cy": 240.0}, "FE": {"imScale": 1.2}}


def test_judge_reads_an_exact_run_as_zero_and_a_shifted_one_as_its_shift():
    _, _, sc = _tiny(3)
    exact = np.linalg.inv(sc.poses_c2w[0]) @ sc.poses_c2w
    snap = _map(exact[[0, 2]], [0, 2], sc.points_w[:5] + np.array([0.1, -0.05, 0.0]))
    n = judge.numbers([{"traj": exact, "frames": 3, "map": snap}], sc, SYSTEM)
    assert n["traj_max_m"] < 1e-9 and n["rot_max_deg"] < 1e-6 and n["kf_max_m"] < 1e-9
    assert n["lm_med_m"] < 1e-9  # inside its patch, on its plane
    moved = exact.copy()
    moved[2, 2, 3] += 0.25
    snap["lm_pos"] = sc.points_w[:5] + np.array([0.0, 0.0, 0.3])
    n = judge.numbers([{"traj": moved, "frames": 3, "map": snap}], sc, SYSTEM)
    assert n["traj_max_m"] == pytest.approx(0.25) and n["step_max_m"] == pytest.approx(0.25)
    assert 0.0 < n["lm_med_m"] <= 0.3 + 1e-9
    ok, checks = judge.compare(n, {"numbers": {"traj_max_m": {"limit": 0.1}}})
    assert not ok and checks["traj_max_m"]["value"] == pytest.approx(0.25)


def test_a_missing_pose_is_a_failure():
    _, _, sc = _tiny(3)
    exact = np.linalg.inv(sc.poses_c2w[0]) @ sc.poses_c2w
    snap = _map(exact[:1], [0], sc.points_w[:3])
    n = judge.numbers([{"traj": exact[:2], "frames": 3, "map": snap}], sc, SYSTEM)
    assert n["frames_without_pose"] == 1
    assert not judge.compare(n, {"numbers": {}})[0]


def _stereo_views(poses_c2w, pts, noise_px, seed):
    rng = np.random.default_rng(seed)
    T = np.linalg.inv(poses_c2w)
    pc = np.einsum("kij,lj->kli", T[:, :3, :3], pts) + T[:, None, :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    uv = np.stack([500 * x / z + 320, 500 * y / z + 240, 500 * (x - 0.5) / z + 320], -1)
    return uv + rng.normal(0.0, noise_px, uv.shape)


def test_structure_gaps_read_what_a_resolve_of_each_landmark_removes():
    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(-3, 3, 40), rng.uniform(-2, 2, 40), rng.uniform(6, 15, 40)], -1)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, 0, 3] = [0.0, 0.6, 1.2]
    noisy = _stereo_views(poses, pts, 0.5, 1)
    # at each landmark's least-squares point (solved here independently):
    # nothing to remove
    best = np.array([least_squares(lambda X: (_stereo_views(poses, X[None], 0.0, 0)[:, 0] - noisy[:, i]).ravel(),
                                   pts[i], xtol=1e-14, ftol=1e-14).x for i in range(len(pts))])
    gaps = judge.structure_gaps(_map(poses, [0, 3, 6], best, noisy, ba_kf=2), SYSTEM)
    assert len(gaps) == 40 and np.max(gaps) < 1e-6
    # at the true points: a noise-sized share (3 of 9 rows on average)
    gaps = judge.structure_gaps(_map(poses, [0, 3, 6], pts, noisy, ba_kf=2), SYSTEM)
    assert 0.1 < np.median(gaps) < 0.6
    # moved off, as a triangulation in one view leaves them: most of it
    gaps = judge.structure_gaps(_map(poses, [0, 3, 6], pts + [0.0, 0.0, 0.4], noisy, ba_kf=2), SYSTEM)
    assert np.median(gaps) > 0.9
    exact = _stereo_views(poses, pts, 0.0, 0)
    # one keyframe handed to the mapper: no landmark that two keyframes
    # observe, nothing to judge; no local BA yet: the same
    assert len(judge.structure_gaps(_map(poses, [0, 3, 6], pts, exact, handed=[0], ba_kf=0), SYSTEM)) == 0
    assert len(judge.structure_gaps(_map(poses, [0, 3, 6], pts, exact), SYSTEM)) == 0


# ---------------------------------------------------------------------------
# the guards


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax_like_name", types.ModuleType("jax_like_name"))
    monkeypatch.setitem(sys.modules, "vslam_tpu_extra", types.ModuleType("vslam_tpu_extra"))
    assert run.forbidden_modules() == [] or set(run.forbidden_modules()) <= set(run.FORBIDDEN)
    assert "jax_like_name" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vslam_tpu.models", types.ModuleType("vslam_tpu.models"))
    assert "vslam_tpu" in run.forbidden_modules()


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.run, perfbench.tracing, perfbench.calibrate, perfbench.control\n"
            "from vslam_torch.models import system\n"
            "from vslam_torch.ops import patches\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'vslam_tpu'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_without_a_card_the_run_fails_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "kitti00.drive", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA device" in out.err


def test_a_folder_without_the_program_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "kitti00.drive", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and not out.stdout.strip()


# ---------------------------------------------------------------------------
# the CPU rehearsal of each cell


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cpu_rehearsal_of_the_window_and_the_comparison(workload):
    cell = run.cell_of(BENCH, workload)
    over = small_overrides(cell["config"], frames=5, landmarks=400 if "kitti" in cell["config"] else None)
    r = run.run_cell(workload, 2**31 + 99, 3.0, False, device="cpu", overrides=over, processes=1)
    info = r.pop("info")
    assert r["metrics"] == {} and r["device"]["platform"] == "cpu" and r["device"]["kind"] == "cpu"
    assert r["attempted"] == info["frames"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks" and "traj_max_m" in r["checks"]
    # a number with nothing to judge yet (no local BA in five frames) reads inf
    assert not any(math.isnan(c["value"]) for c in r["checks"].values())


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "kitti00.drive", "--seed",
                          "4000000003", "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"fps", "frame_p90_ms", "setup_s"}
