"""The benchmark of vslam_torch, the PyTorch + CUDA port: one cell, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m perfbench.run ...``) from the root of a checkout on a
machine with the card(s) the cell asks for. Everything is found by name
from ``BENCHMARK.json``: the cell's configuration (``configs/<config>.json``),
its traffic (``traffic/<traffic>.json``), its limits
(``limits/<cell>.json``) and one reader per metric (``metrics/<name>.py``).

Set-up: the port's CUDA library is built or loaded, the cell's sequence is
rendered from the seed, and a throwaway ``VSlamSystem`` is driven over the
sequence's first frames up to and including the first keyframe's local BA.
The window: a fresh facade tracks the sequence from frame 0, closed loop,
one ``track_stereo`` call a frame, until ``--seconds`` have passed; when the
sequence ends first a new facade starts it again (a new drive, whose build
counts). Once the window has closed the outputs of every drive, its
trajectory and its map, are judged against the exact world (judge.py). The
last line on standard output is the result as one JSON object; the numbers
compared are the last lines on standard error.
"""

from __future__ import annotations

import os
import sys

for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
for _v, _d in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_v] = str(HERE / ".cache" / _d)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import judge, sequence  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vslam_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must never load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")


def metric_specs(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (trace 1)."""
    specs = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in specs if workload in m.get("workloads", [workload])]


def read_metric(name: str, rec: dict):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def make_system(seq: sequence.Sequence, device: str):
    """The facade as ``python -m vslam_torch.run_dataset`` builds it from a
    config: default capacities and the synchronous local BA; the frames
    arrive rectified."""
    from vslam_torch.models import system
    from vslam_torch.utils.config import ConfigFile

    return system.VSlamSystem(ConfigFile.from_dict(seq.config["system"]), io_rectified=True, device=device)


def _spans(sys_) -> dict:
    out = {}
    for timer, stage in ((sys_.tracker.metrics, "track"), (sys_.mapper.metrics, "run")):
        s = timer.summary().get(stage, {"count": 0, "total_s": 0.0})
        out[stage] = {"count": s["count"], "total_s": s["total_s"]}
    return out


def _counts(sys_) -> dict:
    return {"keyframes": sys_.tracker.counters.get("keyframes"),
            "ba_solves": sys_.mapper.counters.get("ba_solves"),
            "relocalizations": sys_.tracker.counters.get("relocalizations")}


def _sync(device: str):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def warm_up(seq: sequence.Sequence, imu: list, device: str) -> int:
    """Drive a throwaway facade from frame 0 up to and including the first
    keyframe's local BA (every shape the window uses). Returns the frames."""
    sys_ = make_system(seq, device)
    n = 0
    while n < seq.n_frames:
        sys_.track_stereo(seq.left[n], seq.right[n], imu[n])
        n += 1
        if sys_.mapper.ba_count >= 1:
            break
    sys_.exit()
    _sync(device)
    del sys_
    gc.collect()
    return n


def window(seq: sequence.Sequence, imu: list, seconds: float, device: str) -> dict:
    """The measured window: closed loop over the sequence, drive after
    drive, until `seconds` have passed; ends with a device sync. Returns
    the frame walls, the window's length, each finished drive's map,
    trajectory, frame count, spans and counts, and the live facade of the
    last drive."""
    walls, drives = [], []
    sys_, i = None, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if sys_ is None or i == seq.n_frames:
            if sys_ is not None:
                drives.append(finish_drive(sys_, i))
            sys_, i = None, 0
            sys_ = make_system(seq, device)
        ts = time.perf_counter()
        sys_.track_stereo(seq.left[i], seq.right[i], imu[i])
        walls.append(time.perf_counter() - ts)
        i += 1
    _sync(device)
    return {"walls": walls, "window_s": time.perf_counter() - t0, "drives": drives,
            "live": sys_, "live_frames": i}


def finish_drive(sys_, frames: int) -> dict:
    """A drive's outputs: its map as it stands, then, the facade drained,
    its trajectory, with its frame count, spans and counts."""
    snap = snapshot(sys_)
    sys_.exit()
    return {"map": snap, "traj": sys_.trajectory(), "frames": frames, "spans": _spans(sys_),
            "counts": _counts(sys_)}


def close_window(win: dict) -> list:
    """After the window: the last drive finished like the others; frees
    its facade. Returns every drive of the window."""
    live = win.pop("live")
    drives = win["drives"] + [finish_drive(live, win["live_frames"])]
    del live
    gc.collect()
    return drives


def snapshot(sys_) -> dict:
    """A drive's map as it stands (host copies): valid keyframes' slots,
    poses, frame indices and observation tables (left keys ``obs_*``:
    [u_l, v_l, u_r], octave, stereo flag, landmark slot or negative;
    right-only keys ``obs_r_*``), valid landmarks' positions and slots;
    the keyframes the tracker has handed to the mapper (``handed``) and
    the one of the mapper's last local BA (``ba_kf``, -1 before the
    first). The tracker writes a keyframe into the map a frame before it
    hands it over."""
    w = sys_.world
    a = w.arrays
    n_kf = w.n_keyframes
    slots = np.flatnonzero(a.kf_valid[:n_kf].cpu().numpy())
    kf = torch.as_tensor(slots, device=a.kf_pose.device)
    lm_valid = a.lm_valid.cpu().numpy()
    handed = np.asarray(sys_.tracker.new_kf_slots, np.int64)
    snap = {"kf_slot": slots, "kf_pose": a.kf_pose[kf].cpu().numpy(), "kf_frame": w.kf_frame_idx[slots].copy(),
            "lm_pos": a.lm_pos.cpu().numpy()[lm_valid], "lm_slot": np.flatnonzero(lm_valid),
            "handed": handed, "ba_kf": int(handed[-1]) if sys_.mapper.ba_count and len(handed) else -1}
    for name in ("obs_uv", "obs_oct", "obs_stereo", "obs_lm", "obs_r_uv", "obs_r_oct", "obs_r_lm"):
        snap[name] = getattr(a, name)[kf].cpu().numpy()
    return snap


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             overrides: dict | None = None, processes: int | None = None, bench: dict | None = None) -> dict:
    """One run of a cell: set-up, the window, the judgement. Returns the
    result object (the last stdout line's) and, under "info", what the
    run prints on standard error before it. With `device="cpu"` (the CPU
    rehearsal of the tests) no device metric is read and ``device`` says
    cpu."""
    bench = bench or benchmark()
    cell = cell_of(bench, workload)
    on_card = device.startswith("cuda")
    if on_card:
        from vslam_torch import kernels

        kernels.library()
    seq = sequence.load(cell["config"], cell["traffic"], seed, processes=processes, overrides=overrides)
    imu = [seq.imu_rows(i) for i in range(seq.n_frames)]
    warm_frames = warm_up(seq, imu, device)
    setup_s = process_age_s()

    tr = None
    if trace:
        from perfbench import tracing

        tr = tracing.WindowTrace() if on_card else None
    if tr is not None:
        with tr:
            win = window(seq, imu, seconds, device)
    else:
        win = window(seq, imu, seconds, device)

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    drives = close_window(win)

    spans = {k: {"count": sum(d["spans"][k]["count"] for d in drives),
                 "total_s": sum(d["spans"][k]["total_s"] for d in drives)} for k in ("track", "run")}
    counts = {k: sum(d["counts"][k] for d in drives) for k in drives[0]["counts"]}
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    rec = {"frames": len(win["walls"]), "window_s": win["window_s"], "frame_walls_s": win["walls"],
           "setup_s": setup_s, "spans": spans, "trace": tr.record() if tr is not None else None,
           "device": {"kind": kind}, "peaks": json.loads((HERE / "peaks.json").read_text())}

    metrics = {}
    if on_card:
        for m in metric_specs(bench, workload, trace):
            v = read_metric(m["name"], rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    nums = judge.numbers(drives, seq.scene, seq.config["system"])
    lim_path = HERE / "limits" / f"{workload}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {"numbers": {}}
    correct, checks = judge.compare(nums, limits)

    result = {
        "correct": correct,
        "attempted": rec["frames"],
        "failed": nums["frames_without_pose"],
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": int(cell["chips"]) if on_card else 0, "memory_peak_bytes": int(peak)},
    }
    if on_card:
        result["device"]["power_limit"] = power_limit()
    if rec["trace"] is not None:
        t = rec["trace"]
        result["device"]["busy_s"] = t["busy_s"]
        result["device"]["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    walls = np.asarray(win["walls"])
    result["info"] = {
        "seed": seed, "frames": rec["frames"], "window_s": rec["window_s"], "drives": len(drives),
        "warm_up_frames": warm_frames, "sequence_frames": seq.n_frames, **counts,
        "keyframe_share": counts["keyframes"] / max(rec["frames"], 1),
        "frame_p50_ms": float(np.percentile(walls, 50)) * 1e3 if len(walls) else None,
        "frame_max_ms": float(walls.max()) * 1e3 if len(walls) else None,
        "spans": spans, "numbers": nums,
        "trace_counts": rec["trace"]["counts"] if rec["trace"] else None,
        "extract_windows": rec["trace"]["extract_windows"] if rec["trace"] else None,
    }
    return result


def emit(result: dict, out=sys.stdout, err=sys.stderr):
    """Print a run: its information and then each number compared beside its
    limit on standard error, the result as the last stdout line."""
    info = result.pop("info", None)
    if info is not None:
        print("perfbench info " + json.dumps(info), file=err)
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = benchmark()
    chips = int(cell_of(bench, a.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 4
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
