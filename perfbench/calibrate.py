"""Readings for the limits of ``correct``: sound runs of the program, and
the control or a planted fault, at a cell's own size and load, on the
card.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 3 \
        --variants sound pose_solve_skipped --seconds 50 [--out FILE]

In one process (set-up is paid once per seed): per seed the sequence is
made and warmed up on, then each variant drives one window of `--seconds`
exactly as a run does, and one JSON line per (seed, variant) gives every
number judge.py computes, with fps, frame p90 and the counts. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from perfbench import control, judge, run, sequence


def reading(workload: str, seed: int, variant: str, seconds: float, seq, imu, device: str) -> dict:
    ctx = control.VARIANTS[variant](seq.config) if variant != "sound" else contextlib.nullcontext()
    with ctx:
        win = run.window(seq, imu, seconds, device)
        drives = run.close_window(win)
    nums = judge.numbers(drives, seq.scene, seq.config["system"])
    walls = np.asarray(win["walls"])
    return {"workload": workload, "seed": seed, "variant": variant, "frames": len(walls),
            "window_s": win["window_s"], "fps": len(walls) / win["window_s"],
            "frame_p90_ms": float(np.percentile(walls, 90)) * 1e3, "drives": len(drives),
            "keyframes": sum(d["counts"]["keyframes"] for d in drives),
            "ba_solves": sum(d["counts"]["ba_solves"] for d in drives),
            "relocalizations": sum(d["counts"]["relocalizations"] for d in drives), **nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["sound"])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    from vslam_torch import kernels

    kernels.library()
    cell = run.cell_of(run.benchmark(), a.workload)
    out = open(a.out, "a") if a.out else None
    for seed in a.seeds:
        t0 = time.perf_counter()
        seq = sequence.load(cell["config"], cell["traffic"], seed)
        imu = [seq.imu_rows(i) for i in range(seq.n_frames)]
        run.warm_up(seq, imu, "cuda")
        print(f"calibrate: seed {seed} set-up {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        for v in a.variants:
            r = reading(a.workload, seed, v, a.seconds, seq, imu, "cuda")
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
