"""Motion-only LM and projection matching alone on the card: the port of
the JAX repo's tools/profile_solver.py.

    python -m vslam_torch.tools.profile_solver

Inputs from ``np.random.default_rng(0)`` in the JAX tool's draw order,
A=4096 landmarks and N=1024 keys: ``lm.motion_only_ba`` at max_iters 100,
30 and 10 (each row reports the iterations its two LM passes ran: a
problem that converges stops early), ``project_match.match_by_projection``
(4096x1024) and ``project_match.predict_and_cull``. Each row: device ms
(and how it was taken), dispatch ms, blocked ms, kernel launches, host
syncs and device busy (``tools/_common.measure``). Prints one line per row
and one JSON line.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.ops import lm, project_match
from vslam_torch.tools import _common

A, N = 4096, 1024
ITERS = (100, 30, 10)


def inputs(seed: int = 0) -> dict:
    """The tool's numpy inputs, drawn as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    x = {"K": np.array([[460.0, 0, 376.0], [0, 460.0, 240.0], [0, 0, 1.0]], np.float32)}
    x["pts"] = np.stack([rng.uniform(-5, 5, A), rng.uniform(-3, 3, A), rng.uniform(4, 40, A)], -1).astype(np.float32)
    x["obs"] = rng.uniform(0, 480, (A, 3)).astype(np.float32)
    x["stereo"] = rng.integers(0, 2, A).astype(bool)
    x["valid"] = rng.integers(0, 2, A).astype(bool)
    x["mp_pred"] = rng.uniform(0, 700, (A, 2)).astype(np.float32)
    x["mp_oct"] = rng.integers(0, 8, A).astype(np.int64)
    x["mp_desc"] = (rng.integers(0, 2, (A, 256)) * 2 - 1).astype(np.int8)
    x["k_xy"] = rng.uniform(0, 700, (N, 2)).astype(np.float32)
    x["k_oct"] = rng.integers(0, 8, N).astype(np.int64)
    x["k_desc"] = (rng.integers(0, 2, (N, 256)) * 2 - 1).astype(np.int8)
    return x


def stages(x: dict, device) -> dict:
    """The rows as closures on `device`, by name, each returning its
    output (motion_only_ba's full result tuple)."""
    dev = torch.device(device)
    t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    A_, N_ = t["pts"].shape[0], t["k_xy"].shape[0]
    w = torch.ones(A_, device=dev)
    T0 = torch.eye(4, device=dev)[None]
    bl = torch.tensor(0.12, device=dev)
    sf = torch.tensor([1.2**l for l in range(8)], dtype=torch.float32, device=dev)
    k_valid = torch.ones(N_, dtype=torch.bool, device=dev)
    out = {
        f"motion_ba it={it}": (lambda it=it: lm.motion_only_ba(
            T0, t["pts"], t["obs"], w, t["stereo"], torch.zeros_like(t["stereo"]), t["valid"], t["K"], bl,
            max_iters=it))
        for it in ITERS
    }
    out[f"proj match {A_}x{N_}"] = lambda: project_match.match_by_projection(
        t["mp_pred"], t["mp_oct"], t["mp_desc"], t["valid"], t["k_xy"], t["k_oct"], t["k_desc"], k_valid,
        40.0, sf, 100.0, 0.8)
    out["predict_cull"] = lambda: project_match.predict_and_cull(
        T0[0], t["pts"], t["valid"], t["K"], bl, 752, 480, torch.ones(A_, device=dev) * 30,
        torch.ones(A_, device=dev), n_levels=8)
    return out


def lm_iterations(fn) -> list:
    """The iterations each LM pass of one motion_only_ba call ran: its
    `stats`, the first problem's on the card (the kernel's count), the host
    loop's on the CPU."""
    real, got = lm.motion_only_ba, []
    lm.motion_only_ba = lambda *a, **kw: real(*a, **kw, stats=got)
    try:
        fn()
    finally:
        lm.motion_only_ba = real
    return [int(x[0]) if isinstance(x, torch.Tensor) else int(x) for x in got]


def run(reps: int = 20) -> list:
    _common.require_card("profile_solver")
    rows = []
    for name, fn in stages(inputs(), "cuda").items():
        row = {"stage": name, **_common.measure(fn, reps)}
        if name.startswith("motion_ba"):
            row["lm_pass_iterations"] = lm_iterations(fn)
        rows.append(row)
        print(f"{name:22s}: dev={row['device_ms']:8.4f} ms ({row['device_method']}) "
              f"disp={row['dispatch_ms']:7.3f} blk={row['blocked_ms']:8.3f} launches={row['launches']} "
              f"syncs={row['syncs']} busy={row['device_busy_ms']:.4f}"
              + (f" iterations={row['lm_pass_iterations']}" if "lm_pass_iterations" in row else ""),
              flush=True)
    return rows


def main(reps: int = 20) -> dict:
    return _common.emit("profile_solver", run(reps))


if __name__ == "__main__":
    main()
