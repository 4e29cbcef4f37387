"""Device and host timing of the kernels on a CUDA card, and an A/B timing
of the window stage of one stereo frame.

``primed_device_ms`` times what the DEVICE spends on a call: a spin kernel
(``torch.cuda._sleep``) is queued before the start event and lasts longer
than the host takes to queue the timed calls, so the device reaches the
start event only once every call is queued, and the window between the
events holds device work alone, not host enqueue. ``host_ms_per_call`` is
the host's side: wall time per call, with no synchronisation in the loop.

Run as a script it times the window stage of one frame at the bench
configuration (752x480, 8 levels at scale 1.2, 1024 keys per view, L+R) in
the ``vslam_torch`` package found under ``--tree`` (default: this
checkout), so two versions of the package can be compared in one run on
one card:

    python3 vslam_torch/kernels/timing.py --tree DIR

It prints one JSON line. A tree whose ``ops/patches.py`` has
``extract_windows_levels`` cuts the frame in one launch; an older tree in
one ``extract_windows`` call per level. Inputs are made from a seed.
"""

from __future__ import annotations

import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
_CYCLES_PER_MS: float | None = None


def _cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        cycles = 10_000_000
        torch.cuda._sleep(cycles)  # warm-up
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS = cycles / a.elapsed_time(b)
    return _CYCLES_PER_MS


def host_ms_per_call(fn, reps: int = 200, warmup: int = 5) -> float:
    """Host wall time per call of fn(), no synchronisation in the loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def wall_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median wall time of fn() followed by a synchronisation."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def primed_device_ms(fn, reps: int = 20, rounds: int = 9, warmup: int = 3) -> float:
    """Median over `rounds` of the device time per call of fn(), `reps`
    calls back to back between two CUDA events on a primed stream.

    A round whose enqueue outlasted the spin (the device may then have
    waited on the host) is discarded; the spin is doubled, and after two
    misses `reps` is halved, since a full launch queue also stalls the
    host. It raises if even one call cannot be primed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sleep_ms = 3.0 * host_ms_per_call(fn, reps=reps, warmup=0) * reps + 1.0
    times, misses = [], 0
    while len(times) < rounds:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(sleep_ms * _cycles_per_ms()))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if host_ms < sleep_ms:
            times.append(a.elapsed_time(b) / reps)
            continue
        misses += 1
        if misses > 8:
            raise RuntimeError(f"primed timing: enqueue of {reps} calls took {host_ms} ms")
        sleep_ms *= 2.0
        if misses % 2 == 0 and reps > 1:
            reps //= 2
    return statistics.median(times)


def gather_index(levels, counts, x0, y0, P: int) -> list:
    """Per level with slots, the advanced index (b, ys, xs) of its PxP
    windows, corners clamped as the kernel clamps them: ``levels[l][ix]``
    is one PyTorch call that cuts the level's windows."""
    idx, first = [], 0
    ar = torch.arange(P, device=x0.device)
    for img, q in zip(levels, counts):
        if q:
            B, h, w = img.shape
            xs = x0[:, first:first + q].long().clamp(0, w - P)[..., None] + ar
            ys = y0[:, first:first + q].long().clamp(0, h - P)[..., None] + ar
            b = torch.arange(B, device=x0.device)[:, None, None, None]
            idx.append((img, (b, ys[..., :, None], xs[..., None, :])))
        first += q
    return idx


def window_bytes(idx, x0, P: int) -> tuple[int, int]:
    """(bytes, distinct pixels) the window stage must move for these
    inputs: the (B, N, P, P) f32 output written once, each distinct level
    pixel a window covers read once, the int32 corners read once."""
    covered = 0
    for img, ix in idx:
        mask = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        mask[ix] = True
        covered += int(mask.sum())
    B, N = x0.shape
    return 4 * (B * N * P * P + covered + 2 * B * N), covered


def window_table(levels, counts, x0, y0, P: int) -> dict:
    """One window table (as extract_batch calls the kernel: every level in
    one launch) timed on the card that holds it: the kernel's device ms on
    a primed stream and host ms per call, its plain version's device ms,
    one advanced-indexing call per level (the library yardstick), and the
    bound from the bytes the call must move (:func:`window_bytes`)."""
    from vslam_torch.ops import patches

    with torch.cuda.device(x0.device):
        idx = gather_index(levels, counts, x0, y0, P)
        nbytes, covered = window_bytes(idx, x0, P)
        return {
            "device_ms": primed_device_ms(lambda: patches.extract_windows_levels(levels, counts, x0, y0, P, P)),
            "host_ms_per_call": host_ms_per_call(
                lambda: patches.extract_windows_levels(levels, counts, x0, y0, P, P)),
            "plain_ms": primed_device_ms(
                lambda: patches.extract_windows_levels_ref(levels, counts, x0, y0, P, P), reps=4),
            "library_ms": primed_device_ms(lambda: [img[ix] for img, ix in idx], reps=8),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes, "covered_pixels": covered,
        }


# KITTI 00's left camera and baseline (configs/config_kitti_00.yaml)
KITTI00_CAM = (1241, 376, 718.856, 607.1928, 185.2157, 0.537)


def lm_problem(B: int = 2, M: int = 4096, *, per_problem: bool = False, seed: int = 0, device="cuda",
               invalid: float = 0.25, outliers: float = 0.1, behind: float = 0.0):
    """A motion-only LM batch shaped like the tracker's, on KITTI 00's
    camera, from a seed: M rows of points 4-40 m in front of a true pose
    (a share `behind` of them 1-10 m behind it), their [u_left, v,
    u_right] pixels with 0.5 px noise, half of the rows stereo, a tenth of
    the others seen in the right image only, a share `outliers` 15-40 px
    off in u and v, 3% of the other stereo rows 5-10 px off in u_right
    alone (the sweep demotes them), octaves 0-3, a share `invalid` not
    valid. The B problems share the rows, K and the baseline and start
    from B perturbations of one true pose (the tracker's two starts), or,
    `per_problem`, each has its own true pose, rows, K and baseline (a
    batch of sequences). Returns (the positional arguments of
    ``lm.motion_only_ba``, the (B, 4, 4) true poses)."""
    import numpy as np

    from vslam_torch.geometry import se3

    W, H, f, cx, cy, bl = KITTI00_CAM
    rng = np.random.default_rng(seed)
    n = B if per_problem else 1

    def expmap(xi):
        return se3.se3_expmap(torch.from_numpy(np.asarray(xi, np.float64))).numpy()

    cols = {k: [] for k in ("pts", "obs", "isig", "st", "rt", "valid", "K", "bl", "T")}
    for _ in range(n):
        fx = f * (1.0 + 0.01 * rng.standard_normal()) if per_problem else f
        b = bl * (1.0 + 0.05 * rng.standard_normal()) if per_problem else bl
        u, v = rng.uniform(0, W, M), rng.uniform(0, H, M)
        z = np.where(rng.random(M) < behind, -rng.uniform(1, 10, M), rng.uniform(4, 40, M))
        pc = np.stack([(u - cx) * z / fx, (v - cy) * z / fx, z], -1)
        T = expmap(np.concatenate([rng.normal(0, 0.1, 3), rng.normal(0, 2.0, 3)]))
        obs = np.stack([u, v, fx * (pc[:, 0] - b) / z + cx], -1) + rng.normal(0, 0.5, (M, 3))
        st = rng.random(M) < 0.5
        rt = ~st & (rng.random(M) < 0.1)
        obs[rt, 0], obs[rt, 2] = obs[rt, 2], -1.0
        out = rng.random(M) < outliers
        obs[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1.0, 1.0], (out.sum(), 2))
        bad_r = st & ~out & (rng.random(M) < 0.03)
        obs[bad_r, 2] += rng.uniform(5, 10, bad_r.sum())
        cols["pts"].append(pc @ T[:3, :3].T + T[:3, 3])
        cols["obs"].append(obs)
        cols["isig"].append(1.2 ** (-2.0 * rng.integers(0, 4, M)))
        cols["st"].append(st)
        cols["rt"].append(rt)
        cols["valid"].append(rng.random(M) >= invalid)
        cols["K"].append([[fx, 0.0, cx], [0.0, fx, cy], [0.0, 0.0, 1.0]])
        cols["bl"].append(b)
        cols["T"].append(T)
    T_true = np.stack(cols["T"] * (B // n))
    T_init = T_true @ np.stack([expmap(np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.15, 3)]))
                                for _ in range(B)])
    dev = torch.device(device)

    def put(k, dtype):
        x = np.stack(cols[k]) if per_problem else np.asarray(cols[k][0])
        return torch.from_numpy(x.astype(dtype)).to(dev)

    f32 = np.float32
    args = (torch.from_numpy(T_init.astype(f32)).to(dev), put("pts", f32), put("obs", f32), put("isig", f32),
            put("st", bool), put("rt", bool), put("valid", bool), put("K", f32), put("bl", f32))
    return args, torch.from_numpy(T_true.astype(f32)).to(dev)


def lm_near_gate(args, T, chi2, margin: float) -> torch.Tensor:
    """The (B, M) rows of a motion-only LM call (``args`` as
    :func:`lm_problem` makes them) whose chi^2 lies within `margin` of the
    7.815 gate: the 3- or the 2-dof chi^2 at the poses T, or the call's
    own `chi2`. Solves whose poses differ a little may classify such rows
    differently."""
    from vslam_torch.ops import lm

    pts, obs, isig, st, rt, valid, K, bl = args[1:]
    c3 = lm.reproj_chi2(T, pts, obs, isig, st, rt, valid, K, bl)
    c2 = lm.reproj_chi2(T, pts, obs, isig, torch.zeros_like(st), rt, valid, K, bl)
    return sum((x - lm.CHI2_3DOF).abs() < margin for x in (c3, c2, chi2)) > 0


# f32 operations a row costs the LM kernel (motion_only_lm.cu, FMA = 2): a
# row of an LM pass (accumulate_row: the transform 18, the residuals 14, the
# weights 4, the Jacobian 32, the cost 6, the scaling 18, J^T J 126, J^T r
# 36), the robust pass's Huber weight, and a row of a chi-squared sweep
# (chi2_row)
LM_ROW_FLOPS, LM_HUBER_FLOPS, LM_SWEEP_FLOPS = 254, 15, 45
SM_F32_FLOPS_PER_CYCLE = 256  # an H100 SM: 128 f32 lanes, an FMA each a cycle


def lm_flops(args, inliers, its) -> torch.Tensor:
    """Per problem, the f32 operations of one kernel call: pass 1 evaluates
    its valid rows (robust) at its start and at each trial, pass 2 its
    gated set (taken as the call's final `inliers`) likewise, and the two
    sweeps every row. `its`: the per-pass (B,) iterations the call put in
    its `stats`. Returns a (B,) float64 tensor."""
    valid = args[6].expand(inliers.shape)
    M = inliers.shape[-1]
    it1, it2 = (x.to(torch.float64) + 1 for x in its)
    return (it1 * valid.sum(-1) * (LM_ROW_FLOPS + LM_HUBER_FLOPS) + it2 * inliers.sum(-1) * LM_ROW_FLOPS
            + 2 * M * LM_SWEEP_FLOPS)


def lm_table(args, max_iters: int = 100) -> dict:
    """One ``lm.motion_only_ba`` call on the card (``args`` as
    :func:`lm_problem` makes them): the kernel's launches per call, device
    ms on a primed stream, host ms per call, the iterations of each pass
    (the batch's longest problem), device us per LM iteration, the plain
    version's wall ms per call (it reads its done flags on the host, so it
    cannot be primed), and ``bound_ms``: the longest problem's
    :func:`lm_flops` at one SM's f32 peak at the card's measured clock
    (the kernel gives each problem one block, and the problems run side
    by side). The time above the bound is the iterations' serial chain:
    the reductions, the barriers and thread 0's solve."""
    from vslam_torch.ops import lm

    def kernel():
        return lm.motion_only_ba(*args, max_iters=max_iters)

    with torch.cuda.device(args[0].device):
        its, n0 = [], lm.LAUNCHES
        out = lm.motion_only_ba(*args, max_iters=max_iters, stats=its)
        launches = lm.LAUNCHES - n0
        flops = lm_flops(args, out[2], its)
        bound_ms = float(flops.max()) / (SM_F32_FLOPS_PER_CYCLE * _cycles_per_ms())
        its = [int(x.max()) for x in its]
        device_ms = primed_device_ms(kernel)
        return {
            "launches_per_call": launches, "iterations": its, "device_ms": device_ms,
            "us_per_iteration": 1e3 * device_ms / max(sum(its), 1),
            "host_ms_per_call": host_ms_per_call(kernel),
            "plain_ms": wall_ms(lambda: lm.motion_only_ba_ref(*args, max_iters=max_iters), reps=5),
            "bound_ms": bound_ms, "flops": float(flops.max()), "cycles_per_ms": _cycles_per_ms(),
        }


def _bench_frame_inputs(pyramid, seed: int = 3):
    """The window stage's inputs for one stereo frame at the bench
    configuration: the 8 blurred levels of a seeded image pair, the level
    quotas, and seeded corners including the extreme ones."""
    import numpy as np

    H, W, n_levels, scale, total, P = 480, 752, 8, 1.2, 1024, 31
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0.0, 255.0, size=(2, H, W)).astype(np.float32)).to(dev)
    inv = 1.0 / scale
    first = total * (1.0 - inv) / (1.0 - inv**n_levels)
    quotas = [int(round(first * inv**l)) for l in range(n_levels - 1)]
    quotas.append(max(total - sum(quotas), 0))
    levels, x0s, y0s, cur = [], [], [], img
    for l, q in enumerate(quotas):
        h, w = int(round(H * inv**l)), int(round(W * inv**l))
        if l:
            cur = pyramid.resize_bilinear_batch(cur, h, w)
        levels.append(pyramid.gaussian_blur_batch(cur).contiguous())
        x0 = rng.integers(0, w - P + 1, size=(2, q)).astype(np.int32)
        y0 = rng.integers(0, h - P + 1, size=(2, q)).astype(np.int32)
        x0[:, :2], y0[:, :2] = [0, w - P], [0, h - P]
        x0s.append(x0)
        y0s.append(y0)
    x0 = torch.from_numpy(np.concatenate(x0s, 1)).to(dev)
    y0 = torch.from_numpy(np.concatenate(y0s, 1)).to(dev)
    torch.cuda.synchronize()
    return img, levels, quotas, x0, y0, P


def main(argv=None) -> int:
    import argparse
    import json
    import pathlib
    import subprocess
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="directory that holds the vslam_torch package to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("timing.py needs a CUDA device")
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from vslam_torch.ops import extract, patches, pyramid

    if not pathlib.Path(patches.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {patches.__file__}, not the package under {tree}")
    img, levels, quotas, x0, y0, P = _bench_frame_inputs(pyramid)
    starts = [sum(quotas[:l]) for l in range(len(quotas))]
    per_level = [
        (lv, x0[:, s:s + q].contiguous(), y0[:, s:s + q].contiguous())
        for lv, s, q in zip(levels, starts, quotas)
    ]

    def per_level_calls():
        for lv, xl, yl in per_level:
            patches.extract_windows(lv, xl, yl, P, P)

    def plain():
        for lv, xl, yl in per_level:
            patches.extract_windows_ref(lv, xl, yl, P, P)

    idx = gather_index(levels, quotas, x0, y0, P)

    def library():
        for img, ix in idx:
            img[ix]

    fused = getattr(patches, "extract_windows_levels", None)
    stage = (lambda: fused(levels, quotas, x0, y0, P, P)) if fused else per_level_calls
    # the single-level entry, one call per level: the parent's stage itself
    single = {
        "per_level_calls_device_ms": primed_device_ms(per_level_calls),
        "per_level_calls_host_ms": host_ms_per_call(per_level_calls),
    } if fused else {}
    n0 = patches.LAUNCHES
    stage()
    launches = patches.LAUNCHES - n0
    batch = lambda: extract.extract_batch(img, n_levels=8, scale=1.2, total=1024)  # noqa: E731
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    frame_bytes, covered = window_bytes(idx, x0, P)
    print(json.dumps({
        "tree": str(tree),
        "card": smi,
        "launches_per_frame": launches,
        "frame_bytes": frame_bytes,
        "covered_pixels": covered,
        "bound_ms": frame_bytes / HBM_BYTES_PER_S * 1e3,
        "stage_device_ms": primed_device_ms(stage),
        "stage_host_ms": host_ms_per_call(stage),
        **single,
        "plain_device_ms": primed_device_ms(plain, reps=4),
        "library_device_ms": primed_device_ms(library, reps=8),
        "extract_batch_host_ms": host_ms_per_call(batch, reps=20, warmup=3),
        "extract_batch_wall_ms": wall_ms(batch),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
