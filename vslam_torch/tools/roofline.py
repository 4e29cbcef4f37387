"""Speed-of-light audit of one tracked frame on the card: the port of the
JAX repo's tools/roofline.py.

    python -m vslam_torch.tools.roofline

For each stage of ``tracker._track_step`` at the bench's shapes (752x480
stereo pair, 1024 features, 8 levels at scale 1.2, 4096 active landmarks,
``WorldMap(1 << 15, 128, 1024)``), on frame 9 of the bench scene after the
shared warm-up (8 frames tracked and mapped), it measures:

- device time: CUDA events on a primed stream for a stage with no host
  sync, the profiler's device busy for one that reads the host (each row
  names its method); dispatch ms (host time per call, no sync); blocked ms
  (a call that ends in a synchronize); kernel launches and host syncs;
- FLOPs and bytes from the hand model in ``tools/counts.py`` (each input
  byte read once, each output byte written once; the LM at the iterations
  this call ran), in place of XLA's ``cost_analysis()``;
- the bound, the larger of FLOPs over the f32 peak (TF32 is off) and bytes
  over the HBM rate, and the share of it the stage reaches;
- the ``extract_windows`` launches of one call (``patches.LAUNCHES``).

The patch stage has two rows: the JAX tool's call shape (the level-0 keys'
windows of the unblurred frame, one ``extract_windows`` call) and the
production frame (every level in one ``extract_windows_levels`` launch);
each also times, on a primed stream, the kernel's plain version
(``plain_ms``) and one advanced-indexing call per level (``library_ms``).
Prints a markdown table and one JSON line.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.kernels import timing
from vslam_torch.models import tracker
from vslam_torch.ops import extract, fast, lm, orb, patches, project_match, pyramid, stereo_match
from vslam_torch.tools import _common, counts

N_FRAMES = 12  # the JAX tool's scene (tools/roofline.py:109-111)
FRAME = 9  # the audited frame, after the warm-up


def pyramid_blur(imgs: torch.Tensor, n_levels: int, scale: float) -> list:
    """The pyramid as extract_batch builds it (each level resized from the
    previous one) and the blur of every level: (B, h_l, w_l) each."""
    B, H, W = imgs.shape
    out, cur = [], imgs
    for l, (h, w) in enumerate(pyramid.level_shapes(H, W, n_levels, scale)):
        if l:
            cur = pyramid.resize_bilinear_batch(cur, h, w)
        out.append(pyramid.gaussian_blur_batch(cur))
    return out


def frame_stages(LR: torch.Tensor, p: tracker.TrackerParams, fx, baseline) -> dict:
    """The extraction and stereo stages of one (2, H, W) float32 frame, by
    row name: (closure returning the stage's output, count) where
    count(output) is the hand model's {"flop", "bytes"} of the call."""
    B, H, W = LR.shape
    sf = torch.as_tensor(extract.scale_factors(p.n_levels, p.scale), device=LR.device)
    kw = dict(n_levels=p.n_levels, scale=p.scale, total=p.n_features, edge_margin=p.edge_margin,
              fast_hi=p.fast_hi, fast_lo=p.fast_lo)
    win = extract.window_inputs(LR, **kw)
    keys = extract.extract_batch(LR, **kw)
    kl, kr = keys.select(0), keys.select(1)
    P = orb.PATCH
    q0 = win.counts[0]
    cell0 = max(8, min(35, int((H * W / q0) ** 0.5)))  # extract_batch's level-0 call
    margin0 = min(p.edge_margin, min(H, W) // 4)
    # the JAX tool's patch call: the level-0 keys' windows of the frame
    x0 = (keys.xy[:, :q0, 0].to(torch.int32) - P // 2).clamp(0, W - P).contiguous()
    y0 = (keys.xy[:, :q0, 1].to(torch.int32) - P // 2).clamp(0, H - P).contiguous()
    patch_all = patches.extract_windows_levels(win.blurred, win.counts, win.x0, win.y0, P, P)

    def orient_brief():
        angle = orb.orientation_from_patches(patch_all)
        return (angle, *orb.brief_from_patches(patch_all, angle))

    def stereo():
        return stereo_match.match_stereo(
            LR[0], LR[1], kl.xy, kl.octave, kl.desc, kl.valid, kr.xy, kr.octave, kr.desc, kr.valid,
            fx, baseline, sf, close_factor=p.close_factor,
        )

    def windows(levels, q, xs, ys):
        idx = timing.gather_index(levels, q, xs, ys, P)
        return lambda out: {"flop": 0, "bytes": timing.window_bytes(idx, xs, P)[0]}

    def with_twins(fn, plain, levels, q, xs, ys):
        """The kernel call `fn`, carrying its plain version and the library
        yardstick (one advanced-indexing call per level) as ``fn.twins``."""
        idx = timing.gather_index(levels, q, xs, ys, P)
        fn.twins = {"plain": plain, "library": lambda: [img[ix] for img, ix in idx]}
        return fn

    N = p.n_features
    return {
        "extract_batch(x2)": (
            lambda: extract.extract_batch(LR, **kw),
            lambda out: {"flop": counts.extract_flops(B, H, W, p.n_levels, p.scale, N),
                         "bytes": counts.nbytes(LR, out)}),
        "pyramid+blur": (
            lambda: pyramid_blur(LR, p.n_levels, p.scale),
            lambda out: {"flop": counts.pyramid_flops(B, pyramid.level_shapes(H, W, p.n_levels, p.scale),
                                                      p.n_levels),
                         "bytes": counts.nbytes(LR, out)}),
        "fast.detect L0": (
            lambda: fast.detect(LR, p.fast_hi, p.fast_lo, cell=cell0, max_keypoints=q0, edge_margin=margin0),
            lambda out: {"flop": counts.detect_flops(B, H, W), "bytes": counts.nbytes(LR, out)}),
        f"patches L0 ({q0}x{P}x{P})": (
            with_twins(lambda: patches.extract_windows(LR, x0, y0, P, P),
                       lambda: patches.extract_windows_ref(LR, x0, y0, P, P), [LR], [q0], x0, y0),
            windows([LR], [q0], x0, y0)),
        "patches frame (1 launch)": (
            with_twins(lambda: patches.extract_windows_levels(win.blurred, win.counts, win.x0, win.y0, P, P),
                       lambda: patches.extract_windows_levels_ref(win.blurred, win.counts, win.x0, win.y0, P, P),
                       win.blurred, win.counts, win.x0, win.y0),
            windows(win.blurred, win.counts, win.x0, win.y0)),
        "orient+BRIEF": (
            orient_brief,
            lambda out: {"flop": counts.orient_brief_flops(B * N), "bytes": counts.nbytes(patch_all, out)}),
        "stereo_match": (
            stereo,
            lambda out: {"flop": counts.stereo_flops(1, N, N),
                         "bytes": counts.nbytes(LR, [(k.xy, k.octave, k.desc, k.valid) for k in (kl, kr)],
                                                out)}),
    }


def track_step_stage(trk: tracker.StereoTracker, LR: torch.Tensor):
    """``tracker._track_step`` on the warmed tracker's state and frame `LR`
    ((2, H, W) float32): (closure returning (new_state, outputs), count),
    where count(output) is the hand model of that call."""
    p = trk.params

    def step():
        return tracker._track_step(
            LR, trk._state, trk._radii, p.refine_radius, trk._desc_thr, trk._ratio, trk.K,
            trk.baseline, trk.scale_factors, p, trk.width, trk.height,
        )

    def count(out):
        return track_step_count(trk, LR, step, needed=True)

    return step, count


def track_step_count(trk: tracker.StereoTracker, LR: torch.Tensor, step, needed: bool) -> dict:
    """The hand model of one ``_track_step`` call: extraction and stereo
    matching, then per attempt of the radius loop and the refine pass the
    culling, the projection matching (left, and right in the refine pass)
    and the two-start LM at its iterations, read by watching
    ``lm.motion_only_ba``, ``lm.lm_solve`` and
    ``project_match.match_by_projection`` during one more call (on the card
    the LM is the kernel: no ``lm_solve`` passes, the iterations from its
    `stats`). `needed`: each LM problem at the iterations it ran; else at
    the loop passes the code computes (on the CPU a finished problem is
    computed until all are done; the kernel computes what each needs). The
    failure gate, miss aging and the per-attempt gathers are left out."""
    p = trk.params
    B, H, W = LR.shape
    with counts.recording(lm, "motion_only_ba") as solves, counts.recording(lm, "lm_solve") as passes, \
            counts.recording(project_match, "match_by_projection") as matches:
        out = step()
    flop = counts.extract_flops(B, H, W, p.n_levels, p.scale, p.n_features)
    flop += counts.stereo_flops(1, p.n_features, p.n_features)
    for i, (args, kw, _) in enumerate(solves):
        S, M = args[1].shape[0] // 2, args[1].shape[-2]
        if not passes:
            # on the card motion_only_ba is one kernel launch and makes no
            # lm_solve passes: its `stats` hold each pass's per-problem
            # iterations, and each problem computes only those
            its = list(kw["stats"])
        else:
            its = [r.iterations for _, _, r in passes[2 * i:2 * i + 2]]
            if not needed:
                its = [counts.computed_iterations(t, kw["max_iters"], lm._DONE_CHECK_EVERY) for t in its]
        flop += counts.lm_flops(M, its) + counts.cull_flops(S, M)
    for args, _, _ in matches:
        flop += counts.match_flops(1 if args[0].ndim == 2 else args[0].shape[0], args[0].shape[-2],
                                   args[4].shape[-2])
    return {"flop": flop, "bytes": counts.nbytes(LR, trk._state, out)}


def run(frames=None, reps: int = 10, twins: bool = True) -> dict:
    """The audit: warm-up on the scene's first 8 frames, then every stage
    on frame 9, `reps` calls per timing. `frames`: the scene's (2, H, W)
    uint8 L+R frames, rendered here (or read from the render cache) when
    None. `twins`: also time the patch rows' plain versions and library
    calls (off where a caller counts calls of the plain versions). Returns
    the JSON line's fields, plus ``outputs``: frame 9's extract_batch keys
    and stereo results as numpy arrays."""
    _common.require_card("roofline")
    scene = _common.bench_scene(N_FRAMES)
    frames = frames if frames is not None else _common.scene_frames(scene)
    dev = torch.device("cuda")
    staged = [torch.from_numpy(np.ascontiguousarray(f)).to(dev) for f in frames[:N_FRAMES]]
    trk, mapper = _common.make_tracker(scene, dev)
    warm_launches = _common.warm_up(trk, mapper, staged)
    LR = staged[FRAME].to(torch.float32)
    stages = frame_stages(LR, trk.params, trk.K[0, 0], trk.baseline)
    stages["_track_step (full)"] = track_step_stage(trk, LR)
    rows, outs = [], {}
    for name, (fn, count) in stages.items():
        n0 = patches.LAUNCHES
        outs[name] = fn()
        windows = patches.LAUNCHES - n0
        m = _common.measure(fn, reps)
        r = {"stage": name, **m, **counts.bound(count(outs[name]), m["device_ms"]),
             "extract_windows_launches": windows}
        # a kernel row: its plain version's and the library call's device ms
        for twin, twin_fn in (getattr(fn, "twins", {}) if twins else {}).items():
            r[f"{twin}_ms"] = timing.primed_device_ms(twin_fn, reps=4 if twin == "plain" else 8)
        rows.append(r)
        print(f"{name:26s} dev={r['device_ms']:8.4f} ms ({r['device_method']}) disp={r['dispatch_ms']:8.3f} "
              f"blk={r['blocked_ms']:8.3f} launches={r['launches']:6d} syncs={r['syncs']:3d} "
              f"{r['gflop']:9.4f} GF {r['mbytes']:8.3f} MB sol={r['sol_ms']:.5f} ms ({r['bound']}) "
              f"share={r['share_pct']:.3f}%", flush=True)
    mapper.close()
    outputs = {"keys": {k: v.cpu().numpy() for k, v in outs["extract_batch(x2)"]._asdict().items()},
               "stereo": {k: v.cpu().numpy() for k, v in outs["stereo_match"].items()}}
    return {"rows": rows, "warmup_frames": _common.WARMUP_FRAMES,
            "warmup_extract_windows_launches": warm_launches, "outputs": outputs}


def markdown(rows: list) -> str:
    lines = ["| stage | device ms (method) | dispatch ms | blocked ms | launches | syncs | GFLOP | MB "
             "| SoL ms (bound) | % of roofline |", "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['stage']} | {r['device_ms']:.4f} ({r['device_method']}) | {r['dispatch_ms']:.3f} | "
            f"{r['blocked_ms']:.3f} | {r['launches']} | {r['syncs']} | {r['gflop']:.4f} | {r['mbytes']:.3f} | "
            f"{r['sol_ms']:.5f} ({r['bound']}) | {r['share_pct']:.3f} |")
    return "\n".join(lines)


def main(reps: int = 10) -> dict:
    out = run(reps=reps)
    print("\nmarkdown:\n" + markdown(out["rows"]), flush=True)
    return _common.emit("roofline", out["rows"], warmup_frames=out["warmup_frames"],
                        warmup_extract_windows_launches=out["warmup_extract_windows_launches"])


if __name__ == "__main__":
    main()
