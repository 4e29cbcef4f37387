"""The hand FLOP and byte model of the tracked frame's stages, from which
the roofline's bounds come (the port's counterpart of XLA's
``cost_analysis()`` in the JAX repo's tools/roofline.py).

Bytes: each input byte read once and each output byte written once
(:func:`nbytes`); the window stages count the level pixels their windows
cover (``kernels/timing.window_bytes``).

Operations: what the port's code computes for these inputs, read off the
code: one per output element of an elementwise op (arithmetic, compare,
select, clamp, round, transcendental), n_in - n_out per reduction, 2MNK
per matrix product; indexing, copies, padding, sorts and top-k selections
count none. The per-element coefficients below follow each op in turn;
tests/test_torch_tools.py holds every function against an op-by-op count
of the same call on the CPU. Work that depends on the data is counted as
these inputs need it: the LM at the iterations each problem ran
(``LMResult.iterations`` of each pass; on the card the kernel's per-pass
counts, which ``motion_only_ba`` hands to its `stats`), the tracker at
the attempts it made. A term
left out is named where it is left out; the bound then errs low.

Peaks (NVIDIA H100 SXM data sheet): float32 outside the tensor cores, as
the port turns TF32 off (vslam_torch/__init__.py), and the HBM rate.
"""

from __future__ import annotations

import contextlib

import torch

from vslam_torch.kernels import timing
from vslam_torch.ops import extract, orb, pyramid

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = timing.HBM_BYTES_PER_S

# per output pixel: bilinear resize (6 mul + 3 add)
RESIZE_OPS = 9
# per tap and pixel of each separable blur pass (mul + add); the row pass
# runs over the 2 * (ksize // 2) padded rows too
BLUR_TAP_OPS = 2
# FAST-9/16 per pixel and image: 16 ring differences, 16 negations, 2 x 16
# arc minima of 9 (8 ops each), 2 x 15 + 1 maxima, threshold and select (2),
# border select (1); per pixel of the level (shared by the batch): the
# border mask's 2 ands
FAST_SCORE_OPS, FAST_MASK_OPS = 16 + 16 + 256 + 31 + 2 + 1, 2
# 3x3 NMS per pixel: 8 compares, 8 ands, 1 select; the strong-corner boost
# (compare, add, select); ANMS's border select; its mask's 2 ands per
# level pixel
NMS_OPS, BOOST_OPS, ANMS_OPS, ANMS_MASK_OPS = 17, 3, 1, 2
# per key: intensity centroid (2 x 961 products, 2 x 960 sums, atan2)
ORIENT_OPS = 4 * orb.PATCH * orb.PATCH - 1
# per key: cos, sin; per pattern pair, both points rotated (8 each),
# shifted and clamped into the patch (8), flattened (4), compared (1),
# shifted into its word (1), +-1 (2); per word the 31 adds of its pack
BRIEF_OPS = 2 + 32 * orb.N_BITS + 8 * 31
# stereo matching per (left, right) pair beyond the Hamming product: the
# distance scale (2), row, octave and disparity gates, their selects and
# the argmin (18 in all); per left key: the 11 SAD slides over the 11x11
# window (subtract, abs, sum per pixel and slide) with the refinement and
# prunes (5584); per right key: the row tolerance (2); per pair of images:
# 11
STEREO_PAIR_OPS, STEREO_KEY_OPS, STEREO_RIGHT_OPS, STEREO_CONST_OPS = 18, 5584, 2, 11
# projection matching per (landmark, key) pair beyond the Hamming product:
# distance scale, spatial and octave gates, best and second best, the
# one-to-one claim (17); per landmark 13
MATCH_PAIR_OPS, MATCH_LM_OPS = 17, 13
# predict_and_cull per landmark (transform, projection, bounds, scale band,
# octave) and per problem (the pose inverse)
CULL_LM_OPS, CULL_CONST_OPS = 69, 21
# motion-only LM per problem and iteration: the residuals and Jacobian of
# each row (3 residuals x 6; the first, Huber-reweighted pass 46 more per
# row), J^T J and J^T r, the 6x6 solve, the retraction and the trial
# residual; per problem and call: the start residuals, the two
# chi-squared sweeps and the guard; shared by the problems: the weights.
# The done flags' reads (B - 1 ops every 4 iterations) are left out.
LM_ITER_ROW_OPS = (548, 502)  # the robust pass, then the plain one
LM_ITER_CONST_OPS = 752
LM_ROW_OPS, LM_CONST_OPS, LM_SHARED_ROW_OPS, LM_SHARED_OPS = 391, 148, 6, 1


def nbytes(*trees) -> int:
    """Bytes of the distinct tensor storages in nested tuples, lists and
    dicts of tensors (a tensor reached twice, or a view of one already
    counted, counts once)."""
    seen: dict = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            s = x.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    for t in trees:
        walk(t)
    return sum(seen.values())


def pyramid_flops(B: int, shapes: list, blurred: int, ksize: int = 7) -> int:
    """The resize of every level past the first and the blur of the first
    `blurred` levels, for B images."""
    half = ksize // 2
    ops = sum(RESIZE_OPS * h * w for h, w in shapes[1:])
    ops += sum(BLUR_TAP_OPS * ksize * ((h + 2 * half) * w + h * w) for h, w in shapes[:blurred])
    return B * ops


def detect_flops(B: int, h: int, w: int) -> int:
    """fast.detect on B (h, w) images: score, NMS, boost and the ANMS
    border (the per-cell top-k and its ranking are left out: selections)."""
    per_image = FAST_SCORE_OPS + NMS_OPS + BOOST_OPS + ANMS_OPS
    return B * h * w * per_image + h * w * (FAST_MASK_OPS + ANMS_MASK_OPS)


def orient_brief_flops(n_keys: int) -> int:
    return n_keys * (ORIENT_OPS + BRIEF_OPS)


def stereo_flops(B: int, N: int, M: int) -> int:
    """match_stereo of B pairs, N left and M right keys each."""
    return B * (2 * orb.N_BITS * N * M + STEREO_PAIR_OPS * N * M + STEREO_KEY_OPS * N
                + STEREO_RIGHT_OPS * M + STEREO_CONST_OPS)


def match_flops(B: int, A: int, N: int) -> int:
    """match_by_projection of B problems, A landmarks against N keys."""
    return B * (2 * orb.N_BITS * A * N + MATCH_PAIR_OPS * A * N + MATCH_LM_OPS * A)


def cull_flops(B: int, A: int) -> int:
    return B * (CULL_LM_OPS * A + CULL_CONST_OPS)


def lm_flops(M: int, passes: list) -> int:
    """motion_only_ba over M rows: `passes` holds, per LM pass (the robust
    one, then the plain one), the (B,) iterations each problem ran."""
    ops = len(passes[0]) * (LM_ROW_OPS * M + LM_CONST_OPS) + LM_SHARED_ROW_OPS * M + LM_SHARED_OPS
    for its, row_ops in zip(passes, LM_ITER_ROW_OPS, strict=True):
        ops += sum(int(i) for i in its) * (row_ops * M + LM_ITER_CONST_OPS)
    return ops


def computed_iterations(its: torch.Tensor, max_iters: int, check_every: int) -> list:
    """The loop passes every problem of a batch computes (a finished
    problem is frozen but still computed until the host reads that all are
    done, every `check_every` iterations): what the code runs, where
    ``its`` is what each problem needs."""
    top = int(its.max())
    passes = min(max_iters, -(-top // check_every) * check_every)
    return [passes] * len(its)


def extract_flops(B: int, H: int, W: int, n_levels: int, scale: float, total: int) -> int:
    """extract_batch of B (H, W) images: the pyramid, the blur and FAST of
    every level with a quota, orientation and BRIEF of every key (the
    corners and coordinates per key are left out)."""
    shapes = pyramid.level_shapes(H, W, n_levels, scale)
    quotas = extract.level_quotas(total, n_levels, scale)
    ops = B * sum(RESIZE_OPS * h * w for h, w in shapes[1:])
    for (h, w), q in zip(shapes, quotas):
        if q > 0:
            ops += pyramid_flops(B, [(h, w)], 1) + detect_flops(B, h, w)
    return ops + orient_brief_flops(B * total)


@contextlib.contextmanager
def recording(module, name: str):
    """Watch ``module.name`` for the block: yields a list that receives
    (args, kwargs, result) of every call. Nothing computed changes."""
    real = getattr(module, name)
    calls: list = []

    def watched(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, watched)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def bound(c: dict, device_ms: float) -> dict:
    """The table columns of a count `c` ({"flop", "bytes"}) against a
    measured device time: the least time (the larger of the operations
    over the f32 peak and the bytes over the HBM rate), what bounds it,
    and the share of it the device time reaches."""
    t_flop = c["flop"] / PEAK_F32_FLOPS * 1e3
    t_bytes = c["bytes"] / PEAK_BYTES_PER_S * 1e3
    sol = max(t_flop, t_bytes)
    return {"flop": c["flop"], "bytes": c["bytes"], "gflop": c["flop"] / 1e9, "mbytes": c["bytes"] / 1e6,
            "sol_ms": sol, "bound": "operations" if t_flop > t_bytes else "bytes",
            "share_pct": 100.0 * sol / device_ms}
