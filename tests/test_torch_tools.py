"""The port's measuring tools (vslam_torch/tools) on the CPU, at 320x240,
512 features, 4 levels:

- the roofline's, profile_extract's and profile_solver's stage closures
  against the same closures built from vslam_tpu functions here, on the
  same numpy inputs (keys, octaves, masks and match indices exact; the
  Pallas window kernel in interpret mode, exact; floats to the tolerances
  of tests/test_torch_extract.py and tests/test_torch_matching.py);
- every function of the hand FLOP and byte model (tools/counts.py)
  against an op-by-op count of the same call (:class:`OpCounter`), the
  window bytes against a pixel-by-pixel count;
- metrics.count_events on a recorded event list;
- every tool's main() raising without a card.

tests/test_torch_cuda.py runs each tool's main at a small size on the
card."""

import collections
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from test_torch_extract import ANGLE_F64_TOL, _float64_angles, _pallas_interpret
from vslam_torch.kernels import timing
from vslam_torch.models import tracker as ttr
from vslam_torch.ops import extract as text, fast as tfast, lm as tlm, project_match as tpm, stereo_match as tsm
from vslam_torch.tools import (
    _common, ab_kf_policy, counts, measure_ba_scaling, profile_bench, profile_depth, profile_device,
    profile_extract, profile_frame, profile_rtt, profile_solver, roofline,
)
from vslam_torch.utils import metrics
from vslam_tpu.ops import extract as jext, fast as jfast, lm as jlm, orb as jorb, project_match as jpm
from vslam_tpu.ops import pyramid as jpyr, stereo_match as jsm
from vslam_tpu.utils import synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

W, H = 320, 240
PARAMS = dict(n_features=512, n_levels=4, active_size=1024)
KW = dict(n_levels=4, scale=1.2, total=512, edge_margin=19, fast_hi=20.0, fast_lo=7.0)
FX, BASELINE = 460.0, 0.12
# the hand model leaves out named lower-order terms (per row and column,
# per cell of the ANMS, per key of the corner arithmetic, the tracker's
# gathers and failure gate): it must cover all but this share of the ops
# the code runs
MODEL_TOL = 5e-3
# profile_extract's image is uniform noise, whose intensity centroids are
# small: the two libraries' float32 moment sums part by up to 2e-4 rad
# there. Angles are held against a float64 oracle instead: the port to
# test_torch_extract.py's ANGLE_F64_TOL, JAX to its own float32 band
# (up to 5.7e-4 rad on the natural texture, ROADMAP queue C)
JAX_F64_TOL = 1e-3


class OpCounter(TorchDispatchMode):
    """Operations of the aten calls made under it, by tools/counts.py's
    rules: one per output element of an elementwise op, n_in - n_out per
    reduction, 2MNK per matrix product, k^3 * 2/3 + 2k^2 per k x k solve;
    data movement, sorts and top-k none."""

    MOVE = {
        "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "select", "slice",
        "index", "index_select", "gather", "cat", "stack", "clone", "copy_", "_to_copy", "contiguous",
        "constant_pad_nd", "replication_pad2d", "reflection_pad2d", "empty", "zeros", "ones", "full",
        "arange", "sort", "topk", "unsqueeze", "squeeze", "diagonal", "diag_embed", "alias", "detach",
        "lift_fresh", "lift_fresh_copy", "unbind", "split", "narrow", "flip", "repeat", "index_put",
        "index_put_", "_local_scalar_dense", "eye", "zeros_like", "full_like", "empty_like", "ones_like",
        "fill_", "as_strided", "scalar_tensor", "nonzero", "empty_strided", "scatter", "expand_as",
        "split_with_sizes", "zero_", "new_zeros", "new_empty", "new_full", "new_ones", "clamp_min_",
        "argsort", "_unsafe_index", "masked_fill",
    }
    REDUCE = {"sum", "amin", "amax", "min", "max", "argmin", "argmax", "mean", "any", "all", "prod"}

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        first = out[0] if isinstance(out, (tuple, list)) else out
        if name in self.MOVE:
            n = 0
        elif name in ("mm", "bmm"):
            n = 2 * args[0].numel() * args[1].shape[-1]
        elif name == "addmm":
            n = 2 * args[1].numel() * args[2].shape[-1]
        elif name in self.REDUCE:
            n = args[0].numel() - first.numel()
        elif name in ("scatter_reduce", "scatter_add"):
            n = args[3].numel()
        elif name in ("linalg_solve_ex", "_linalg_solve_ex"):
            k = args[0].shape[-1]
            n = args[0][..., 0, 0].numel() * (2 * k**3 // 3 + 2 * k * k)
        else:
            n = first.numel() if isinstance(first, torch.Tensor) else 0
        self.ops[name] += n
        return out

    @property
    def total(self) -> int:
        return sum(self.ops.values())


def _count(fn):
    with OpCounter() as c:
        out = fn()
    return c.total, out


@pytest.fixture(scope="module")
def scene():
    s = synthetic.make_scene(n_frames=12, n_points=400, width=W, height=H, fps=10.0, seed=7)
    s.pairs = [np.stack([s.render(f), s.render(f, right=True)]).astype(np.uint8) for f in range(10)]
    return s


@pytest.fixture(scope="module")
def roof(scene):
    """The roofline's frame stages on frame 9 of the scene, each run once."""
    LR = torch.from_numpy(scene.pairs[roofline.FRAME]).float()
    stages = roofline.frame_stages(LR, ttr.TrackerParams(**PARAMS), torch.tensor(FX), torch.tensor(BASELINE))
    return {"LR": LR, "stages": stages, "out": {name: fn() for name, (fn, _) in stages.items()}}


def _stage(roof, prefix):
    (name,) = [n for n in roof["stages"] if n.startswith(prefix)]
    return name, roof["out"][name]


def _assert_keys(t, j, n_ok=0.99):
    """Keypoints exact, angles within 1e-4 rad, >= 99% of the valid keys'
    descriptors identical and none more than 2 bits off."""
    for name in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)), err_msg=name)
    valid = np.asarray(t.valid)
    np.testing.assert_allclose(np.asarray(t.angle)[valid], np.asarray(j.angle)[valid], atol=1e-4, rtol=0)
    dbits = (np.asarray(t.desc) != np.asarray(j.desc)).sum(axis=-1)[valid]
    assert (dbits == 0).mean() >= n_ok and dbits.max() <= 2, np.bincount(dbits)


def _level0_call(LR_shape):
    """extract_batch's level-0 detect call: quota, ANMS cell, border."""
    _, h, w = LR_shape
    q0 = text.level_quotas(KW["total"], KW["n_levels"], KW["scale"])[0]
    return q0, max(8, min(35, int((h * w / q0) ** 0.5))), min(KW["edge_margin"], min(h, w) // 4)


ROOF_STAGES = ["extract_batch(x2)", "pyramid+blur", "fast.detect L0", "patches L0", "patches frame",
               "orient+BRIEF", "stereo_match"]


@pytest.mark.parametrize("prefix", ROOF_STAGES)
def test_roofline_stage_matches_jax(roof, prefix):
    """Each of the roofline's frame stages against its JAX counterpart on
    the same frame: keys exact (descriptors and angles by _assert_keys),
    pyramid levels and FAST exact, the windows exact against the TPU
    kernel body in interpret mode, stereo idx_r / matched exact and its
    floats to test_torch_matching.py's tolerances."""
    LR = roof["LR"]
    imgs = jnp.asarray(LR.numpy())
    name, out = _stage(roof, prefix)
    keys_t = roof["out"]["extract_batch(x2)"]
    if prefix == "extract_batch(x2)":
        j = jext.extract_batch(imgs, **KW)
        _assert_keys(out, j)
        np.testing.assert_array_equal(out.response.numpy(), np.asarray(j.response))
    elif prefix == "pyramid+blur":
        cur = imgs
        for lvl, (h, w) in enumerate(jpyr.level_shapes(H, W, KW["n_levels"], KW["scale"])):
            cur = jpyr.resize_bilinear_batch(cur, h, w) if lvl else cur
            np.testing.assert_array_equal(out[lvl].numpy(), np.asarray(jpyr.gaussian_blur_batch(cur)))
    elif prefix == "fast.detect L0":
        q0, cell0, margin0 = _level0_call(LR.shape)
        j = jax.vmap(lambda im: jfast.detect(im, 20.0, 7.0, cell=cell0, max_keypoints=q0, edge_margin=margin0))(imgs)
        for t, jj in zip(out, j):
            np.testing.assert_array_equal(t.numpy(), np.asarray(jj))
    elif prefix == "patches L0":
        q0 = _level0_call(LR.shape)[0]
        xy = keys_t.xy.numpy().astype(np.int32)[:, :q0]
        x0, y0 = np.clip(xy[..., 0] - 15, 0, W - 31), np.clip(xy[..., 1] - 15, 0, H - 31)
        np.testing.assert_array_equal(out.numpy(), _pallas_interpret(LR.numpy(), x0, y0, 31, 31))
    elif prefix == "patches frame":
        win = text.window_inputs(LR, **KW)
        parts, first = [], 0
        cur = imgs
        for lvl, ((h, w), q) in enumerate(zip(jpyr.level_shapes(H, W, KW["n_levels"], KW["scale"]), win.counts)):
            cur = jpyr.resize_bilinear_batch(cur, h, w) if lvl else cur
            sl = slice(first, first + q)
            parts.append(_pallas_interpret(np.asarray(jpyr.gaussian_blur_batch(cur)), win.x0[:, sl].numpy(),
                                           win.y0[:, sl].numpy(), 31, 31))
            first += q
        np.testing.assert_array_equal(out.numpy(), np.concatenate(parts, axis=1))
    elif prefix == "orient+BRIEF":
        patch = jnp.asarray(roof["out"]["patches frame (1 launch)"].numpy())
        ang = jorb.orientation_from_patches(patch)
        _, signed = jorb.brief_from_patches(patch, ang)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ang), atol=1e-4, rtol=0)
        dbits = (out[2].numpy() != np.asarray(signed)).sum(axis=-1)
        assert (dbits == 0).mean() >= 0.99 and dbits.max() <= 2, np.bincount(dbits.ravel())
    else:
        args = [imgs[0], imgs[1]]
        for i in (0, 1):
            args += [jnp.asarray(getattr(keys_t, n)[i].numpy()) for n in ("xy", "octave", "desc", "valid")]
        sf = jnp.asarray(text.scale_factors(KW["n_levels"], KW["scale"]))
        j = jsm.match_stereo(*args, jnp.float32(FX), jnp.float32(BASELINE), sf, close_factor=40.0)
        assert out["matched"].sum() > 100
        for n in ("idx_r", "matched", "close", "desc_dist"):
            np.testing.assert_array_equal(out[n].numpy(), np.asarray(j[n]), err_msg=n)
        for n in ("disparity", "est_right_x"):
            np.testing.assert_allclose(out[n].numpy(), np.asarray(j[n]), atol=1e-5, rtol=0, err_msg=n)
        np.testing.assert_allclose(out["depth"].numpy(), np.asarray(j["depth"]), rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def extract_rows(monkeypatch_module):
    for name, value in (("H", H), ("W", W), ("N_LEVELS", KW["n_levels"]), ("TOTAL", KW["total"])):
        monkeypatch_module.setattr(profile_extract, name, value)
    x = profile_extract.inputs()
    return x, {name: fn() for name, fn in profile_extract.stages(x, "cpu").items()}


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


EXTRACT_STAGES = ["pyramid x8", "fast L0", "fast+nms L0", "detect L0", "blur L0", "orient 256", "brief 256",
                  "extract full", "detect x8"]


def _angles_against_f64(keys, img: np.ndarray, angle_j, n_levels: int):
    """Every valid key's angle (`keys`: xy, octave, valid, angle of one
    image) against orientations of its blurred level in float64: the
    port's within ANGLE_F64_TOL, JAX's within JAX_F64_TOL."""
    batched = types.SimpleNamespace(xy=keys.xy[None], octave=keys.octave[None], valid=keys.valid[None])
    (sel, ang64), = _float64_angles(img[None], batched, n_levels, 1.2)
    assert sel.sum() == keys.valid.sum() > 0
    for ang, tol in ((keys.angle.numpy(), ANGLE_F64_TOL), (np.asarray(angle_j), JAX_F64_TOL)):
        err = np.abs(np.angle(np.exp(1j * (ang.astype(np.float64) - ang64))))[sel]
        assert err.max() <= tol, (err.max(), tol)


@pytest.mark.parametrize("prefix", EXTRACT_STAGES)
def test_profile_extract_stage_matches_jax(extract_rows, prefix):
    """profile_extract's closures on its seeded image (here 320x240, 512
    features, 4 levels) against the JAX tool's: levels, scores and keys
    exact, angles against a float64 oracle (_angles_against_f64),
    descriptors by _assert_keys's rule."""
    x, rows = extract_rows
    (name,) = [n for n in rows if n.startswith(prefix)]
    out = rows[name]
    n_levels, total = KW["n_levels"], KW["total"]
    img = jnp.asarray(x["img"])
    blurred = jpyr.gaussian_blur(img)
    xy_j, _, valid_j = jfast.detect(img, 20.0, 7.0, cell=35, max_keypoints=256, edge_margin=19)
    if prefix == "pyramid x8":
        for t, j in zip(out, jpyr.build_pyramid(img, n_levels, 1.2), strict=True):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    elif prefix in ("fast L0", "fast+nms L0"):
        j = jfast.fast_score(img, 7.0)
        j = jfast.nms3x3(j) if prefix == "fast+nms L0" else j
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(j))
    elif prefix == "detect L0":
        j = jfast.detect(img, 20.0, 7.0, cell=35, max_keypoints=256, edge_margin=19)
        for t, jj in zip(out, j, strict=True):
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(jj))
    elif prefix == "blur L0":
        np.testing.assert_array_equal(out.numpy(), np.asarray(blurred))
    elif prefix == "orient 256":
        keys = types.SimpleNamespace(xy=torch.from_numpy(np.asarray(xy_j)).float(), octave=torch.zeros(256).long(),
                                     valid=torch.from_numpy(np.asarray(valid_j)), angle=out)
        _angles_against_f64(keys, x["img"], jorb.orientations(blurred, xy_j), 1)
    elif prefix == "brief 256":
        _, signed = jorb.brief_descriptors(blurred, xy_j, jorb.orientations(blurred, xy_j))
        dbits = (out[1].numpy() != np.asarray(signed)).sum(axis=-1)
        assert (dbits == 0).mean() >= 0.99 and dbits.max() <= 2, np.bincount(dbits)
    elif prefix == "extract full":
        # JAX's one-image extract is its batched form's row 0
        j = jext.extract_batch(img[None], n_levels=n_levels, scale=1.2, total=total, edge_margin=19,
                               fast_hi=20.0, fast_lo=7.0)
        j = types.SimpleNamespace(**{k: np.asarray(v[0]) for k, v in j._asdict().items()})
        _angles_against_f64(out, x["img"], j.angle, n_levels)
        _assert_keys(out, types.SimpleNamespace(**{**vars(j), "angle": out.angle.numpy()}))
    else:
        levels = jpyr.build_pyramid(img, n_levels, 1.2)
        quotas = [q for q in jext.level_quotas(total, n_levels, 1.2) if q > 0]
        for t, im_l, q in zip(out, levels, quotas, strict=True):
            h, w = im_l.shape
            j = jfast.detect(im_l, 20.0, 7.0, cell=min(35, max(h, w)), max_keypoints=q,
                             edge_margin=min(19, min(h, w) // 4))
            for tt, jj in zip(t, j, strict=True):
                np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jj))


@pytest.fixture(scope="module")
def solver_rows(monkeypatch_module):
    monkeypatch_module.setattr(profile_solver, "A", 512)
    monkeypatch_module.setattr(profile_solver, "N", 128)
    monkeypatch_module.setattr(profile_solver, "ITERS", (10,))
    x = profile_solver.inputs()
    return x, {name: fn() for name, fn in profile_solver.stages(x, "cpu").items()}


@pytest.mark.parametrize("prefix", ["motion_ba", "proj match", "predict_cull"])
def test_profile_solver_stage_matches_jax(solver_rows, prefix):
    """profile_solver's closures on its seeded problem (here A=512, N=128)
    against the JAX tool's: match indices and distances (random
    descriptors: none passes the threshold, as in the JAX tool), culls and
    octaves exact; the LM on its random observations runs off to ~250 m
    in 10 iterations, each library in float32, which amplifies their
    rounding: rotation entries within 1e-5, translation within 1e-4
    relative (measured 1.05e-5), the same iterations."""
    x, rows = solver_rows
    (name,) = [n for n in rows if n.startswith(prefix)]
    out = rows[name]
    j = {k: jnp.asarray(v) for k, v in x.items()}
    A, N = x["pts"].shape[0], x["k_xy"].shape[0]
    sf = jnp.asarray([1.2**lvl for lvl in range(8)], jnp.float32)
    T0 = jnp.eye(4, dtype=jnp.float32)
    if prefix == "motion_ba":
        T_j, _, inl_j, _, r_j = jlm.motion_only_ba(
            T0, j["pts"], j["obs"], jnp.ones(A, jnp.float32), j["stereo"], jnp.zeros_like(j["stereo"]),
            j["valid"], j["K"], jnp.float32(0.12), max_iters=10)
        T_t, T_j = out[0][0].numpy(), np.asarray(T_j)
        np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=1e-5, rtol=0)
        np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=0, rtol=1e-4)
        assert int(out[4].iterations[0]) == int(r_j.iterations)
    elif prefix == "proj match":
        midx, dist = jpm.match_by_projection(
            j["mp_pred"], j["mp_oct"], j["mp_desc"], j["valid"], j["k_xy"], j["k_oct"], j["k_desc"],
            jnp.ones(N, bool), jnp.float32(40.0), sf, jnp.float32(100.0), jnp.float32(0.8))
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(midx))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(dist))
    else:
        pj = jpm.predict_and_cull(T0, j["pts"], j["valid"], j["K"], jnp.float32(0.12), 752, 480,
                                  jnp.ones(A, jnp.float32) * 30, jnp.ones(A, jnp.float32), n_levels=8)
        for n in ("in_l", "in_r", "pred_oct"):
            np.testing.assert_array_equal(out[n].numpy(), np.asarray(pj[n]), err_msg=n)
        np.testing.assert_allclose(out["pred_l"].numpy(), np.asarray(pj["pred_l"]), atol=1e-3, rtol=0)


# ---------------------------------------------------------------- the hand model


def _rand_keys(rng, B, n, h, w):
    xy = np.stack([rng.uniform(0, w, (B, n)), rng.uniform(0, h, (B, n))], -1).astype(np.float32)
    return (torch.from_numpy(xy), torch.from_numpy(rng.integers(0, 4, (B, n))),
            torch.from_numpy((rng.integers(0, 2, (B, n, 256)) * 2 - 1).astype(np.int8)),
            torch.ones(B, n, dtype=torch.bool))


def _motion_case(rng, A):
    x = {"K": torch.tensor([[460.0, 0, 160.0], [0, 460.0, 120.0], [0, 0, 1.0]])}
    x["pts"] = torch.from_numpy(np.stack([rng.uniform(-5, 5, A), rng.uniform(-3, 3, A), rng.uniform(4, 40, A)],
                                         -1).astype(np.float32))
    x["obs"] = torch.from_numpy(rng.uniform(0, 240, (A, 3)).astype(np.float32))
    x["st"] = torch.from_numpy(rng.integers(0, 2, A).astype(bool))
    x["valid"] = torch.from_numpy(rng.integers(0, 2, A).astype(bool))
    return x


COUNT_CASES = ["pyramid", "detect", "orient_brief", "stereo", "match", "cull", "lm", "extract"]


@pytest.mark.parametrize("case", COUNT_CASES)
def test_count_function_against_op_count(roof, case):
    """Each counts.py function against the ops its call runs, counted op by
    op: exact where the model has every term, the LM within 1e-4, the
    pyramid, FAST and the whole extraction within MODEL_TOL."""
    rng = np.random.default_rng(3)
    LR = roof["LR"]
    B = LR.shape[0]
    if case == "pyramid":
        n, _ = _count(lambda: roofline.pyramid_blur(LR, 4, 1.2))
        model, tol = counts.pyramid_flops(B, jpyr.level_shapes(H, W, 4, 1.2), 4), MODEL_TOL
    elif case == "detect":
        n, _ = _count(lambda: tfast.detect(LR, 20.0, 7.0, cell=35, max_keypoints=165, edge_margin=19))
        model, tol = counts.detect_flops(B, H, W), MODEL_TOL
    elif case == "orient_brief":
        patch = torch.from_numpy(rng.uniform(0, 255, (2, 64, 31, 31)).astype(np.float32))
        n, _ = _count(lambda: roofline.orb.brief_from_patches(patch, roofline.orb.orientation_from_patches(patch)))
        model, tol = counts.orient_brief_flops(128), 0
    elif case == "stereo":
        kl, kr = _rand_keys(rng, 1, 96, H, W), _rand_keys(rng, 1, 80, H, W)
        n, _ = _count(lambda: tsm.match_stereo(LR[:1], LR[1:], *kl, *kr, torch.tensor([FX]),
                                               torch.tensor([BASELINE]), torch.tensor([1.2**i for i in range(4)])))
        model, tol = counts.stereo_flops(1, 96, 80), 0
    elif case == "match":
        lm_xy, lm_oct, lm_desc, lm_valid = _rand_keys(rng, 2, 70, H, W)
        kxy, koct, kdesc, kvalid = _rand_keys(rng, 2, 50, H, W)
        n, _ = _count(lambda: tpm.match_by_projection(lm_xy, lm_oct, lm_desc, lm_valid, kxy, koct, kdesc, kvalid,
                                                      40.0, torch.tensor([1.2**i for i in range(4)]), 100.0, 0.8))
        model, tol = counts.match_flops(2, 70, 50), 0
    elif case == "cull":  # as the tracker calls it: one sequence
        x = _motion_case(rng, 90)
        n, _ = _count(lambda: tpm.predict_and_cull(torch.eye(4)[None], x["pts"][None], x["valid"][None],
                                                   x["K"][None], torch.tensor([0.12]), W, H,
                                                   torch.full((1, 90), 30.0), torch.ones(1, 90), n_levels=4))
        model, tol = counts.cull_flops(1, 90), 0
    elif case == "lm":
        x = _motion_case(rng, 120)
        T0 = torch.eye(4)[None].repeat(3, 1, 1)
        with counts.recording(tlm, "lm_solve") as passes:
            n, _ = _count(lambda: tlm.motion_only_ba(T0, x["pts"], x["obs"], torch.ones(120), x["st"],
                                                     torch.zeros_like(x["st"]), x["valid"], x["K"],
                                                     torch.tensor(0.12), max_iters=9))
        its = [counts.computed_iterations(r.iterations, 9, tlm._DONE_CHECK_EVERY) for _, _, r in passes]
        model, tol = counts.lm_flops(120, its), 1e-4  # the done checks are left out
    else:
        n, _ = _count(lambda: text.extract_batch(LR, **KW))
        model, tol = counts.extract_flops(B, H, W, 4, 1.2, 512), MODEL_TOL
    assert n > 0 and abs(model - n) <= tol * n, (case, model, n, model / n)


def test_track_step_count_against_op_count(scene):
    """The roofline's _track_step count (each LM problem at the loop passes
    the code computes) against the ops of the same call, within MODEL_TOL;
    the count of what the problems needed is at most that."""
    trk, mapper = _common.make_tracker(scene, "cpu", **PARAMS)
    _common.warm_up(trk, mapper, [torch.from_numpy(f) for f in scene.pairs])
    LR = torch.from_numpy(scene.pairs[roofline.FRAME]).float()
    step, count = roofline.track_step_stage(trk, LR)
    n, out = _count(step)
    computed = roofline.track_step_count(trk, LR, step, needed=False)["flop"]
    needed = count(out)
    assert abs(computed - n) <= MODEL_TOL * n, (computed, n, computed / n)
    assert 0 < needed["flop"] <= computed and needed["bytes"] > LR.numel() * 4
    assert np.isfinite(out[1]["blob"].numpy()).all()


def test_window_bytes_against_pixel_count(roof):
    """The one-launch patch row's bytes are kernels/timing.py's bound bytes
    for the same corners, and both are the (B, N, 31, 31) output, the
    corners and every distinct level pixel a window covers, counted here
    window by window."""
    LR = roof["LR"]
    win = text.window_inputs(LR, **KW)
    name, out = _stage(roof, "patches frame")
    row_bytes = roof["stages"][name][1](out)["bytes"]
    idx = timing.gather_index(win.blurred, win.counts, win.x0, win.y0, 31)
    assert row_bytes == timing.window_bytes(idx, win.x0, 31)[0]
    covered, first = 0, 0
    for img, q in zip(win.blurred, win.counts):
        B, h, w = img.shape
        seen = np.zeros((B, h, w), bool)
        for b in range(B):
            for s in range(first, first + q):
                x0 = min(max(int(win.x0[b, s]), 0), w - 31)
                y0 = min(max(int(win.y0[b, s]), 0), h - 31)
                seen[b, y0:y0 + 31, x0:x0 + 31] = True
        covered += int(seen.sum())
        first += q
    B, N = win.x0.shape
    assert row_bytes == 4 * (B * N * 31 * 31 + covered + 2 * B * N)


def test_nbytes_counts_each_storage_once_and_bound_picks_the_larger():
    a = torch.zeros(10, 4)
    b = torch.zeros(3, dtype=torch.int64)
    assert counts.nbytes(a, {"x": a[2:], "y": [b, (b[:1], a.T)]}) == 160 + 24
    r = counts.bound({"flop": 134e9, "bytes": 3.35e9}, device_ms=4.0)
    assert r["bound"] == "operations" and r["sol_ms"] == pytest.approx(2.0) and r["share_pct"] == pytest.approx(50.0)
    r = counts.bound({"flop": 0, "bytes": 6.7e9}, device_ms=2.0)
    assert r["bound"] == "bytes" and r["share_pct"] == pytest.approx(100.0)


def test_computed_iterations_rounds_up_to_the_done_check():
    its = torch.tensor([3, 5])
    assert counts.computed_iterations(its, 100, 4) == [8, 8]
    assert counts.computed_iterations(torch.tensor([4, 1]), 100, 4) == [4, 4]
    assert counts.computed_iterations(torch.tensor([9, 9]), 10, 4) == [10, 10]


def test_count_events_on_a_recorded_event_list():
    """metrics.count_events: launches and syncs summed over the runtime
    calls' keys (a key may appear more than once), memcpy calls, device
    busy from the CUDA events' own times only, the top kernels."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(key, count, dev=cpu, us=0.0):
        return types.SimpleNamespace(key=key, count=count, device_type=dev, self_device_time_total=us)

    events = [ev("cudaLaunchKernel", 100), ev("cuLaunchKernel", 3), ev("cudaLaunchKernelExC", 2),
              ev("cudaLaunchKernel", 5), ev("cudaStreamSynchronize", 4), ev("cudaDeviceSynchronize", 1),
              ev("cudaMemcpyAsync", 7), ev("aten::add", 50, cpu, 999.0),
              ev("extract_windows_kernel", 1, cuda, 6.5), ev("elementwise_kernel", 104, cuda, 1500.0)]
    out = metrics.count_events(events, wall_ms=12.5, top=1)
    assert out["kernel_launches"] == 110 and out["stream_syncs"] == 5 and out["memcpy_calls"] == 7
    assert out["device_busy_ms"] == pytest.approx(1.5065) and out["profiled_wall_ms"] == 12.5
    assert out["top_kernels"] == [{"name": "elementwise_kernel", "count": 104, "ms": 1.5}]


TOOLS = {"roofline": roofline, "profile_rtt": profile_rtt, "profile_extract": profile_extract,
         "profile_solver": profile_solver, "profile_frame": profile_frame, "profile_device": profile_device,
         "profile_bench": profile_bench, "profile_depth": profile_depth,
         "measure_ba_scaling": measure_ba_scaling, "ab_kf_policy": ab_kf_policy}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_main_raises_without_a_card(monkeypatch, name):
    """No tool falls back to the CPU: with no CUDA card main() raises
    before it renders or computes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_common.bench, "_render_frames", lambda *a: pytest.fail("rendered without a card"))
    with pytest.raises(RuntimeError, match=f"tools.{name} measures the port on a CUDA card"):
        TOOLS[name].main(*([[]] if name == "measure_ba_scaling" else []))
