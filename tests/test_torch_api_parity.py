"""The last public functions of vslam_tpu that the port gained, each against
its JAX namesake on the CPU on the same numpy inputs: single-image
extraction (the extraction holds the port's one kernel, extract_windows;
on the CPU its plain version), the image-space ORB and its gather oracle,
the single-image pyramid forms, the parallax gate, the split BA rounds,
and the profiler trace of utils/metrics."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_ba import _build_problem, _port, _with_outliers
from tests.test_torch_extract import _frames
from vslam_torch.geometry import se3 as tse3
from vslam_torch.ops import extract as text, orb as torb, patches as tpatch, pyramid as tpyr, schur as tsch
from vslam_torch.parallel import mesh as tmesh
from vslam_torch.utils import metrics as tmetrics
from vslam_tpu.geometry import se3 as jse3
from vslam_tpu.ops import extract as jext, orb as jorb, pyramid as jpyr, schur as jsch

torch.set_num_threads(2)  # xdist runs several workers on one box

KW = dict(n_levels=4, scale=1.2, total=512, edge_margin=19, fast_hi=20.0, fast_lo=7.0)
ANGLE_TOL = 1e-4  # rad: the moment sums run in another order (test_torch_extract.py)


def _desc_rule(t_desc: np.ndarray, j_desc: np.ndarray):
    """tests/test_torch_extract.py's rule for descriptors whose angles
    agree only to ANGLE_TOL: >= 99% identical, the rest at most 2 bits off."""
    dbits = (t_desc != j_desc).sum(axis=-1)
    assert (dbits == 0).mean() >= 0.99, np.bincount(dbits)
    assert dbits.max() <= 2, np.bincount(dbits)
    return dbits == 0


def _wrapped(a, b) -> np.ndarray:
    """|a - b| on the circle (an angle near +-pi may land on either side)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs((d + np.pi) % (2 * np.pi) - np.pi)


def _border_keys(h, w, n, seed):
    """n integer keys over the whole image, the four corners and a key
    within 15 px of each border among them."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], -1).astype(np.int32)
    xy[:8] = [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [3, h // 2], [w - 5, h // 2],
              [w // 2, 14], [w // 2, h - 2]]
    return xy


def test_extract_matches_jax_and_is_extract_batch_row_0():
    """extract on one rendered 320x240 image: every field torch.equal to
    row 0 of extract_batch(img[None]). Against jext.extract, the keypoints
    (xy, octave, valid) are exact, angles within ANGLE_TOL and the
    descriptors meet the rule. The responses equal those of JAX's own
    unfused extract_batch(img[None]) exactly; jext.extract is one jitted
    program, whose fused FAST scores round differently from JAX's unfused
    ones on 13 of these 512 keys (by up to 5.6e-6 relative), so against it
    the responses are held within 1e-5 relative, and only where JAX's two
    forms part."""
    img = _frames(320, 240, n_points=400)[0]
    t = text.extract(torch.from_numpy(img), **KW)
    row0 = text.extract_batch(torch.from_numpy(img)[None], **KW).select(0)
    for name, a, b in zip(text.Keys._fields, t, row0):
        assert torch.equal(a, b), name
    j = jext.extract(jnp.asarray(img), **KW)
    unfused = np.asarray(jext.extract_batch(jnp.asarray(img)[None], **KW).response[0])
    for name in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    resp, resp_j = t.response.numpy(), np.asarray(j.response)
    np.testing.assert_array_equal(resp, unfused)
    np.testing.assert_array_equal(resp != resp_j, unfused != resp_j)
    np.testing.assert_allclose(resp, resp_j, rtol=1e-5, atol=0)
    valid = t.valid.numpy()
    assert valid.sum() > 250
    np.testing.assert_allclose(t.angle.numpy()[valid], np.asarray(j.angle)[valid], atol=ANGLE_TOL, rtol=0)
    same = _desc_rule(t.desc.numpy()[valid], np.asarray(j.desc)[valid])
    np.testing.assert_array_equal(t.packed.numpy()[valid][same],
                                  np.asarray(j.packed).astype(np.int64)[valid][same])


def test_gather_patches_matches_jax_up_to_every_border():
    """Every pixel clamped into the image, keys within 15 px of each border
    included: exact against JAX (tolerance 0)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0.0, 255.0, (40, 56)).astype(np.float32)
    xy = _border_keys(40, 56, 64, seed=1)
    for size in (31, 7):
        t = torb.gather_patches(torch.from_numpy(img), torch.from_numpy(xy), size)
        j = jorb.gather_patches(jnp.asarray(img), jnp.asarray(xy), size)
        assert t.shape == (64, size, size)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_gather_patches_differs_from_the_window_kernel_at_the_border():
    """On record, as intended: gather_patches clamps each pixel, the
    extractor's window kernel (its plain version here) clamps the top-left
    corner. They agree exactly for keys at least 15 px inside the image and
    differ for every key nearer a border (on a noise image)."""
    rng = np.random.default_rng(2)
    h, w = 64, 80
    img = rng.uniform(0.0, 255.0, (h, w)).astype(np.float32)
    xy = _border_keys(h, w, 96, seed=3)
    g = torb.gather_patches(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    corner = torch.from_numpy(xy - 15)[None]  # the corner extract_batch passes, before its clip
    k = tpatch.extract_windows_ref(torch.from_numpy(img)[None], corner[..., 0], corner[..., 1], 31, 31)[0].numpy()
    inside = ((xy >= 15) & (xy <= [w - 16, h - 16])).all(axis=1)
    assert 0 < inside.sum() < len(xy)
    np.testing.assert_array_equal(g[inside], k[inside])
    assert all(not np.array_equal(g[i], k[i]) for i in np.flatnonzero(~inside))


def test_orientations_match_jax():
    """The intensity-centroid angle at keys over a blurred noise image,
    border keys included: within ANGLE_TOL of JAX. (Not a rendered frame:
    its right border is flat, and the angle of a flat patch is the atan2 of
    two rounding residuals in either package.)"""
    rng = np.random.default_rng(4)
    img = np.asarray(jpyr.gaussian_blur(jnp.asarray(rng.uniform(0.0, 255.0, (120, 160)), jnp.float32)))
    xy = _border_keys(120, 160, 200, seed=4)
    t = torb.orientations(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    j = np.asarray(jorb.orientations(jnp.asarray(img), jnp.asarray(xy)))
    assert _wrapped(t, j).max() <= ANGLE_TOL, _wrapped(t, j).max()


def test_brief_descriptors_match_jax():
    """Rotated BRIEF straight from the image, each sample clamped, at the
    same keys and angles: the descriptor rule against JAX, the packed words
    equal where the bits are (the port's int64 words hold JAX's uint32)."""
    img = np.asarray(jpyr.gaussian_blur(jnp.asarray(_frames(160, 120)[0])))
    xy = _border_keys(120, 160, 300, seed=5)
    angle = np.random.default_rng(6).uniform(-np.pi, np.pi, 300).astype(np.float32)
    pt, st = torb.brief_descriptors(torch.from_numpy(img), torch.from_numpy(xy), torch.from_numpy(angle))
    pj, sj = jorb.brief_descriptors(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(angle))
    assert pt.shape == (300, 8) and st.shape == (300, 256) and st.dtype == torch.int8
    same = _desc_rule(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(pt.numpy()[same], np.asarray(pj).astype(np.int64)[same])


def test_brief_descriptors_equal_brief_from_patches_inside_the_image():
    """For keys at least 15 px inside the image the image-space BRIEF reads
    the pixels the patch form reads: the same bits."""
    img = np.asarray(jpyr.gaussian_blur(jnp.asarray(_frames(160, 120)[0])))
    rng = np.random.default_rng(7)
    xy = np.stack([rng.integers(15, 145, 200), rng.integers(15, 105, 200)], -1)
    angle = torch.from_numpy(rng.uniform(-np.pi, np.pi, 200).astype(np.float32))
    timg, txy = torch.from_numpy(img), torch.from_numpy(xy)
    direct = torb.brief_descriptors(timg, txy, angle)
    patched = torb.brief_from_patches(torb.gather_patches(timg, txy), angle)
    for a, b in zip(direct, patched):
        assert torch.equal(a, b)


def test_brief_from_patches_gather_is_the_oracle():
    """The gather oracle on (2, N) patches: torch.equal to the port's
    brief_from_patches; against JAX's brief_from_patches_gather the
    descriptor rule (cos and sin may round differently by an ulp)."""
    rng = np.random.default_rng(8)
    patches = rng.uniform(0.0, 255.0, (2, 150, 31, 31)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, (2, 150)).astype(np.float32)
    tp, ta = torch.from_numpy(patches), torch.from_numpy(angle)
    oracle = torb.brief_from_patches_gather(tp, ta)
    for a, b in zip(oracle, torb.brief_from_patches(tp, ta)):
        assert torch.equal(a, b)
    pj, sj = jorb.brief_from_patches_gather(jnp.asarray(patches), jnp.asarray(angle))
    same = _desc_rule(oracle[1].numpy().reshape(300, 256), np.asarray(sj).reshape(300, 256))
    np.testing.assert_array_equal(oracle[0].numpy().reshape(300, 8)[same],
                                  np.asarray(pj).astype(np.int64).reshape(300, 8)[same])


def test_single_image_pyramid_forms_bit_exact():
    """build_pyramid, gaussian_blur and resize_bilinear on one image:
    elementwise programs in the same order, so exact (tolerance 0), as the
    batched forms are (tests/test_torch_geometry_ops.py)."""
    img = _frames(160, 120)[1]
    tl = tpyr.build_pyramid(torch.from_numpy(img), 5, 1.2)
    jl = jpyr.build_pyramid(jnp.asarray(img), 5, 1.2)
    assert [tuple(a.shape) for a in tl] == [tuple(b.shape) for b in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tpyr.gaussian_blur(a).numpy(), np.asarray(jpyr.gaussian_blur(b)))
        np.testing.assert_array_equal(tpyr.gaussian_blur(a, 5, 1.5).numpy(),
                                      np.asarray(jpyr.gaussian_blur(b, 5, 1.5)))
    for h, w in [(77, 101), (200, 300), (120, 160)]:  # down, up and identity
        np.testing.assert_array_equal(tpyr.resize_bilinear(torch.from_numpy(img), h, w).numpy(),
                                      np.asarray(jpyr.resize_bilinear(jnp.asarray(img), h, w)))


def _pose_pairs(n=64, seed=9):
    """Pose pairs (n, 4, 4) x 2 whose optical axes are 1-40 deg apart and
    whose centres are 0-0.3 m apart."""
    rng = np.random.default_rng(seed)
    # a rotation tilts the optical axis by at most its angle; an axis near
    # the image plane keeps the tilt near the angle
    axis = rng.normal(size=(n, 3)) * [1.0, 1.0, 0.2]
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.deg2rad(rng.uniform(1.5, 40.0, n))
    xi_a = np.concatenate([rng.normal(0, 0.5, (n, 3)), rng.normal(0, 2.0, (n, 3))], 1)
    xi_d = np.concatenate([axis * ang[:, None], rng.normal(0, 0.1, (n, 3))], 1)
    Ta = np.asarray(jse3.se3_expmap(jnp.asarray(xi_a, jnp.float32)))
    Tb = Ta @ np.asarray(jse3.se3_expmap(jnp.asarray(xi_d, jnp.float32)))
    return Ta.astype(np.float32), Tb.astype(np.float32)


def test_parallax_angle_and_sufficient_movement_match_jax():
    """parallax_angle_deg within 1e-3 deg on pairs >= 1 deg apart (the
    arccos is ill-conditioned near 0); sufficient_movement exact on the
    pairs away from both thresholds (|baseline - 0.1| > 0.01 m and |angle -
    5| > 0.1 deg), on (n,) and (2, n/2) batches."""
    Ta, Tb = _pose_pairs()
    jt = np.asarray(jse3.parallax_angle_deg(jnp.asarray(Ta), jnp.asarray(Tb)))
    assert jt.min() >= 1.0
    for shape in [(64,), (2, 32)]:
        a = torch.from_numpy(Ta.reshape(*shape, 4, 4))
        b = torch.from_numpy(Tb.reshape(*shape, 4, 4))
        tt = tse3.parallax_angle_deg(a, b).reshape(-1).numpy()
        np.testing.assert_allclose(tt, jt, atol=1e-3, rtol=0)
        base = np.linalg.norm(Ta[:, :3, 3] - Tb[:, :3, 3], axis=1)
        away = (np.abs(base - 0.1) > 0.01) & (np.abs(jt - 5.0) > 0.1)
        tm = tse3.sufficient_movement(a, b).reshape(-1).numpy()
        jm = np.asarray(jse3.sufficient_movement(jnp.asarray(Ta), jnp.asarray(Tb)))
        assert away.sum() > 50 and tm.dtype == bool
        np.testing.assert_array_equal(tm[away], jm[away])
        # a higher bar on both thresholds flips some pairs, in both packages
        tm2 = tse3.sufficient_movement(a, b, 0.25, 20.0).reshape(-1).numpy()
        jm2 = np.asarray(jse3.sufficient_movement(jnp.asarray(Ta), jnp.asarray(Tb), 0.25, 20.0))
        away2 = (np.abs(base - 0.25) > 0.01) & (np.abs(jt - 20.0) > 0.1)
        np.testing.assert_array_equal(tm2[away2], jm2[away2])
        assert 0 < tm2.sum() < tm.sum()
    # the same pose twice: no parallax, no movement
    T = torch.from_numpy(Ta[:4])
    assert (tse3.parallax_angle_deg(T, T) < 0.05).all() and not tse3.sufficient_movement(T, T).any()


def _solved_fields(out) -> list:
    p, err, kill = out
    return [p.poses, p.pts, p.obs_valid, err, kill]


@pytest.mark.parametrize("mode", ["plain", "slabs", "mesh"])
def test_local_ba_rounds_chain_to_two_rounds(mode):
    """local_ba_round1 then local_ba_round2 is local_ba_two_rounds on the
    same device: every output torch.equal and the same LM iteration counts,
    unslabbed, over 2 landmark slabs and over a mesh of 2 virtual shards."""
    p, _ = _with_outliers(_build_problem(seed=3)[0])
    tp = _port(p)
    kw = {"plain": {}, "slabs": {"n_slabs": 2}, "mesh": {"mesh": tmesh.make_mesh(2, device="cpu")}}[mode]
    s_split, s_fused = [], []
    p1 = tsch.local_ba_round1(tp, 5, stats=s_split, **kw)
    assert int((~p1.obs_valid).sum()) >= 30  # the sweep took the outliers out
    split = tsch.local_ba_round2(p1, 10, stats=s_split, **kw)
    fused = tsch.local_ba_two_rounds(tp, 5, 10, stats=s_fused, **kw)
    assert s_split == s_fused and len(s_split) == 2
    for a, b in zip(_solved_fields(split), _solved_fields(fused)):
        assert torch.equal(a, b)


def test_local_ba_rounds_match_jax():
    """The split rounds against JAX's local_ba_round1 / local_ba_round2 on
    test_torch_ba.py::test_local_ba_matches_jax's problem and tolerances:
    the round-1 sweep identical, poses within 1e-5, landmarks within 1e-4
    of their range, the kill mask identical, errors within 1e-3 relative."""
    p, _ = _with_outliers(_build_problem(seed=3)[0])
    j1 = jsch.local_ba_round1(p)
    t1 = tsch.local_ba_round1(_port(p))
    np.testing.assert_array_equal(t1.obs_valid.numpy(), np.asarray(j1.obs_valid))
    np.testing.assert_allclose(t1.poses.numpy(), np.asarray(j1.poses), rtol=0, atol=1e-5)
    pj, ej, kj = jsch.local_ba_round2(j1)
    pt, et, kt = tsch.local_ba_round2(t1)
    np.testing.assert_allclose(pt.poses.numpy(), np.asarray(pj.poses), rtol=0, atol=1e-5)
    ptsj = np.asarray(pj.pts)
    dist = np.linalg.norm(pt.pts.numpy() - ptsj, axis=1)
    assert (dist <= 1e-4 * np.linalg.norm(ptsj, axis=1)).all(), dist.max()
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert abs(float(et) - float(ej)) <= 1e-3 * max(float(ej), 1e-3)


def test_trace_writes_a_readable_trace_and_changes_nothing(tmp_path):
    """trace() on the CPU: a Chrome-trace JSON under log_dir that names the
    ops of the traced call, and the traced result equal to the untraced."""
    img = torch.from_numpy(_frames(160, 120)[0])
    with tmetrics.trace(str(tmp_path / "run")) as path:
        traced = tpyr.gaussian_blur(img)
    assert path.startswith(str(tmp_path / "run"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::reflection_pad2d" in names, sorted(n for n in names if n)[:40]
    assert torch.equal(traced, tpyr.gaussian_blur(img))
