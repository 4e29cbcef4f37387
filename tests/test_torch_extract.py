"""Parity of the port's extraction path against vslam_tpu on the CPU: the
TPU kernel body (Pallas, interpret mode) against the plain PyTorch window
gather, FAST/ANMS, ORB and the full multi-level extraction. The CUDA
kernel itself runs only on a GPU: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vslam_torch.ops import extract as text, fast as tfast, orb as torb, patches as tpatch, pyramid as tpyr
from vslam_torch.ops import stereo_match as tsm
from vslam_tpu.ops import extract as jext, fast as jfast, orb as jorb, patches as jpatch
from vslam_tpu.ops import stereo_match as jsm
from vslam_tpu.utils import synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box


def _pallas_interpret(img, x0, y0, P, Pw):
    """The TPU kernel body vslam_tpu/ops/patches.py:_kernel, launched with
    the grid spec of patches.py:121-146, in Pallas interpret mode."""
    B, h, w = img.shape
    q = x0.shape[1]
    q_pad = jpatch._round_up(q, jpatch.CHUNK)
    xy = jnp.stack([jnp.asarray(x0), jnp.asarray(y0)], axis=-1).astype(jnp.int32)
    xy = jnp.pad(xy, ((0, 0), (0, q_pad - q), (0, 0))).reshape(B * q_pad, 2)
    per_img = q_pad // jpatch.CHUNK
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(B * per_img,),
        in_specs=[
            pl.BlockSpec(
                (1, h, w), lambda i, xy: (i // per_img, 0, 0), memory_space=pltpu.VMEM
            )
        ],
        out_specs=pl.BlockSpec(
            (jpatch.CHUNK, P, Pw), lambda i, xy: (i, 0, 0), memory_space=pltpu.VMEM
        ),
    )
    out = pl.pallas_call(
        jpatch._kernel(q_pad, P, Pw, h, w),
        out_shape=jax.ShapeDtypeStruct((B * q_pad, P, Pw), jnp.float32),
        grid_spec=grid_spec,
        interpret=True,
    )(xy, jnp.asarray(img))
    return np.asarray(out).reshape(B, q_pad, P, Pw)[:, :q]


def _window_case(seed, B, h, w, q, P, Pw):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, size=(B, h, w)).astype(np.float32)
    x0 = rng.integers(0, w - Pw + 1, size=(B, q)).astype(np.int32)
    y0 = rng.integers(0, h - P + 1, size=(B, q)).astype(np.int32)
    # the extreme corners of the valid range
    x0[:, :4] = [0, w - Pw, 0, w - Pw]
    y0[:, :4] = [0, 0, h - P, h - P]
    return img, x0, y0


WINDOW_CASES = [
    # (B, h, w, q, P, Pw): the 31x31 BRIEF patches; q not a multiple of the
    # TPU kernel's 64-key chunk; a non-square SAD-sized window
    (2, 40, 56, 70, 31, 31),
    (2, 48, 64, 13, 11, 21),
    (1, 31, 33, 5, 31, 31),
]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_tpu_kernel_body_matches_plain_windows_bit_exact(case):
    img, x0, y0 = _window_case(0, *case)
    P, Pw = case[4], case[5]
    ref = tpatch.extract_windows_ref(
        torch.from_numpy(img), torch.from_numpy(x0), torch.from_numpy(y0), P, Pw
    ).numpy()
    np.testing.assert_array_equal(_pallas_interpret(img, x0, y0, P, Pw), ref)
    # and the JAX package's own CPU path (its gather fallback)
    np.testing.assert_array_equal(
        np.asarray(jpatch.extract_windows(jnp.asarray(img), jnp.asarray(x0), jnp.asarray(y0), P, Pw)),
        ref,
    )


def test_window_wrapper_routes_cpu_to_plain_version_only(monkeypatch):
    img, x0, y0 = _window_case(1, 2, 40, 56, 9, 31, 31)
    calls = []
    plain = tpatch.extract_windows_ref
    monkeypatch.setattr(tpatch, "extract_windows_ref", lambda *a: calls.append(1) or plain(*a))
    launches = tpatch.LAUNCHES
    out = tpatch.extract_windows(
        torch.from_numpy(img), torch.from_numpy(x0), torch.from_numpy(y0), 31, 31
    )
    assert out.shape == (2, 9, 31, 31)
    assert tpatch.LAUNCHES == launches and calls == [1]
    # out-of-range corners are clamped into the image, as the kernel does
    x_bad = torch.from_numpy(x0).clone()
    x_bad[0, 0] = 10_000
    got = tpatch.extract_windows_ref(torch.from_numpy(img), x_bad, torch.from_numpy(y0), 31, 31)
    np.testing.assert_array_equal(got[0, 0].numpy(), img[0, y0[0, 0] : y0[0, 0] + 31, 56 - 31 :])
    with pytest.raises(ValueError):
        tpatch.extract_windows(torch.zeros(2, 20, 56), x_bad, torch.from_numpy(y0), 31, 31)
    # a tensor on neither the CPU nor a CUDA device has no path: it raises
    meta = torch.empty((2, 40, 56), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpatch.extract_windows(meta, x_bad.to("meta"), x_bad.to("meta"), 31, 31)


# (h, w, q) per level: unequal shapes, a level with no slots (smaller than a
# window, as a coarse pyramid level can be), q not a multiple of anything
LEVEL_TABLE = [(48, 64, 20), (20, 25, 0), (40, 53, 13), (36, 44, 9), (31, 35, 7)]


def _level_table_case(seed, B=2, P=31, Pw=31):
    rng = np.random.default_rng(seed)
    levels, x0s, y0s = [], [], []
    for h, w, q in LEVEL_TABLE:
        levels.append(rng.uniform(0.0, 255.0, size=(B, h, w)).astype(np.float32))
        x0s.append(rng.integers(0, w - Pw + 1, size=(B, q)).astype(np.int32) if q else np.zeros((B, 0), np.int32))
        y0s.append(rng.integers(0, h - P + 1, size=(B, q)).astype(np.int32) if q else np.zeros((B, 0), np.int32))
    x0, y0 = np.concatenate(x0s, 1), np.concatenate(y0s, 1)
    # out-of-range corners on both sides, in the first and the last level
    x0[0, 0], y0[0, 0] = 10_000, -5
    x0[1, -1], y0[1, -1] = -40, 999
    return levels, [q for _, _, q in LEVEL_TABLE], x0, y0


def test_levels_plain_version_equals_tpu_kernel_body_per_level():
    """The one-launch contract on the CPU: the plain version of
    extract_windows_levels equals the TPU kernel body (Pallas interpret
    mode) run level by level and concatenated in slot order, with the
    corners clipped into each level as the JAX extractor clips them."""
    P = Pw = 31
    levels, counts, x0, y0 = _level_table_case(4)
    want, first = [], 0
    for img, q in zip(levels, counts):
        if q:
            h, w = img.shape[1:]
            xl = np.clip(x0[:, first : first + q], 0, w - Pw)
            yl = np.clip(y0[:, first : first + q], 0, h - P)
            want.append(_pallas_interpret(img, xl, yl, P, Pw))
        first += q
    got = tpatch.extract_windows_levels_ref(
        [torch.from_numpy(a) for a in levels], counts, torch.from_numpy(x0), torch.from_numpy(y0), P, Pw
    )
    assert got.shape == (2, sum(counts), P, Pw)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_levels_wrapper_routes_cpu_to_plain_version_and_checks_its_table(monkeypatch):
    levels, counts, x0, y0 = _level_table_case(5)
    lv = [torch.from_numpy(a) for a in levels]
    tx, ty = torch.from_numpy(x0), torch.from_numpy(y0)
    calls = []
    plain = tpatch.extract_windows_levels_ref
    monkeypatch.setattr(tpatch, "extract_windows_levels_ref", lambda *a: calls.append(1) or plain(*a))
    launches = tpatch.LAUNCHES
    out = tpatch.extract_windows_levels(lv, counts, tx, ty, 31, 31)
    assert tpatch.LAUNCHES == launches and calls == [1]
    np.testing.assert_array_equal(out.numpy(), plain(lv, counts, tx, ty, 31, 31).numpy())
    # the single-level entry is the same function on a one-level table
    np.testing.assert_array_equal(
        tpatch.extract_windows(lv[0], tx[:, :20], ty[:, :20], 31, 31).numpy(), out[:, :20].numpy()
    )
    with pytest.raises(ValueError, match="cover"):
        tpatch.extract_windows_levels(lv, [20, 0, 13, 9, 6], tx, ty, 31, 31)
    with pytest.raises(ValueError, match="larger"):  # a level with slots must hold a window
        tpatch.extract_windows_levels(lv, [20, 1, 13, 9, 6], tx, ty, 31, 31)
    with pytest.raises(ValueError, match="different devices"):
        tpatch.extract_windows_levels(lv, counts, tx.to("meta"), ty.to("meta"), 31, 31)
    meta = [a.to("meta") for a in lv]
    with pytest.raises(ValueError, match="unsupported device"):
        tpatch.extract_windows_levels(meta, counts, tx.to("meta"), ty.to("meta"), 31, 31)
    empty = tpatch.extract_windows_levels(lv[:2], [0, 0], tx[:, :0], ty[:, :0], 31, 31)
    assert empty.shape == (2, 0, 31, 31)


def _extract_batch_per_level(imgs, n_levels, scale, total, edge_margin, fast_hi, fast_lo, cell=35):
    """The extractor's window stage as it was before the one-launch kernel:
    per level, corners clipped into the level and one extract_windows call,
    then the parts concatenated. Returns (angle, packed, desc)."""
    B, H, W = imgs.shape
    shapes = tpyr.level_shapes(H, W, n_levels, scale)
    P, half = torb.PATCH, torb.PATCH // 2
    cur, parts = imgs, []
    for l, quota in enumerate(text.level_quotas(total, n_levels, scale)):
        h, w = shapes[l]
        if l > 0:
            cur = tpyr.resize_bilinear_batch(cur, h, w)
        if quota <= 0:
            continue
        blurred = tpyr.gaussian_blur_batch(cur)
        cell_l = max(8, min(cell, int((h * w / max(quota, 1)) ** 0.5)))
        xy, _, _ = tfast.detect(
            cur, threshold_hi=fast_hi, threshold_lo=fast_lo, cell=min(cell_l, max(h, w)),
            max_keypoints=quota, edge_margin=min(edge_margin, min(h, w) // 4),
        )
        x0 = torch.clamp(xy[:, :, 0] - half, 0, w - P).to(torch.int32)
        y0 = torch.clamp(xy[:, :, 1] - half, 0, h - P).to(torch.int32)
        parts.append(tpatch.extract_windows(blurred, x0, y0, P, P))
    patch_all = torch.cat(parts, dim=1)
    angle = torb.orientation_from_patches(patch_all)
    packed, signed = torb.brief_from_patches(patch_all, angle)
    return angle, packed, signed


def test_extract_batch_one_window_call_matches_per_level_reference(monkeypatch):
    """extract_batch cuts every level's windows in ONE extract_windows_levels
    call, and its outputs are bit for bit those of the per-level window
    stage on a rendered stereo pair (5 levels, some of them small)."""
    imgs = torch.from_numpy(_frames(320, 240, n_points=400))
    kw = dict(n_levels=5, scale=1.2, total=600, edge_margin=19, fast_hi=20.0, fast_lo=7.0)
    calls = []
    fused = tpatch.extract_windows_levels
    monkeypatch.setattr(tpatch, "extract_windows_levels", lambda *a: calls.append(a[1]) or fused(*a))
    keys = text.extract_batch(imgs, **kw)
    assert calls == [[q for q in text.level_quotas(600, 5, 1.2) if q > 0]]
    angle, packed, signed = _extract_batch_per_level(imgs, **kw)
    assert keys.valid.sum() > 400
    np.testing.assert_array_equal(keys.angle.numpy(), angle.numpy())
    np.testing.assert_array_equal(keys.packed.numpy(), packed.numpy())
    np.testing.assert_array_equal(keys.desc.numpy(), signed.numpy())


def _frames(width, height, n_points=300, seed=7, texture="classic"):
    scene = synthetic.make_scene(
        n_frames=2, n_points=n_points, width=width, height=height, fps=10.0, seed=seed,
        texture=texture,
    )
    return np.stack([scene.render(1), scene.render(1, right=True)])


def test_fast_detect_exact():
    """FAST score, NMS and grid ANMS with top-k ties: exact (ints and the
    same float margins)."""
    imgs = _frames(160, 120)
    kw = dict(threshold_hi=20.0, threshold_lo=7.0, cell=17, max_keypoints=150, edge_margin=19)
    t = tfast.detect(torch.from_numpy(imgs), **kw)
    for b in range(2):
        j = jfast.detect(jnp.asarray(imgs[b]), **kw)
        for a_t, a_j in zip(t, j):
            np.testing.assert_array_equal(a_t[b].numpy(), np.asarray(a_j))
    # heavy ties: a constant-margin image keeps JAX's lower-index-first order
    flat = np.zeros((1, 64, 64), np.float32)
    flat[0, 20:44:3, 20:44:3] = 255.0
    t = tfast.detect(torch.from_numpy(flat), cell=8, max_keypoints=40, edge_margin=4)
    j = jfast.detect(jnp.asarray(flat[0]), cell=8, max_keypoints=40, edge_margin=4)
    for a_t, a_j in zip(t, j):
        np.testing.assert_array_equal(a_t[0].numpy(), np.asarray(a_j))


def test_orb_pattern_orientation_and_brief():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())
    rng = np.random.default_rng(3)
    patches = rng.uniform(0, 255, size=(2, 40, 31, 31)).astype(np.float32)
    ang_t = torb.orientation_from_patches(torch.from_numpy(patches))
    ang_j = jorb.orientation_from_patches(jnp.asarray(patches))
    # the moment sums add ~700 terms in another order (~1e-6 of their
    # scale); on noise patches the centroid is short, so the angle moves by
    # up to ~1e-4 rad
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=1e-4, rtol=0)
    # on the same angles the sampled bits are identical (gather vs the
    # TPU's one-hot einsum, and vs the JAX gather oracle)
    ang = np.asarray(ang_j)
    packed_t, signed_t = torb.brief_from_patches(torch.from_numpy(patches), torch.from_numpy(ang))
    for fn in (jorb.brief_from_patches, jorb.brief_from_patches_gather):
        packed_j, signed_j = fn(jnp.asarray(patches), jnp.asarray(ang))
        np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j).astype(np.int64))
        np.testing.assert_array_equal(signed_t.numpy(), np.asarray(signed_j))


def test_level_quotas_and_scales_match():
    for args in [(1024, 8, 1.2), (512, 4, 1.2), (2000, 8, 1.2)]:
        assert text.level_quotas(*args) == jext.level_quotas(*args)
    np.testing.assert_array_equal(text.scale_factors(8, 1.2), jext.scale_factors(8, 1.2))
    octs = np.arange(-1, 10)
    np.testing.assert_array_equal(
        text.inv_sigma2(torch.from_numpy(octs)).numpy(), np.asarray(jext.inv_sigma2(jnp.asarray(octs)))
    )


# rad: the port's angles against a float64 computation of the same moments
# (measured up to 1.6e-5 rad on these three textures; JAX's sit up to
# 2.3e-4 rad away on the natural one, so they are held to the oracle, not
# to JAX)
ANGLE_F64_TOL = 5e-5


def _float64_angles(imgs, keys, n_levels, scale):
    """Per view, the valid keys at least 15 px inside their pyramid level
    (where the image-space orb.orientations reads the same window as the
    kernel) and their angles from orb.orientations on the blurred level
    cast to float64."""
    out = []
    for b in range(imgs.shape[0]):
        levels = [tpyr.gaussian_blur(a) for a in tpyr.build_pyramid(torch.from_numpy(imgs[b]), n_levels, scale)]
        sel = torch.zeros_like(keys.valid[b])
        ang = torch.zeros(sel.shape, dtype=torch.float64)
        for lvl, img in enumerate(levels):
            h, w = img.shape
            xy = (keys.xy[b] / scale**lvl).round().long()
            s = keys.valid[b] & (keys.octave[b] == lvl) & (xy >= torb.PATCH // 2).all(-1)
            s &= (xy[:, 0] < w - torb.PATCH // 2) & (xy[:, 1] < h - torb.PATCH // 2)
            ang[s] = torb.orientations(img.double(), xy[s])
            sel |= s
        out.append((sel.numpy(), ang.numpy()))
    return out


@pytest.mark.parametrize("texture", ["classic", "natural", "repeated"])
def test_extract_batch_matches_jax_on_rendered_frames(texture):
    """The whole multi-level extraction and the stereo match on a rendered
    stereo pair (the tracker test scene: 320x240, 512 features, 4 levels)
    of each of synthetic.make_scene's textures. Keypoints (xy, octave,
    valid, response) and the stereo idx_r are exact. Angles are within
    ANGLE_F64_TOL of a float64 oracle for the keys 15 px inside their level
    (all of them here: the edge margin is 19), and on the classic texture
    within 1e-4 rad of JAX's (see test_orb_pattern_orientation_and_brief);
    a descriptor can differ only where a rotated sample lands within ~1e-3
    px of a rounding boundary, so at least 99% of valid keys carry
    identical descriptors and the rest differ in at most 2 bits."""
    imgs = _frames(320, 240, n_points=400, texture=texture)
    kw = dict(n_levels=4, scale=1.2, total=512, edge_margin=19, fast_hi=20.0, fast_lo=7.0)
    t = text.extract_batch(torch.from_numpy(imgs), **kw)
    j = jext.extract_batch(jnp.asarray(imgs), **kw)
    for name in ("xy", "octave", "valid", "response"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    valid = t.valid.numpy()
    assert valid.sum() > 500
    if texture == "classic":
        np.testing.assert_allclose(t.angle.numpy()[valid], np.asarray(j.angle)[valid], atol=1e-4, rtol=0)
    n_inside = 0
    for b, (sel, ang64) in enumerate(_float64_angles(imgs, t, kw["n_levels"], kw["scale"])):
        err = np.abs(np.angle(np.exp(1j * (t.angle[b].numpy().astype(np.float64) - ang64))))[sel]
        assert err.max() <= ANGLE_F64_TOL, (b, err.max())
        n_inside += int(sel.sum())
    assert n_inside == valid.sum()
    dbits = (t.desc.numpy() != np.asarray(j.desc)).sum(axis=-1)[valid]
    assert (dbits == 0).mean() >= 0.99, np.bincount(dbits)
    assert dbits.max() <= 2, np.bincount(dbits)
    same = dbits == 0
    np.testing.assert_array_equal(
        t.packed.numpy()[valid][same], np.asarray(j.packed).astype(np.int64)[valid][same]
    )
    # the stereo match of each package on its own keys
    sf = jext.scale_factors(kw["n_levels"], kw["scale"])
    fx, bl = np.float32(460.0), np.float32(0.12)  # synthetic.make_scene's rig
    views = [[getattr(t, n)[i] for n in ("xy", "octave", "desc", "valid")] for i in (0, 1)]
    st_t = tsm.match_stereo(torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1]), *views[0], *views[1],
                            torch.tensor(fx), torch.tensor(bl), torch.from_numpy(sf))
    views = [[getattr(j, n)[i] for n in ("xy", "octave", "desc", "valid")] for i in (0, 1)]
    st_j = jsm.match_stereo(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), *views[0], *views[1],
                            jnp.float32(fx), jnp.float32(bl), jnp.asarray(sf))
    assert np.asarray(st_j["matched"]).sum() > 100
    for name in ("idx_r", "matched"):
        np.testing.assert_array_equal(st_t[name].numpy(), np.asarray(st_j[name]), err_msg=name)
