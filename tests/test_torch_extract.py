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

from vslam_torch.ops import extract as text, fast as tfast, orb as torb, patches as tpatch
from vslam_tpu.ops import extract as jext, fast as jfast, orb as jorb, patches as jpatch
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


def _frames(width, height, n_points=300, seed=7):
    scene = synthetic.make_scene(
        n_frames=2, n_points=n_points, width=width, height=height, fps=10.0, seed=seed
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


def test_extract_batch_matches_jax_on_rendered_frames():
    """The whole multi-level extraction on a rendered stereo pair (the
    tracker test scene: 320x240, 512 features, 4 levels). Keypoints
    (xy, octave, valid, response) are exact. Angles agree to 1e-4 rad (see
    test_orb_pattern_orientation_and_brief); a descriptor can differ only
    where a rotated sample lands within ~1e-3 px of a rounding boundary,
    so at least 99% of valid keys carry identical descriptors and the rest
    differ in at most 2 bits."""
    imgs = _frames(320, 240, n_points=400)
    kw = dict(n_levels=4, scale=1.2, total=512, edge_margin=19, fast_hi=20.0, fast_lo=7.0)
    t = text.extract_batch(torch.from_numpy(imgs), **kw)
    j = jext.extract_batch(jnp.asarray(imgs), **kw)
    for name in ("xy", "octave", "valid", "response"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    valid = t.valid.numpy()
    assert valid.sum() > 500
    np.testing.assert_allclose(t.angle.numpy()[valid], np.asarray(j.angle)[valid], atol=1e-4, rtol=0)
    dbits = (t.desc.numpy() != np.asarray(j.desc)).sum(axis=-1)[valid]
    assert (dbits == 0).mean() >= 0.99, np.bincount(dbits)
    assert dbits.max() <= 2, np.bincount(dbits)
    same = dbits == 0
    np.testing.assert_array_equal(
        t.packed.numpy()[valid][same], np.asarray(j.packed).astype(np.int64)[valid][same]
    )
