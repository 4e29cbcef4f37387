"""Parity of the port's matching and pose-solving path against vslam_tpu
on the CPU: stereo matching, projection prediction + matching, and the
two-pass motion-only LM, on keys extracted from rendered frames. Both
packages get the same inputs (the JAX package's keys, handed across as
numpy)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_torch.ops import lm as tlm, project_match as tpm, stereo_match as tsm
from vslam_tpu.ops import extract as jext, lm as jlm, project_match as jpm, stereo_match as jsm
from vslam_tpu.utils import synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

N_LEVELS = 4
SCALE = 1.2


@pytest.fixture(scope="module")
def case():
    """Frames 0 and 2 of the tracker test scene (320x240), their keys, the
    frame-0 stereo matches and landmarks spawned from them."""
    scene = synthetic.make_scene(
        n_frames=4, n_points=400, width=320, height=240, fps=10.0, seed=7
    )
    K = scene.K.astype(np.float32)
    out = {"scene": scene, "K": K, "baseline": np.float32(scene.baseline)}
    for f in (0, 2):
        imgs = np.stack([scene.render(f), scene.render(f, right=True)])
        keys = jext.extract_batch(jnp.asarray(imgs), n_levels=N_LEVELS, scale=SCALE, total=512)
        out[f] = (imgs, jax.tree.map(np.asarray, keys))
    sf = jext.scale_factors(N_LEVELS, SCALE)
    out["sf"] = sf
    imgs, keys = out[0]
    st = jsm.match_stereo(
        jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
        *(jnp.asarray(getattr(keys, n)[0]) for n in ("xy", "octave", "desc", "valid")),
        *(jnp.asarray(getattr(keys, n)[1]) for n in ("xy", "octave", "desc", "valid")),
        jnp.float32(K[0, 0]), jnp.float32(scene.baseline), jnp.asarray(sf),
    )
    st = jax.tree.map(np.asarray, st)
    out["st0"] = st
    # landmarks from frame-0 stereo depth (camera 0 = world)
    m = st["matched"]
    xy, z = keys.xy[0][m], st["depth"][m]
    pts = np.stack(
        [(xy[:, 0] - K[0, 2]) / K[0, 0] * z, (xy[:, 1] - K[1, 2]) / K[1, 1] * z, z], -1
    ).astype(np.float32)
    maxd = (np.linalg.norm(pts, axis=-1) * sf[keys.octave[0][m]]).astype(np.float32)
    out["lm"] = {
        "pos": pts,
        "desc": keys.desc[0][m],
        "maxdist": maxd,
        "mindist": (maxd / SCALE ** (N_LEVELS - 1)).astype(np.float32),
        "valid": np.ones(len(pts), bool),
    }
    return out


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def test_match_stereo_matches_jax(case):
    imgs, keys = case[0]
    K, b, sf = case["K"], case["baseline"], case["sf"]
    args = [imgs[0], imgs[1]]
    for i in (0, 1):
        args += [getattr(keys, n)[i] for n in ("xy", "octave", "desc", "valid")]
    st_t = tsm.match_stereo(*_t(*args), *_t(K[0, 0], b, sf))
    st_j = case["st0"]
    assert st_j["matched"].sum() > 100
    for name in ("idx_r", "matched", "close"):
        np.testing.assert_array_equal(st_t[name].numpy(), st_j[name], err_msg=name)
    np.testing.assert_array_equal(st_t["desc_dist"].numpy(), st_j["desc_dist"])
    # the SAD sums add 121 float terms in another order; the parabola and
    # fx*b/d propagate that: 1e-5 px on disparity, 1e-5 relative on depth
    for name in ("disparity", "est_right_x"):
        np.testing.assert_allclose(st_t[name].numpy(), st_j[name], atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(st_t["depth"].numpy(), st_j["depth"], rtol=1e-5, atol=0)


def _pred_pose(case, frame=2, noise=0.01):
    T = case["scene"].poses_c2w[frame].astype(np.float32).copy()
    T[:3, 3] += noise  # a prediction a centimetre off
    return T


def test_predict_and_cull_and_match_by_projection(case):
    K, b, sf, lmk = case["K"], case["baseline"], case["sf"], case["lm"]
    T = _pred_pose(case)
    _, keys = case[2]
    pj = jpm.predict_and_cull(
        jnp.asarray(T), jnp.asarray(lmk["pos"]), jnp.asarray(lmk["valid"]), jnp.asarray(K),
        jnp.float32(b), 320, 240, jnp.asarray(lmk["maxdist"]), jnp.asarray(lmk["mindist"]),
        n_levels=N_LEVELS,
    )
    pt = tpm.predict_and_cull(
        *_t(T, lmk["pos"], lmk["valid"], K), torch.tensor(b), 320, 240,
        *_t(lmk["maxdist"], lmk["mindist"]), n_levels=N_LEVELS,
    )
    for name in ("in_l", "in_r", "pred_oct"):
        np.testing.assert_array_equal(pt[name].numpy(), np.asarray(pj[name]), err_msg=name)
    # projections of ~5 m points: the 3x3 products sum in another order
    np.testing.assert_allclose(pt["pred_l"].numpy(), np.asarray(pj["pred_l"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(pt["pred_r"].numpy(), np.asarray(pj["pred_r"]), atol=1e-4, rtol=0)

    for side in (0, 1):
        pred = np.asarray(pj["pred_l" if side == 0 else "pred_r"])
        mval = lmk["valid"] & np.asarray(pj["in_l" if side == 0 else "in_r"])
        kargs = [getattr(keys, n)[side] for n in ("xy", "octave", "desc", "valid")]
        for radius in (4.0, 10.0, 40.0):
            mj, dj = jpm.match_by_projection(
                jnp.asarray(pred), pj["pred_oct"], jnp.asarray(lmk["desc"]), jnp.asarray(mval),
                *(jnp.asarray(a) for a in kargs), jnp.float32(radius), jnp.asarray(sf),
                jnp.float32(100.0), jnp.float32(0.8),
            )
            mt, dt = tpm.match_by_projection(
                *_t(pred, np.asarray(pj["pred_oct"]), lmk["desc"], mval), *_t(*kargs),
                radius, torch.from_numpy(sf), 100.0, float(np.float32(0.8)),
            )
            np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
            np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
            if radius == 10.0 and side == 0:
                assert (np.asarray(mj) >= 0).sum() > 50


@pytest.fixture(scope="module")
def ba_problem(case):
    """Observations of the landmarks in frame 2 from a projection match,
    with a handful of gross outliers and two right-camera rows."""
    K, b, sf, lmk = case["K"], case["baseline"], case["sf"], case["lm"]
    T = _pred_pose(case)
    _, keys = case[2]
    pj = jpm.predict_and_cull(
        jnp.asarray(T), jnp.asarray(lmk["pos"]), jnp.asarray(lmk["valid"]), jnp.asarray(K),
        jnp.float32(b), 320, 240, jnp.asarray(lmk["maxdist"]), jnp.asarray(lmk["mindist"]),
        n_levels=N_LEVELS,
    )
    midx, _ = jpm.match_by_projection(
        pj["pred_l"], pj["pred_oct"], jnp.asarray(lmk["desc"]), jnp.asarray(lmk["valid"]) & pj["in_l"],
        *(jnp.asarray(getattr(keys, n)[0]) for n in ("xy", "octave", "desc", "valid")),
        jnp.float32(10.0), jnp.asarray(sf), jnp.float32(100.0), jnp.float32(0.8),
    )
    midx = np.asarray(midx)
    matched = midx >= 0
    safe = np.where(matched, midx, 0)
    xy = keys.xy[0][safe]
    rng = np.random.default_rng(5)
    obs = np.stack([xy[:, 0], xy[:, 1], xy[:, 0] - rng.uniform(5, 30, len(xy))], -1)
    bad = np.nonzero(matched)[0][:6]
    obs[bad, :2] += 40.0  # gross outliers
    is_stereo = matched & (rng.random(len(xy)) < 0.5)
    is_right = np.zeros(len(xy), bool)
    is_right[np.nonzero(matched & ~is_stereo)[0][:2]] = True
    obs[is_right, 0] = np.asarray(pj["pred_r"])[is_right, 0]
    oct_ = keys.octave[0][safe]
    w = np.asarray(jext.inv_sigma2(jnp.asarray(oct_), N_LEVELS, SCALE))
    starts = np.stack([T, np.eye(4, dtype=np.float32)]).astype(np.float32)
    starts[1, :3, 3] = T[:3, 3] * 0.8  # a second, worse start
    return dict(
        T0=starts, pts=lmk["pos"], obs=obs.astype(np.float32), w=w, st=is_stereo,
        right=is_right, valid=matched, K=K, b=b,
    )


def test_motion_only_ba_two_starts_match_jax(ba_problem):
    p = ba_problem
    args = [p["pts"], p["obs"], p["w"], p["st"], p["right"], p["valid"], p["K"]]
    T_j, chi2_j, inl_j, st_j, r_j = jax.vmap(
        lambda T0: jlm.motion_only_ba(T0, *(jnp.asarray(a) for a in args), jnp.float32(p["b"]))
    )(jnp.asarray(p["T0"]))
    T_t, chi2_t, inl_t, st_t, r_t = tlm.motion_only_ba(
        *_t(p["T0"], *args), torch.tensor(p["b"])
    )
    # converged poses: 1e-5 (rotation entries and metres)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    assert not inl_t.numpy()[:, np.nonzero(p["valid"])[0][:6]].any()  # outliers gated
    # chi2 of inliers: squared pixel errors of ~0.1 px, 1e-4 absolute
    inl = inl_t.numpy()
    np.testing.assert_allclose(chi2_t.numpy()[inl], np.asarray(chi2_j)[inl], atol=1e-4, rtol=1e-3)
    # the solve stopped at the same LM iteration
    np.testing.assert_array_equal(r_t.iterations.numpy(), np.asarray(r_j.iterations))


def test_lm_residuals_and_chi2_match_jax(ba_problem):
    p = ba_problem
    T = p["T0"]
    args = [p["pts"], p["obs"], np.sqrt(p["w"]), p["st"], p["right"], p["valid"], p["K"]]
    r_j = jax.vmap(
        lambda T0: jlm.stereo_residuals(T0, *(jnp.asarray(a) for a in args), jnp.float32(p["b"]))
    )(jnp.asarray(T))
    r_t = tlm.stereo_residuals(*_t(T, *args), torch.tensor(p["b"]))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-4, rtol=1e-5)
    # the analytic Jacobian equals jax.jacfwd of the residual at xi = 0
    from vslam_tpu.geometry import se3 as jse3

    J_j = jax.jacfwd(
        lambda d: jlm.stereo_residuals(
            jse3.retract(jnp.asarray(T[0]), d), *(jnp.asarray(a) for a in args), jnp.float32(p["b"])
        ).reshape(-1)
    )(jnp.zeros(6, jnp.float32))
    pc = tlm._project(torch.from_numpy(T[:1]), torch.from_numpy(p["pts"]), None, None)
    _, J_t = tlm._residuals(pc, *_t(*args[1:]), torch.tensor(p["b"]), with_jac=True)
    J_j = np.asarray(J_j)
    # float32 rounding of entries up to ~500: 1e-6 of the largest entry
    np.testing.assert_allclose(J_t.numpy().reshape(-1, 6), J_j, atol=1e-6 * np.abs(J_j).max(), rtol=0)
