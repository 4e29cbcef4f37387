"""The port's triangulation and Schur local BA against vslam_tpu on the
CPU: the same numpy inputs go through both packages (JAX on the CPU as the
reference), with the tolerance stated in each test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_torch.geometry import se3 as tse3, triangulate as ttri
from vslam_torch.models import convert
from vslam_torch.ops import schur as tsch
from vslam_tpu.geometry import se3, triangulate as jtri
from vslam_tpu.ops import schur as jsch

torch.set_num_threads(2)  # xdist runs several workers on one box

K = np.array([[460.0, 0, 320.0], [0, 460.0, 240.0], [0, 0, 1.0]], np.float32)
BASELINE = 0.12


def _build_problem(W=6, L=96, noise_pose=0.02, noise_pt=0.05, seed=0):
    """tests/test_ba.py's problem: W poses along a forward path, every
    landmark seen by every pose (stereo on even landmarks), poses 1.. and
    all landmarks perturbed."""
    rng = np.random.default_rng(seed)
    poses_gt = []
    for i in range(W):
        xi = np.array([0.01 * i, 0.02 * i, 0.005 * i, 0.1 * i, 0.01 * i, 0.6 * i], np.float32)
        poses_gt.append(np.asarray(se3.se3_expmap(jnp.asarray(xi))))
    poses_gt = np.stack(poses_gt)
    pts_gt = np.stack(
        [rng.uniform(-6, 6, L), rng.uniform(-4, 4, L), rng.uniform(6, 30, L)], -1
    ).astype(np.float32)
    obs_kf, obs_lm, obs_uv, obs_st = [], [], [], []
    for w in range(W):
        T_cw = np.linalg.inv(poses_gt[w])
        pc = (T_cw[:3, :3] @ pts_gt.T).T + T_cw[:3, 3]
        u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
        v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
        ur = K[0, 0] * (pc[:, 0] - BASELINE) / pc[:, 2] + K[0, 2]
        for l in range(L):
            obs_kf.append(w)
            obs_lm.append(l)
            obs_uv.append([u[l], v[l], ur[l]])
            obs_st.append(l % 2 == 0)
    fixed = np.zeros(W, bool)
    fixed[0] = True
    poses_init = poses_gt.copy()
    for w in range(W):
        if not fixed[w]:
            xi = rng.normal(0, noise_pose, 6).astype(np.float32)
            poses_init[w] = poses_gt[w] @ np.asarray(se3.se3_expmap(jnp.asarray(xi)))
    pts_init = pts_gt + rng.normal(0, noise_pt, pts_gt.shape).astype(np.float32)
    odo_rel = np.stack(
        [np.linalg.inv(poses_gt[i]) @ poses_gt[i + 1] for i in range(W - 1)]
    ).astype(np.float32)
    n = len(obs_kf)
    p = jsch.BAProblem(
        poses=jnp.asarray(poses_init),
        fixed=jnp.asarray(fixed),
        pose_valid=jnp.ones(W, dtype=bool),
        pts=jnp.asarray(pts_init),
        pt_valid=jnp.ones(L, dtype=bool),
        obs_kf=jnp.asarray(np.asarray(obs_kf, np.int32)),
        obs_lm=jnp.asarray(np.asarray(obs_lm, np.int32)),
        obs_uv=jnp.asarray(np.asarray(obs_uv, np.float32)),
        obs_stereo=jnp.asarray(np.asarray(obs_st)),
        obs_right=jnp.zeros(n, dtype=bool),
        obs_w=jnp.ones(n, jnp.float32),
        obs_valid=jnp.ones(n, dtype=bool),
        K=jnp.asarray(K),
        baseline=jnp.float32(BASELINE),
        odo_rel=jnp.asarray(odo_rel),
        odo_valid=jnp.ones(W - 1, dtype=bool),
    )
    return p, poses_gt, pts_gt


def _with_outliers(p, seed=1, n_bad=30):
    """Inject n_bad 15-40 px outliers on rows of STEREO-observed landmarks
    (even ids). A mono landmark with a 40 px outlier in one of six views is
    ill-conditioned: its depth runs off (to ~1e4 m in JAX), and f32 sum
    order alone then moves it by metres, in either package."""
    uv = np.array(p.obs_uv)
    rng = np.random.default_rng(seed)
    rows = np.nonzero(np.asarray(p.obs_lm) % 2 == 0)[0]
    bad = rng.choice(rows, n_bad, replace=False)
    uv[bad, :2] += rng.uniform(15, 40, (n_bad, 2))
    return p._replace(obs_uv=jnp.asarray(uv)), bad


def _port(p) -> tsch.BAProblem:
    return convert.ba_problem_from_jax({k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_ba_problem_from_jax_keeps_every_field():
    p, _, _ = _build_problem(W=3, L=8)
    tp = _port(p)
    assert tp._fields == p._fields
    assert tp.obs_kf.dtype == torch.int64 and tp.obs_valid.dtype == torch.bool
    for name in p._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(p, name)), err_msg=name)
    with pytest.raises(KeyError, match="odo_rel"):
        convert.ba_problem_from_jax({k: np.asarray(v) for k, v in p._asdict().items() if k != "odo_rel"}, "cpu")


def _views(seed=0, V=5, C=64):
    """Seeded multi-view triangulation inputs: V poses along a path, C
    points in front, 0.3 px pixel noise, a random view mask (some
    candidates see < 3 views), and a few gross outliers."""
    rng = np.random.default_rng(seed)
    poses = np.stack([
        np.asarray(se3.se3_expmap(jnp.asarray(
            np.array([0.01 * i, -0.02 * i, 0.0, 0.25 * i, 0.02 * i, 0.3 * i], np.float32)
        )))
        for i in range(V)
    ])
    pts = np.stack(
        [rng.uniform(-4, 4, C), rng.uniform(-3, 3, C), rng.uniform(4, 20, C)], -1
    ).astype(np.float32)
    uv = np.zeros((C, V, 2), np.float32)
    for v in range(V):
        T_cw = np.linalg.inv(poses[v])
        pc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv[:, v, 0] = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
        uv[:, v, 1] = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    mask = rng.uniform(size=(C, V)) < 0.7
    bad = rng.choice(C, 6, replace=False)
    uv[bad, 0, :] += 25.0
    inv_s2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], size=(C, V)).astype(np.float32)
    return poses.astype(np.float32), pts, uv, mask, inv_s2


def test_triangulation_matches_jax():
    """projection_matrices, DLT, the Gauss-Newton polish and the chi2
    validation on seeded views: ok masks identical, every candidate seen
    by >= 3 views (the mapper's minimum) within 1e-4 m."""
    poses, _, uv, mask, inv_s2 = _views()
    Pj = jtri.projection_matrices(jnp.asarray(poses), jnp.asarray(K),
                                  baseline_shift=jnp.full((len(poses),), BASELINE * 0.5))
    Pt = ttri.projection_matrices(torch.from_numpy(poses), torch.from_numpy(K),
                                  baseline_shift=torch.full((len(poses),), BASELINE * 0.5))
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-6, atol=1e-4)
    Pj = jtri.projection_matrices(jnp.asarray(poses), jnp.asarray(K))
    Pt = ttri.projection_matrices(torch.from_numpy(poses), torch.from_numpy(K))
    uj, mj = jnp.asarray(uv), jnp.asarray(mask)
    ut, mt = torch.from_numpy(uv), torch.from_numpy(mask)
    xj = jtri.refine_triangulation(jtri.triangulate_dlt(Pj, uj, mj), Pj, uj, mj)
    xt = ttri.refine_triangulation(ttri.triangulate_dlt(Pt, ut, mt), Pt, ut, mt)
    okj, c2j = jtri.validate_triangulation(xj, Pj, uj, mj, jnp.asarray(inv_s2))
    okt, c2t = ttri.validate_triangulation(xt, Pt, ut, mt, torch.from_numpy(inv_s2))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 10 < int(okt.sum()) < len(okt)  # both outcomes occur
    seen = mask.sum(1) >= 3
    np.testing.assert_allclose(xt.numpy()[seen], np.asarray(xj)[seen], rtol=0, atol=1e-4)
    np.testing.assert_allclose(c2t.numpy()[mask], np.asarray(c2j)[mask], rtol=1e-3, atol=1e-3)


def test_inv3_and_assembled_blocks_match_jax():
    """_inv3 on damped SPD blocks and every assembled block (Hpp, Hll,
    Hpl, gp, gl) within 1e-5 relative to the block's largest entry."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    assert _rel(tsch._inv3(torch.from_numpy(A)).numpy(), jsch._inv3(jnp.asarray(A))) < 1e-5
    p, _ = _with_outliers(_build_problem(seed=3)[0])
    tp = _port(p)
    blocks_t, blocks_j = tsch._assemble(tp), jax.jit(jsch._assemble)(p)
    for name, a, b in zip(("Hpp", "Hll", "Hpl", "gp", "gl"), blocks_t, blocks_j):
        assert _rel(a.numpy(), b) < 1e-5, name
    inv_t, obs_t = tsch._damped_inv3(blocks_t[1], torch.tensor(1e-4))
    inv_j, obs_j = jsch._damped_inv3(blocks_j[1], jnp.float32(1e-4))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    assert _rel(inv_t.numpy(), inv_j) < 1e-4


def test_obs_chi2_and_error_match_jax():
    """obs_chi2 within 1e-4 relative, the behind-camera rows at 1e12 in
    both, and ba_error within 1e-5 relative."""
    p, _ = _with_outliers(_build_problem(seed=3)[0])
    pts = np.array(p.pts)
    pts[5] = [0.0, 0.0, -3.0]  # behind every camera
    p = p._replace(pts=jnp.asarray(pts))
    tp = _port(p)
    cj, ct = np.asarray(jsch.obs_chi2(p)), tsch.obs_chi2(tp).numpy()
    behind = np.asarray(p.obs_lm) == 5
    assert (cj[behind] == 1e12).all() and (ct[behind] == 1e12).all()
    np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=1e-6)
    ej = float(jax.jit(jsch.ba_error)(p))
    assert abs(float(tsch.ba_error(tp)) - ej) <= 1e-5 * ej


def test_jacobians_match_jacfwd():
    """The analytic observation Jacobians (3x6 pose, 3x3 point) and the
    forward-mode odometry Jacobians against jax.jacfwd, within 1e-5
    relative to the largest entry, including rows whose residual is
    clipped at +-512 px and rows behind the 0.05 m depth clamp (zero
    derivative in both)."""
    p, _ = _with_outliers(_build_problem(seed=2)[0])
    uv = np.array(p.obs_uv)
    uv[3, 0] += 900.0  # clipped residual row
    pts = np.array(p.pts)
    pts[7] = [0.2, 0.1, 0.01]  # in front of pose 0's plane but closer than 0.05 m
    p = p._replace(obs_uv=jnp.asarray(uv), pts=jnp.asarray(pts))
    tp = _port(p)
    rj, Jpj, Jlj = jax.jit(jsch._obs_residual_and_jacobians)(p)
    rt, Jpt, Jlt = tsch._obs_residual_and_jacobians(tp)
    assert _rel(rt.numpy(), rj) < 1e-5
    assert _rel(Jpt.numpy(), Jpj) < 1e-5 and _rel(Jlt.numpy(), Jlj) < 1e-5
    assert np.abs(np.asarray(Jpj)[3, 0]).max() == 0 and np.abs(Jpt.numpy()[3, 0]).max() == 0
    clamp_row = int(np.nonzero((np.asarray(p.obs_lm) == 7) & (np.asarray(p.obs_kf) == 0))[0][0])
    np.testing.assert_allclose(Jpt.numpy()[clamp_row], np.asarray(Jpj)[clamp_row], rtol=0, atol=1e-3)
    roj, Jij, Jjj = jax.jit(jsch._odometry_residual_and_jacobians)(p)
    rot, Jit, Jjt = tsch._odometry_residual_and_jacobians(tp)
    assert _rel(rot.numpy(), roj) < 1e-5
    assert _rel(Jit.numpy(), Jij) < 1e-5 and _rel(Jjt.numpy(), Jjj) < 1e-5


@pytest.mark.parametrize("rounds", [1, 2])
def test_local_ba_matches_jax(rounds):
    """local_ba (5 iterations) and local_ba_two_rounds with injected
    outliers: poses within 1e-5, each landmark within 1e-4 of its range
    (|dp| <= 1e-4 |p|: the converged depth of a 30 m point moves by a few
    1e-4 m with the f32 sum order), the round-1 chi2 sweep and the kill
    mask identical, errors within 1e-3 relative."""
    p, _ = _with_outliers(_build_problem(seed=3)[0])
    tp = _port(p)
    if rounds == 1:
        pj, ej, _ = jsch.local_ba(p, iters=5)
        iters = []
        pt, et, _ = tsch.local_ba(tp, iters=5, stats=iters)
        kj, kt = np.zeros(1, bool), np.zeros(1, bool)
        assert iters == [5]
    else:
        pj, ej, kj = jsch.local_ba_two_rounds(p)
        pt, et, kt = tsch.local_ba_two_rounds(tp)
        kj, kt = np.asarray(kj), kt.numpy()
        swept = ~np.asarray(pj.obs_valid)
        np.testing.assert_array_equal(~pt.obs_valid.numpy(), swept)
        assert swept.sum() >= 30  # the injected outliers and their neighbours
    np.testing.assert_allclose(pt.poses.numpy(), np.asarray(pj.poses), rtol=0, atol=1e-5)
    ptsj = np.asarray(pj.pts)
    dist = np.linalg.norm(pt.pts.numpy() - ptsj, axis=1)
    assert (dist <= 1e-4 * np.linalg.norm(ptsj, axis=1)).all(), dist.max()
    np.testing.assert_array_equal(kt, kj)
    assert abs(float(et) - float(ej)) <= 1e-3 * max(float(ej), 1e-3)
    # the gauge pose is bitwise untouched
    np.testing.assert_array_equal(pt.poses.numpy()[0], np.asarray(p.poses)[0])


def test_non_pd_system_rejects_the_step():
    """A reduced system that is not positive definite gives a NaN step in
    both packages (JAX's cho_factor fills NaN; the port's cholesky_ex
    reports info != 0): LM rejects it instead of raising, and the state
    is untouched."""
    p, _, _ = _build_problem(W=4, L=32, seed=1)
    tp = _port(p)
    W = 4
    Hpp = -np.tile(np.eye(6, dtype=np.float32), (W, W, 1, 1))
    zj = jsch._solve_reduced(p, jnp.asarray(Hpp), jnp.zeros((W, 6)), jnp.zeros((6 * W, 6 * W)),
                             jnp.zeros((W, 6)), jnp.float32(1e-4))
    zt = tsch._solve_reduced(tp, torch.from_numpy(Hpp), torch.zeros(W, 6), torch.zeros(6 * W, 6 * W),
                             torch.zeros(W, 6), torch.tensor(1e-4))
    assert np.isnan(np.asarray(zj)).all() and torch.isnan(zt).all()
    # a negative damping makes the damped system indefinite
    pj, ej, lj = jsch.local_ba(p, iters=1, lambda0=-1e3)
    pt, et, lt = tsch.local_ba(tp, iters=1, lambda0=-1e3)
    np.testing.assert_array_equal(np.asarray(pj.poses), np.asarray(p.poses))
    np.testing.assert_array_equal(pt.poses.numpy(), np.asarray(p.poses))
    np.testing.assert_array_equal(pt.pts.numpy(), np.asarray(p.pts))
    assert float(et) == pytest.approx(float(ej), rel=1e-5)  # the initial error, kept
    assert float(lt) == float(lj) == pytest.approx(1e-9)
