"""Parity of the port's pose graphs (vslam_torch/models/pose_graph.py)
against vslam_tpu/models/pose_graph.py on the CPU: the analytic edge
Jacobians against ``jax.jacfwd``, the block cyclic reduction against
JAX's block-Thomas, and the problems of tests/test_loop_closure.py:18-271
(dense drift recovery, sparse against dense, Sim(3) scale drift, the
2048-pose chain) through both packages with the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_loop_closure import _drifted_chain
from vslam_torch.geometry import sim3 as tsim
from vslam_torch.models import pose_graph as tpg
from vslam_tpu.geometry import se3 as jse3, sim3 as jsim
from vslam_tpu.models import pose_graph as jpg

torch.set_num_threads(2)  # xdist runs several workers on one box


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_edge_jacobians_match_jacfwd(group):
    """Residuals and both Jacobians of 24 weighted edges whose residuals
    reach ~0.25 rad / 0.3 in log-scale (a drifted loop edge), against JAX's
    per-edge jacfwd: within 2e-5 per unit weight (float32 forward-mode
    against the closed form; the Bernoulli series' truncation is ~1e-9
    there)."""
    rng = np.random.default_rng(0)
    d, E, w = (6, 24, 100.0) if group == "se3" else (7, 24, 100.0)
    jexp, jlog, jinv, jret = (
        (jse3.se3_expmap, jse3.se3_logmap, jse3.inverse, jse3.retract) if group == "se3"
        else (jsim.expmap, jsim.logmap, jsim.inverse, jsim.retract)
    )
    xi = rng.normal(0.0, 0.5, size=(E, d)).astype(np.float32)
    Ti = np.array(jexp(jnp.asarray(xi)))
    step = rng.normal(0.0, 0.15, size=(E, d)).astype(np.float32)
    Tj = np.array(jexp(jnp.asarray(xi)) @ jexp(jnp.asarray(step)))
    Z = np.array(jexp(jnp.asarray(step + rng.normal(0.0, 0.12, size=(E, d)).astype(np.float32))))
    ws = np.full(E, w, np.float32)
    g = tpg.SE3 if group == "se3" else tpg.SIM3
    r, Ji, Jj = (a.numpy() for a in tpg._edge_jacobians(g, *_t(Ti, Tj, Z, ws)))

    def per_edge(Ti, Tj, Z):
        z = jnp.zeros(d, jnp.float32)

        def res(di, dj):
            return jlog(jinv(Z) @ jinv(jret(Ti, di)) @ jret(Tj, dj)) * w

        return res(z, z), jax.jacfwd(lambda a: res(a, z))(z), jax.jacfwd(lambda a: res(z, a))(z)

    rj, Jij, Jjj = (np.asarray(a) for a in jax.jit(jax.vmap(per_edge))(*_j(Ti, Tj, Z)))
    assert np.abs(rj[:, :3]).max() > 0.2 * w  # the residuals are not small
    np.testing.assert_allclose(r / w, rj / w, atol=2e-5, rtol=0)
    np.testing.assert_allclose(Ji / w, Jij / w, atol=2e-5, rtol=0)
    np.testing.assert_allclose(Jj / w, Jjj / w, atol=2e-5, rtol=0)


@pytest.mark.parametrize("P, d", [(40, 6), (37, 7), (1, 6)])
def test_block_cyclic_reduction_matches_block_thomas(P, d):
    """The same symmetric block-tridiagonal system (diagonally dominant,
    as a damped chain Hessian is) and 9 right-hand sides through the
    port's cyclic reduction and JAX's block-Thomas: within 2e-6 relative
    to the solution's scale, and residual-free against the dense T."""
    rng = np.random.default_rng(P + d)
    B = rng.normal(0.0, 0.3, size=(P - 1, d, d)).astype(np.float32)
    D = np.stack([4.0 * np.eye(d) + (q := rng.normal(0.0, 0.3, (d, d))) @ q.T for _ in range(P)])
    D = D.astype(np.float32)
    rhs = rng.normal(0.0, 1.0, size=(P, d, 9)).astype(np.float32)
    x = tpg._block_cyclic_reduction(*_t(D, B, rhs)).numpy()
    xj = np.asarray(jpg._block_thomas(*_j(D, B, rhs)))
    scale = np.abs(xj).max()
    np.testing.assert_allclose(x, xj, atol=2e-6 * scale, rtol=0)
    T = np.zeros((P * d, P * d))
    for i in range(P):
        T[i * d : (i + 1) * d, i * d : (i + 1) * d] = D[i]
        if i + 1 < P:
            T[i * d : (i + 1) * d, (i + 1) * d : (i + 2) * d] = B[i]
            T[(i + 1) * d : (i + 2) * d, i * d : (i + 1) * d] = B[i].T
    res = T @ x.reshape(P * d, 9) - rhs.reshape(P * d, 9)
    assert np.abs(res).max() < 1e-4 * max(np.abs(rhs).max(), 1.0)


def _loop_slots(li, lj, lrel, L=4):
    lip, ljp = np.zeros(L, np.int32), np.zeros(L, np.int32)
    lrelp = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    lwp = np.zeros(L, np.float32)
    k = len(li)
    lip[:k], ljp[:k], lrelp[:k], lwp[:k] = li, lj, lrel, 100.0
    return lip, ljp, lrelp, lwp


def test_dense_and_sparse_recover_loop_drift_as_jax():
    """tests/test_loop_closure.py:18-132: a 40-pose chain with biased
    odometry (0.7 m of drift) and one true loop edge. The port's dense and
    chain solvers against JAX's: poses within 2e-5 m / 2e-5 of each other
    (float32 sum order over up to 30 GN steps), the gauge pose untouched,
    errors within 1e-4 relative, and the drift gone as JAX's test asks."""
    n = 40
    gt, est, drift_step, (li, lj, lrel) = _drifted_chain(n)
    chain_rel = np.tile(drift_step, (n - 1, 1, 1)).astype(np.float32)
    w = np.full(n - 1, 100.0, np.float32)
    ei = np.concatenate([np.arange(n - 1), li]).astype(np.int32)
    ej = np.concatenate([np.arange(1, n), lj]).astype(np.int32)
    rel = np.concatenate([chain_rel, lrel]).astype(np.float32)
    ew = np.full(n, 100.0, np.float32)
    valid = np.ones(n, bool)
    dense = (est, valid, ei, ej, rel, ew)
    pd, ed = tpg.optimize(*_t(*dense), iters=30)
    pdj, edj = jpg.optimize(*_j(*dense), iters=30)
    sparse = (est, valid, chain_rel, w, *_loop_slots(li, lj, lrel))
    ps, es = tpg.optimize_chain(*_t(*sparse), iters=30)
    psj, esj = jpg.optimize_chain(*_j(*sparse), iters=30)
    pd, ps, pdj, psj = pd.numpy(), ps.numpy(), np.asarray(pdj), np.asarray(psj)
    for a, b, ea, eb in ((pd, pdj, ed, edj), (ps, psj, es, esj)):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
        assert abs(float(ea) - float(eb)) <= 1e-4 * float(eb)
        np.testing.assert_array_equal(a[0], est[0])
    # the JAX test's requirements on the port's results
    assert np.linalg.norm(pd[-1][:3, 3] - gt[-1][:3, 3]) < 0.01
    assert np.linalg.norm(pd[:, :3, 3] - gt[:, :3, 3], axis=1).max() < 0.05
    assert np.linalg.norm(pd[:, :3, 3] - ps[:, :3, 3], axis=1).max() < 5e-3
    assert abs(float(ed) - float(es)) < 1e-2 * max(float(ed), 1.0)
    assert np.linalg.norm(ps[:, :3, 3] - gt[:, :3, 3], axis=1).max() < 0.05


def test_sim3_chain_recovers_scale_drift_as_jax():
    """tests/test_loop_closure.py:135-221: mono scale drift (each step's
    translation stretched by 1.012^i) and a loop edge with the measured
    relative scale. The port's Sim(3) chain against JAX's: states within
    5e-5, errors within 1e-4 relative; the port's result meets the JAX
    test's requirements, against the port's SE(3) chain."""
    n = 40
    step = np.array(jse3.se3_expmap(jnp.asarray([0.0, 0.02, 0.0, 0.0, 0.0, 0.3], jnp.float32)))
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    q = 1.012
    est = [gt[0]]
    for i in range(1, n):
        stretched = step.copy()
        stretched[:3, 3] *= q ** (i - 1)
        est.append(est[-1] @ stretched)
    est = np.stack(est).astype(np.float32)
    pre = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    chain_rel = np.stack([np.linalg.inv(est[i]) @ est[i + 1] for i in range(n - 1)]).astype(np.float32)
    Z = (np.linalg.inv(gt[0]) @ gt[-1]).astype(np.float32)
    Z[:3, :3] *= float(q ** -(n - 2))
    args = (est, np.ones(n, bool), chain_rel, np.full(n - 1, 100.0, np.float32),
            *_loop_slots([0], [n - 1], Z[None]))
    S, err = tpg.optimize_sim3_chain(*_t(*args), iters=40)
    Sj, errj = jpg.optimize_sim3_chain(*_j(*args), iters=40)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), atol=5e-5, rtol=0)
    assert abs(float(err) - float(errj)) <= 1e-4 * max(float(errj), 1e-3)
    poses = tsim.to_se3(S).numpy()
    errs = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs[-1] < 0.05 * pre and errs.max() < 0.15
    assert tsim.scale_of(S).numpy()[-1] < 0.85
    ps3, _ = tpg.optimize_chain(*_t(*args), iters=40)
    errs_se3 = np.linalg.norm(ps3.numpy()[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs.max() < 0.5 * errs_se3.max(), (errs.max(), errs_se3.max())


def test_chain_2048_matches_block_thomas():
    """tests/test_loop_closure.py:224-271's 2048-pose chain with 3 loop
    edges: the port (block cyclic reduction) against JAX (block-Thomas),
    25 iterations each. The two solves sum in other orders and the 2047
    chained errors compound them: poses within 5e-4 m and 5e-5 in the
    rotation entries, final errors within 1e-3 relative; the port recovers
    > 90% of the drift (JAX's test: post < 0.1 pre) with every pose within
    0.2 m of the truth."""
    n = 2048
    gt, _, _, (li, lj, lrel) = _drifted_chain(n, loops=((0, 680), (0, 1360), (0, -1)))
    small = np.array(jse3.se3_expmap(jnp.asarray([2e-5, 0.0201, 0.0, 2e-4, 1e-4, 0.30004], jnp.float32)))
    est = [gt[0]]
    for _ in range(1, n):
        est.append(est[-1] @ small)
    est = np.stack(est)
    pre = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    args = (est, np.ones(n, bool), np.tile(small, (n - 1, 1, 1)).astype(np.float32),
            np.full(n - 1, 100.0, np.float32), *_loop_slots(li, lj, lrel))
    ps, err = tpg.optimize_chain(*_t(*args), iters=25)
    psj, errj = jpg.optimize_chain(*_j(*args), iters=25)
    ps, psj = ps.numpy(), np.asarray(psj)
    np.testing.assert_allclose(ps[:, :3, 3], psj[:, :3, 3], atol=5e-4, rtol=0)
    np.testing.assert_allclose(ps[:, :3, :3], psj[:, :3, :3], atol=5e-5, rtol=0)
    assert abs(float(err) - float(errj)) <= 1e-3 * float(errj)
    assert np.linalg.norm(ps[-1][:3, 3] - gt[-1][:3, 3]) < 0.1 * pre
    assert np.linalg.norm(ps[:, :3, 3] - gt[:, :3, 3], axis=1).max() < 0.2
