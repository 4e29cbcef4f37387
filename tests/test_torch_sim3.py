"""Parity of the port's Sim(3) (vslam_torch/geometry/sim3.py) against
vslam_tpu/geometry/sim3.py on the CPU: the same seeded numpy inputs to
both, round trips, and _calc_W in and just above its small-angle and
small-sigma branches; the adjoint and bracket matrices the pose graph's
analytic Jacobians use, against their defining identities in float64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vslam_torch.geometry import sim3 as tsim
from vslam_tpu.geometry import sim3 as jsim

torch.set_num_threads(2)  # xdist runs several workers on one box

# float32: the same formulas, another library's sin/cos/det and matmul
# order; 1e-6 absolute on O(1) values is a few ulps
SIM3_TOL = 1e-6


def _tangents(seed, n=96):
    """[omega, nu, sigma] tangents: rotations and log-scales up to ~1,
    with each Taylor branch (theta, |sigma| < 1e-6) and both at once."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0.0, 0.35, size=(n, 7)).astype(np.float32)
    xi[:8, :3] *= 1e-7  # small theta
    xi[8:16, 6] *= 1e-7  # small sigma
    xi[16:24, :3] *= 1e-7  # both
    xi[16:24, 6] *= 1e-7
    xi[24:28, :3] = 0.0  # exactly zero
    xi[24:28, 6] = 0.0
    return xi


def _close(t, j, tol=SIM3_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


def test_expmap_and_calc_W_match_jax():
    xi = _tangents(0)
    _close(tsim.expmap(torch.from_numpy(xi)), jsim.expmap(jnp.asarray(xi)))
    _close(tsim._calc_W(torch.from_numpy(xi[:, :3]), torch.from_numpy(xi[:, 6])),
           jsim._calc_W(jnp.asarray(xi[:, :3]), jnp.asarray(xi[:, 6])))


@pytest.mark.parametrize("name", ["logmap", "inverse", "scale_of", "to_se3"])
def test_matrix_functions_match_jax(name):
    M = np.array(jsim.expmap(jnp.asarray(_tangents(1))))
    _close(getattr(tsim, name)(torch.from_numpy(M)), getattr(jsim, name)(jnp.asarray(M)))


def test_round_trips_and_from_se3():
    """logmap(expmap(xi)) = xi and M inverse(M) = I within 2e-6 (the
    JAX package's own round trip holds the same bound here), and
    from_se3 / to_se3 invert each other at any scale."""
    xi = _tangents(2)
    back = tsim.logmap(tsim.expmap(torch.from_numpy(xi))).numpy()
    back_j = np.asarray(jsim.logmap(jsim.expmap(jnp.asarray(xi))))
    np.testing.assert_allclose(back, xi, atol=2e-6, rtol=0)
    np.testing.assert_allclose(back_j, xi, atol=2e-6, rtol=0)
    M = tsim.expmap(torch.from_numpy(xi))
    np.testing.assert_allclose((M @ tsim.inverse(M)).numpy(), np.tile(np.eye(4), (len(xi), 1, 1)),
                               atol=2e-6, rtol=0)
    T = tsim.to_se3(M)
    for s in (1.0, 0.7):
        S = tsim.from_se3(T, s)
        _close(tsim.to_se3(S), T)
        np.testing.assert_allclose(tsim.scale_of(S).numpy(), s, atol=1e-6, rtol=0)
        _close(tsim.from_se3(T, s), jsim.from_se3(jnp.asarray(T.numpy()), s))


@pytest.mark.parametrize("which", ["theta", "sigma"])
def test_calc_W_cancellation_band(which):
    """Just above the Taylor switch (1e-6 .. 1e-2 in theta or in sigma)
    the closed forms cancel in float32 ((1 - cos) / theta^2, (s - 1) /
    sigma, ...), and the two libraries' sin/cos/exp differ by an ulp. As
    for se3 (test_se3_cancellation_band): the port is no further from the
    float64 value than the reference is."""
    rng = np.random.default_rng(5)
    n = 512
    band = np.geomspace(1.01e-6, 1e-2, n)
    omega = rng.normal(0.0, 0.3, size=(n, 3))
    sigma = rng.normal(0.0, 0.3, size=n)
    if which == "theta":
        omega = omega / np.linalg.norm(omega, axis=1, keepdims=True) * band[:, None]
    else:
        sigma = band * np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    omega, sigma = omega.astype(np.float32), sigma.astype(np.float32)
    exact = tsim._calc_W(torch.from_numpy(omega).double(), torch.from_numpy(sigma).double()).numpy()
    err_t = np.abs(tsim._calc_W(torch.from_numpy(omega), torch.from_numpy(sigma)).numpy() - exact).max()
    err_j = np.abs(np.asarray(jsim._calc_W(jnp.asarray(omega), jnp.asarray(sigma))) - exact).max()
    assert err_t <= 1.25 * err_j + 1e-7, (err_t, err_j)


def test_adjoint_and_bracket_identities():
    """In float64: M Exp(x) M^-1 = Exp(Ad_M x), and ad_xi eta is the
    bracket [xi^, eta^] of the 4x4 algebra elements [[w^ + s I, nu], 0]."""
    rng = np.random.default_rng(7)
    xi = torch.from_numpy(rng.normal(0.0, 0.4, size=(32, 7)))
    eta = torch.from_numpy(rng.normal(0.0, 0.4, size=(32, 7)))
    M = tsim.expmap(xi)
    lhs = M @ tsim.expmap(eta) @ tsim.inverse(M)
    rhs = tsim.expmap((tsim.adjoint(M) @ eta[..., None])[..., 0])
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-12, rtol=0)

    def alg(x):
        A = torch.zeros(x.shape[:-1] + (4, 4), dtype=x.dtype)
        A[..., :3, :3] = tsim._hat(x[..., :3]) + x[..., 6, None, None] * torch.eye(3, dtype=x.dtype)
        A[..., :3, 3] = x[..., 3:6]
        return A

    br = alg(xi) @ alg(eta) - alg(eta) @ alg(xi)
    np.testing.assert_allclose(alg((tsim.ad(xi) @ eta[..., None])[..., 0]).numpy(), br.numpy(),
                               atol=1e-12, rtol=0)
