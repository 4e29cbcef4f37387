"""The slab-chunked Schur reduction on a real window, in both packages on
the CPU: the last local BA window of chip_smoke.py's phase 6 (80 frames of
the 752x480 bench scene through the port's VSlamSystem on an H100; 15
keyframes in 20 slots, 5311 of 6144 rows, 1566 landmarks in 4096 slots),
saved as numpy in tests/data/ba_window_bench.npz.

One of its landmarks lies ~24 km away: its stereo row has no disparity
left, so its block is singular along the ray and any change of the step
moves it along the ray without changing its residual. The slabbed and
unslabbed solves of either package differ by the reduced system's sum
order alone, and that landmark takes the difference by tens to hundreds
of metres; every landmark whose block is conditioned holds to
tests/test_ba.py:141-147's 5e-3."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from vslam_torch.models import convert
from vslam_torch.ops import schur as tsch
from vslam_tpu.ops import schur as jsch

torch.set_num_threads(2)  # xdist runs several workers on one box

WINDOW = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ba_window_bench.npz")
COND_MAX = 1e6  # chip_smoke.LM_COND_MAX


def test_bench_window_slabbed_against_unslabbed_in_both_packages():
    """local_ba_two_rounds with 4 slabs against 1, in the port and in
    JAX: poses within 5e-4, errors within 1e-3 relative, identical kills;
    points within 5e-3 over the landmarks whose undamped block has a
    condition number under 1e6, and the port within 5e-3 of JAX there.
    The landmarks beyond that bound are the far ones (range > 100 m) and
    the JAX package moves the farthest between its own two solves too."""
    d = dict(np.load(WINDOW))
    tp = convert.ba_problem_from_jax(d, "cpu")
    jp = jsch.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    ta, ts = tsch.local_ba_two_rounds(tp), tsch.local_ba_two_rounds(tp, n_slabs=4)
    ja, js = jsch.local_ba_two_rounds(jp), jsch.local_ba_two_rounds(jp, n_slabs=4)

    q = ta[0]
    ev = torch.linalg.eigvalsh(tsch._assemble(q)[1].double()).numpy()
    n_rows = np.bincount(q.obs_lm[q.obs_valid].numpy(), minlength=q.pts.shape[0])
    valid = d["pt_valid"] & (n_rows > 0)
    placed = valid & (ev[:, 0] * COND_MAX > ev[:, 2])
    far = np.linalg.norm(d["pts"] - d["poses"][0, :3, 3], axis=1) > 100.0
    assert placed.sum() > 1500 and not (valid & far & placed).any()

    def dpt(x, y):
        return np.abs(np.asarray(x) - np.asarray(y)).max(axis=1)

    for a, s in ((ta, ts), (ja, js)):
        np.testing.assert_allclose(np.asarray(s[0].poses), np.asarray(a[0].poses), atol=5e-4, rtol=0)
        assert abs(float(s[1]) - float(a[1])) <= 1e-3 * float(a[1])
        np.testing.assert_array_equal(np.asarray(s[2]), np.asarray(a[2]))
        assert dpt(s[0].pts, a[0].pts)[placed].max() <= 5e-3
    assert dpt(ta[0].pts, ja[0].pts)[placed].max() <= 5e-3
    loose = valid & ~placed
    print(f"[window] conditioned {placed.sum()}, other {loose.sum()} (far {int((loose & far).sum())}); "
          f"their largest slabbed move: port {dpt(ts[0].pts, ta[0].pts)[loose].max():.6g} m, "
          f"JAX {dpt(js[0].pts, ja[0].pts)[loose].max():.6g} m")
    assert dpt(js[0].pts, ja[0].pts)[loose & far].max() > 5e-3
