"""Parity of the PyTorch port (vslam_torch) against vslam_tpu on the CPU:
SE(3) geometry, pyramid levels, Hamming distances, config, the port's own
copies of the synthetic scene and the ATE, and a check that the port
loads nothing of vslam_tpu. Inputs are made with numpy from a seed and
handed to both."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vslam_torch.geometry import se3 as tse3
from vslam_torch.ops import hamming as tham, pyramid as tpyr
from vslam_torch.utils import config as tcfg, synthetic as tsyn, trajectory as ttraj
from vslam_tpu.geometry import se3 as jse3
from vslam_tpu.ops import hamming as jham, pyramid as jpyr
from vslam_tpu.utils import config as jcfg, synthetic, trajectory as jtraj

torch.set_num_threads(2)  # xdist runs several workers on one box

# float32 geometry: both libraries evaluate the same formulas, but matrix
# products may sum in another order; 1e-6 absolute on O(1) values is a few
# ulps
SE3_TOL = 1e-6


def _tangents(seed, n=64):
    """Rotations up to ~1.5 rad (tracking-sized and beyond), with the
    small-angle branches covered explicitly."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0.0, 0.3, size=(n, 6)).astype(np.float32)
    xi[:8, :3] *= 1e-5  # small-angle branches (theta^2 < 1e-8)
    xi[8:12, :3] = 0.0  # exactly zero rotation
    return xi


def _poses(seed, n=64):
    return np.array(jse3.se3_expmap(jnp.asarray(_tangents(seed, n))))


def _close(t, j, tol=SE3_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


@pytest.mark.parametrize(
    "name",
    ["so3_expmap", "se3_expmap", "_so3_left_jacobian", "hat"],
)
def test_se3_tangent_functions(name):
    w = _tangents(0)
    arg = w if name == "se3_expmap" else w[:, :3]
    _close(getattr(tse3, name)(torch.from_numpy(arg)), getattr(jse3, name)(jnp.asarray(arg)))


@pytest.mark.parametrize("name", ["so3_expmap", "_so3_left_jacobian"])
def test_se3_cancellation_band(name):
    """Just above the small-angle branch (theta 1e-4 .. 1e-2 rad) the
    reference formulas cancel in float32 ((1 - cos) / theta^2 and
    (theta - sin) / theta^3), and the two libraries' sin/cos differ by an
    ulp, so they do not agree to 1e-6 there. The requirement: the port is
    no further from the float64 value than the reference is."""
    rng = np.random.default_rng(9)
    w = (rng.normal(0.0, 1.0, size=(512, 3)) * np.geomspace(1e-4, 1e-2, 512)[:, None])
    w = w.astype(np.float32)
    exact = getattr(tse3, name)(torch.from_numpy(w).double()).numpy()
    err_t = np.abs(getattr(tse3, name)(torch.from_numpy(w)).numpy() - exact).max()
    err_j = np.abs(np.asarray(getattr(jse3, name)(jnp.asarray(w))) - exact).max()
    assert err_t <= 1.25 * err_j + 1e-7, (err_t, err_j)


@pytest.mark.parametrize(
    "name", ["se3_logmap", "inverse", "orthonormalize", "rot_to_quat"]
)
def test_se3_pose_functions(name):
    T = _poses(1)
    arg = T[:, :3, :3] if name == "rot_to_quat" else T
    t = getattr(tse3, name)(torch.from_numpy(arg))
    j = getattr(jse3, name)(jnp.asarray(arg))
    _close(t, j)


def test_se3_transform_and_retract():
    rng = np.random.default_rng(2)
    T = _poses(2, 16)
    pts = rng.normal(0, 3.0, size=(16, 50, 3)).astype(np.float32)
    xi = _tangents(3, 16)
    # |p| ~ 5 m: tolerance 1e-6 relative to the magnitude
    _close(
        tse3.transform_points(torch.from_numpy(T), torch.from_numpy(pts)),
        jse3.transform_points(jnp.asarray(T), jnp.asarray(pts)),
        tol=1e-5,
    )
    _close(
        tse3.transform_points(torch.from_numpy(T[0]), torch.from_numpy(pts[0, 0])),
        jse3.transform_points(jnp.asarray(T[0]), jnp.asarray(pts[0, 0])),
        tol=1e-5,
    )
    _close(
        tse3.retract(torch.from_numpy(T), torch.from_numpy(xi)),
        jse3.retract(jnp.asarray(T), jnp.asarray(xi)),
    )
    _close(
        tse3.quat_to_rot(tse3.rot_to_quat(torch.from_numpy(T[:, :3, :3]))),
        jse3.quat_to_rot(jse3.rot_to_quat(jnp.asarray(T[:, :3, :3]))),
    )


def _frames(width=160, height=120, n=2):
    scene = synthetic.make_scene(
        n_frames=2, n_points=200, width=width, height=height, fps=10.0, seed=11
    )
    return np.stack([scene.render(0), scene.render(0, right=True)])[:n]


def test_level_shapes_match():
    for args in [(480, 752, 8, 1.2), (240, 320, 4, 1.2), (375, 1242, 8, 1.2)]:
        assert tpyr.level_shapes(*args) == jpyr.level_shapes(*args)


def test_pyramid_levels_bit_exact():
    """Every level of the resize chain and its blur: elementwise programs
    with the same operation order, so exact (tolerance 0)."""
    imgs = _frames()
    t_cur, j_cur = torch.from_numpy(imgs), jnp.asarray(imgs)
    for h, w in tpyr.level_shapes(120, 160, 5, 1.2)[1:]:
        t_cur = tpyr.resize_bilinear_batch(t_cur, h, w)
        j_cur = jpyr.resize_bilinear_batch(j_cur, h, w)
        np.testing.assert_array_equal(t_cur.numpy(), np.asarray(j_cur))
        np.testing.assert_array_equal(
            tpyr.gaussian_blur_batch(t_cur).numpy(),
            np.asarray(jpyr.gaussian_blur_batch(j_cur)),
        )


def _descs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, size=(n, 256)) * 2 - 1).astype(np.int8)


def test_hamming_matrix_exact():
    a, b = _descs(4, 70), _descs(5, 90)
    rng = np.random.default_rng(6)
    va, vb = rng.random(70) > 0.2, rng.random(90) > 0.2
    t = tham.hamming_matrix(*(torch.from_numpy(x) for x in (a, b, va, vb)))
    j = jham.hamming_matrix(*(jnp.asarray(x) for x in (a, b, va, vb)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pack_unpack_and_popcount_exact():
    a, b = _descs(7, 40), _descs(8, 30)
    ta = tham.pack_signed(torch.from_numpy(a))
    ja = jham.pack_signed(jnp.asarray(a))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
    np.testing.assert_array_equal(tham.unpack_signed(ta).numpy(), a)
    tb = tham.pack_signed(torch.from_numpy(b))
    d_t = tham.packed_hamming(ta, tb).numpy()
    d_j = np.asarray(jham.packed_hamming(ja, jham.pack_signed(jnp.asarray(b))))
    np.testing.assert_array_equal(d_t, d_j)
    # the popcount oracle agrees with the matmul form
    np.testing.assert_array_equal(
        d_t, tham.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    )


def test_config_from_dict_and_file_match_jax():
    cfg_t = tcfg.ConfigFile("config_MH_01.yaml")
    cfg_j = jcfg.ConfigFile("config_MH_01.yaml")
    assert cfg_t.data == cfg_j.data
    assert cfg_t.slam_mode == cfg_j.slam_mode
    np.testing.assert_array_equal(cfg_t.get_matrix("T_bc1"), cfg_j.get_matrix("T_bc1"))
    d = tcfg.ConfigFile.from_dict({"slamMode": 1, "Camera": {"fps": 20}})
    assert d.slam_mode == tcfg.SlamMode.STEREO and d.get("Camera", "fps") == 20
    with pytest.raises(KeyError, match="Camera.bl"):
        d.get("Camera", "bl")
    with pytest.raises(ValueError):
        tcfg.ConfigFile.from_dict(None)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_helpers_are_the_jax_package_files():
    """The port's own copies (utils/synthetic.py, utils/trajectory.py)
    give what the JAX package's files give."""
    s_t = tsyn.make_scene(n_frames=2, n_points=50, width=96, height=64, fps=10.0, seed=1)
    s_j = synthetic.make_scene(n_frames=2, n_points=50, width=96, height=64, fps=10.0, seed=1)
    np.testing.assert_array_equal(s_t.render(1), s_j.render(1))
    assert ttraj.ate_rmse(s_t.poses_c2w, s_j.poses_c2w, align=False) == 0.0


SCENE_CASES = [
    dict(n_frames=4, n_points=120, width=160, height=120, fps=20.0, seed=3),
    dict(n_frames=3, n_points=80, width=128, height=96, fps=10.0, seed=5, texture="distinct",
         motion="lateral", noise_std=2.0, gain_drift=0.1),
    dict(n_frames=3, n_points=80, width=128, height=96, fps=10.0, seed=9, texture="natural",
         n_occluders=2, ramp_tau=0.5),
    dict(n_frames=3, n_points=60, width=128, height=96, fps=10.0, seed=11, texture="repeated",
         motion="excited", lowtex_span=(3.0, 6.0, 0.3)),
    # make_loop_scene: the closed circuit (bench.py:258's loops and wall radius)
    dict(maker="make_loop_scene", n_frames=4, n_points=80, width=128, height=96, seed=2, loops=1.2,
         wall_radius=10.0, noise_std=1.0),
]


@pytest.mark.parametrize("kw", SCENE_CASES)
def test_port_scene_and_ate_equal_the_jax_package(kw):
    """The same seeded scene through both packages: identical frames (both
    eyes), poses, IMU and landmarks; identical ATE, aligned and not."""
    kw = dict(kw)
    maker = kw.pop("maker", "make_scene")
    s_t, s_j = getattr(tsyn, maker)(**kw), getattr(synthetic, maker)(**kw)
    for name in ("K", "points_w", "patches", "poses_c2w", "velocities", "imu", "times"):
        np.testing.assert_array_equal(getattr(s_t, name), getattr(s_j, name), err_msg=name)
    for f in range(kw["n_frames"]):
        for right in (False, True):
            np.testing.assert_array_equal(s_t.render(f, right=right), s_j.render(f, right=right))
    np.testing.assert_array_equal(s_t.project_points(1)[0], s_j.project_points(1)[0])
    rng = np.random.default_rng(kw["seed"])
    est = s_t.poses_c2w.copy()
    est[:, :3, 3] += rng.normal(0.0, 0.05, size=(len(est), 3))
    for align, with_scale in ((False, False), (True, False), (True, True)):
        a_t = ttraj.ate_rmse(est, s_t.poses_c2w, align=align, with_scale=with_scale)
        a_j = jtraj.ate_rmse(est, s_j.poses_c2w, align=align, with_scale=with_scale)
        assert a_t == a_j and a_t > 0.0


def test_port_loads_nothing_of_the_jax_package():
    """Every module of vslam_torch, plus chip_smoke.py's imports, in a fresh
    interpreter: no module named vslam_tpu* is loaded and no loaded
    module's file lies under vslam_tpu/."""
    code = textwrap.dedent(
        """
        import ast, importlib, pathlib, pkgutil, sys
        repo = pathlib.Path.cwd().resolve()
        import vslam_torch
        for m in pkgutil.walk_packages(vslam_torch.__path__, "vslam_torch."):
            importlib.import_module(m.name)
        tree = ast.parse((repo / "chip_smoke.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    importlib.import_module(a.name)
            elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
                mod = importlib.import_module(node.module)
                for a in node.names:
                    if not hasattr(mod, a.name):
                        importlib.import_module(node.module + "." + a.name)
        jax_pkg = repo / "vslam_tpu"
        by_name = [m for m in sys.modules if m.split(".")[0].startswith("vslam_tpu")]
        by_file = [
            m for m, mod in list(sys.modules.items())
            if getattr(mod, "__file__", None)
            and pathlib.Path(mod.__file__).resolve().is_relative_to(jax_pkg)
        ]
        assert not by_name and not by_file, (by_name, by_file)
        assert "chip_smoke" not in sys.modules
        print("NO_VSLAM_TPU_OK", len([m for m in sys.modules if m.startswith("vslam_torch")]))
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0 and "NO_VSLAM_TPU_OK" in proc.stdout, proc.stderr[-3000:]
