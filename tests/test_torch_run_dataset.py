"""The port's dataset driver (``python -m vslam_torch.run_dataset``) on the
CPU, held against vslam_tpu's VSlamSystem fed the same decoded frames:
tests/test_driver.py's 320x240 KITTI-layout sequence, an odd shape
(321x241, every pyramid level an odd width somewhere), and an unrectified
identity rig through both rectification routes (native: uint8 remap on
the host, the facade told ``io_rectified``; PIL: the facade's float remap
on the device), each against JAX's same route. Then the checkpoint /
resume contract of tests/test_driver.py:123-157 through the CLI."""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from vslam_torch import run_dataset
from vslam_tpu.models import system as jsys
from vslam_tpu.utils import datasets as jds, synthetic, trajectory as jtraj
from vslam_tpu.utils.config import ConfigFile as JConfig

torch.set_num_threads(2)  # xdist runs several workers on one box

REPO = pathlib.Path(__file__).resolve().parents[1]
FX, BL = 460.0, 0.12
POSE_TOL_M = 1e-3  # tests/test_torch_mapper.py:155
PARTED_TOL_M = 1e-2  # a frame whose stereo key count JAX's fused program rounds otherwise (_hold)


def _write_sequence(root, W, H, n, seed=7, rectified=True, n_points=400, fe=(512, 4)):
    """A rendered stereo sequence as uint8 PNGs in KITTI layout and its
    config (tests/test_driver.py:23-52). ``rectified=False`` declares the
    rig raw with K = the scene's, D = 0, R = I, P = [K|0]. `fe`: the
    features and pyramid levels."""
    scene = synthetic.make_scene(n_frames=n, n_points=n_points, width=W, height=H, fps=10.0, seed=seed)
    for sub in ("image_0", "image_1"):
        os.makedirs(root / sub, exist_ok=True)
    for f in range(n):
        for right, sub in ((False, "image_0"), (True, "image_1")):
            img = np.clip(scene.render(f, right=right), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / sub / f"{f:06d}.png")
    np.savetxt(root / "times.txt", scene.times)
    cx, cy = W / 2.0, H / 2.0
    cam = f"fx: {FX}, fy: {FX}, cx: {cx}, cy: {cy}"
    if not rectified:
        K = [FX, 0.0, cx, 0.0, FX, cy, 0.0, 0.0, 1.0]
        P = [FX, 0.0, cx, 0.0, 0.0, FX, cy, 0.0, 0.0, 0.0, 1.0, 0.0]
        cam += (f", K: {{rows: 3, cols: 3, data: {K}}}, D: {{rows: 1, cols: 5, data: [0, 0, 0, 0, 0]}}"
                f", R: {{rows: 3, cols: 3, data: [1, 0, 0, 0, 1, 0, 0, 0, 1]}}"
                f", P: {{rows: 3, cols: 4, data: {P}}}")
    cfg = root / "config.yaml"
    cfg.write_text(f"""rectified: {str(rectified).lower()}
slamMode: 1
dataset: "KITTI"
imagesPath: "{root}"
fileExtension: ".png"
Camera: {{width: {W}, height: {H}, fps: 10.0, bl: {BL}}}
Camera_l: {{{cam}}}
Camera_r: {{{cam}}}
FE: {{nFeatures: {fe[0]}, nLevels: {fe[1]}, imScale: 1.2, edgeThreshold: 19, maxFastThreshold: 20, minFastThreshold: 7}}
""")
    return str(cfg), scene


def _example_maps(cfg):
    """examples/run_dataset.py's host rectification maps for `cfg` (the
    example module is loaded; its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        "example_run_dataset", REPO / "examples" / "run_dataset.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._host_rectify_maps(JConfig(cfg), mono=False)


def _jax_run(cfg, native: bool):
    """vslam_tpu's facade on the sequence, frames from its own reader: the
    native prefetcher (host rectification for a raw rig, the facade told
    io_rectified) or PIL (the facade's device remap). The per-frame stats
    come from its debug hook."""
    conf = JConfig(cfg)
    maps = _example_maps(cfg) if native and not conf.rectified else None
    sys_ = jsys.VSlamSystem(conf, io_rectified=maps is not None)
    stats = []
    sys_.tracker.debug_hook = lambda f, pose, out, st: stats.append((f, dict(st)))
    for fr in jds.open_dataset(conf).frames(maps=maps, prefetch=native):
        sys_.track_stereo(fr.left, fr.right)
    sys_.exit()
    return sys_, stats


def _torch_run(cfg, out, argv=()):
    """The port's driver on the CPU; its trajectory, result and each
    processed frame's tracker stats."""
    stats = []
    from vslam_torch.models import tracker as ttr

    orig = ttr.StereoTracker._process

    def spy(self, frame_idx, *a):
        n_kf = self.world.n_keyframes
        out = orig(self, frame_idx, *a)
        stats.append((frame_idx, dict(self.last_stats, new_kf=self.world.n_keyframes > n_kf)))
        return out

    ttr.StereoTracker._process = spy
    try:
        r = run_dataset.main([cfg, "--device", "cpu", "--out", str(out), *argv])
    finally:
        ttr.StereoTracker._process = orig
    return jtraj.load_kitti_trajectory(str(out)), r, stats


def _hold(cfg, scene, n, run, native: bool):
    """Hold the port's run to JAX's on the same frames: the same keyframes at
    the same frames and the same BA count; per-frame poses within 1e-3 m
    wherever both trackers stereo-matched the same number of keys.

    Where they did not, JAX's count comes from its fused frame program:
    XLA fuses match_stereo into the frame step and rounds the SAD sums
    otherwise than the JAX package's own standalone match_stereo, which the
    port matches exactly (tests/test_torch_matching.py; ROADMAP queue C).
    Such a frame is held within 1e-2 m, and the caller checks the
    explanation on the worst one (_stereo_counts). Returns the parted
    frames, the per-frame distances and both runs' stats."""
    js, jstats = _jax_run(cfg, native)
    tp, r, tstats = run
    assert r["io"] == ("native" if native else "pil") and r["frames"] == n
    assert r["keyframes"] == js.world.n_keyframes >= 2
    assert r["ba_runs"] == js.mapper.ba_count >= 1
    jp = js.trajectory()
    assert tp.shape == jp.shape == (n, 4, 4)
    assert [f for f, _ in tstats] == [f for f, _ in jstats] == list(range(1, n))
    parted = [f for (f, a), (_, b) in zip(jstats, tstats) if a["n_stereo_keys"] != b["n_stereo_keys"]]
    same = [f for f in range(n) if f not in parted]
    np.testing.assert_allclose(tp[same], jp[same], atol=POSE_TOL_M, rtol=0)
    np.testing.assert_allclose(tp[parted], jp[parted], atol=PARTED_TOL_M, rtol=0)
    ate = jtraj.ate_rmse(tp, scene.poses_c2w[:n], align=False)
    assert ate < 0.08, ate
    return parted, np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1), jstats, tstats


def _stereo_counts(cfg, f):
    """Frame f's stereo-matched key count in JAX's fused frame-0 program, in
    the JAX package's standalone extract_batch + match_stereo, and in the
    port's frontend."""
    import jax
    import jax.numpy as jnp

    from vslam_torch.models import tracker as ttr
    from vslam_tpu.models import map_state as jms, tracker as jtr
    from vslam_tpu.ops import extract as jext, stereo_match as jsm

    conf = JConfig(cfg)
    fr = list(jds.open_dataset(conf).frames(prefetch=False))[f]
    W, H = int(conf.get("Camera", "width")), int(conf.get("Camera", "height"))
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    jt = jtr.StereoTracker(K, BL, W, H, jms.WorldMap(keys_per_kf=512),
                           jtr.TrackerParams(n_features=512, n_levels=4))
    _, st = jtr._frontend(jnp.asarray(fr.left), jnp.asarray(fr.right), jt.K[0, 0], jt.baseline,
                          jt.scale_factors, jt._static)
    LR = jnp.stack([jnp.asarray(fr.left), jnp.asarray(fr.right)])
    keys = jext.extract_batch(LR, n_levels=4, scale=1.2, total=512, edge_margin=19,
                              fast_hi=20.0, fast_lo=7.0)
    side = [[getattr(keys, n)[i] for n in ("xy", "octave", "desc", "valid")] for i in (0, 1)]
    sf = jext.scale_factors(4, 1.2)
    alone = jsm.match_stereo(LR[0], LR[1], *side[0], *side[1], jnp.float32(FX), jnp.float32(BL),
                             jnp.asarray(sf), close_factor=jt._static[-1])
    LR_t = torch.from_numpy(np.stack([fr.left, fr.right]))
    _, tst = ttr._frontend(LR_t, torch.tensor(FX), torch.tensor(BL), torch.from_numpy(np.asarray(sf)),
                           ttr.TrackerParams(n_features=512, n_levels=4))
    return (int(np.asarray(st["matched"]).sum()), int(np.asarray(alone["matched"]).sum()),
            int(tst["matched"].sum()))


@pytest.fixture(scope="module")
def seq320(tmp_path_factory):
    """tests/test_driver.py's sequence (10 frames at 320x240, seed 7) and the
    port driver's run on it (native IO)."""
    root = tmp_path_factory.mktemp("seq320")
    cfg, scene = _write_sequence(root, 320, 240, 10)
    return cfg, scene, _torch_run(cfg, root / "full.txt")


def test_driver_matches_jax_320x240(seq320):
    """On this sequence JAX's fused program parts from its own match_stereo
    at keyframe 7 (184 against 188 keys) and the pose there by ~4.5 mm; the
    worst parted frame is checked to be that case."""
    cfg, scene, run = seq320
    parted, dt, jstats, tstats = _hold(cfg, scene, 10, run, native=True)
    if parted:
        f = max(parted, key=lambda i: dt[i])
        fused, alone, port = _stereo_counts(cfg, f)
        assert port == alone != fused, (f, fused, alone, port)
        assert dict(tstats)[f]["n_stereo_keys"] == port and dict(jstats)[f]["n_stereo_keys"] == fused


def test_driver_matches_jax_odd_shape(tmp_path):
    """321x241: odd widths and heights at every pyramid level."""
    cfg, scene = _write_sequence(tmp_path, 321, 241, 8)
    _hold(cfg, scene, 8, _torch_run(cfg, tmp_path / "t.txt"), native=True)


@pytest.mark.parametrize("native", [True, False], ids=["host-uint8", "device-f32"])
def test_driver_unrectified_rig_matches_jax(tmp_path, native):
    cfg, scene = _write_sequence(tmp_path, 320, 240, 8, rectified=False)
    run = _torch_run(cfg, tmp_path / "t.txt", () if native else ("--no-prefetch",))
    _hold(cfg, scene, 8, run, native=native)


def test_driver_checkpoint_resume_continues(seq320, tmp_path):
    """tests/test_driver.py:123-157 through the port's CLI: stop at frame 6
    with a checkpoint (also one every keyframe, and the viewer, the PLY and
    overlays written on the way), resume to the end: the resumed trajectory
    stays within 0.05 m of the uninterrupted run and tracks at cm scale."""
    cfg, scene, (full, _, _) = seq320
    ck, html = tmp_path / "ck.npz", tmp_path / "m.html"
    _, r, _ = _torch_run(cfg, tmp_path / "part.txt", (
        "--limit", "6", "--checkpoint", str(ck), "--checkpoint-every", "1", "--viz", str(html),
        "--viz-every", "1", "--ply", str(tmp_path / "m.ply"), "--debug-dir", str(tmp_path / "dbg"),
        "--debug-every", "2"))
    assert r["frames"] == 6 and r["checkpoints"] >= 2 and r["checkpoint_bytes"] == ck.stat().st_size
    assert (tmp_path / "m.json").stat().st_size > 100 and html.stat().st_size > 1000
    assert (tmp_path / "m.ply").read_text().startswith("ply")
    assert sorted(p.name for p in (tmp_path / "dbg").iterdir()) == [
        "frame_000002.png", "frame_000004.png"]
    resumed, r2, _ = _torch_run(cfg, tmp_path / "resumed.txt", ("--resume", str(ck)))
    assert r2["resumed_from"] == 6 and r2["frames"] == 4 and r2["checkpoint_load_s"] > 0
    assert resumed.shape == full.shape == (10, 4, 4)
    np.testing.assert_allclose(resumed[:, :3, :], full[:, :3, :], atol=0.05)
    assert jtraj.ate_rmse(resumed, scene.poses_c2w[:10], align=False) < 0.08


@pytest.mark.slow
@pytest.mark.parametrize("seed", [5, 6])
def test_kitti00_shape_against_jax(tmp_path, seed):
    """KITTI 00's published camera (1241x376, 2000 features rounded to 2048,
    8 levels) on 40 frames of 8-bit PNGs (900 points, 10 fps), JAX and the
    port on the same decoded frames (PIL). Seed 5 (chip_smoke.py phase
    12's scene) loses track in BOTH packages at the same keyframe: frame
    25 accepts a jump above 0.25 m on fewer than 40 inliers and neither
    recovers; so chip_smoke.py phase 17
    runs seed 6, which both packages track. Per-frame poses are held within
    1e-2 m (seed 5: 2e-2 m before the failure): at this size JAX's fused
    frame program stereo-matches a few keys otherwise than its own
    match_stereo (see _hold). A full-size run: take it where the machine
    can (4-6 min each on 8 cores), e.g. on the card's machine's CPU."""
    n = 40
    cfg, scene = _write_sequence(tmp_path, 1241, 376, n, seed=seed, n_points=900, fe=(2000, 8))
    js, jstats = _jax_run(cfg, native=False)
    tp, r, tstats = _torch_run(cfg, tmp_path / "t.txt", ("--no-prefetch",))
    jp = js.trajectory()
    t_kf = [0] + [f for f, st in tstats if st["new_kf"]]
    assert t_kf == js.world.kf_frame_idx[: js.world.n_keyframes].tolist()
    gt = scene.poses_c2w[:n]
    ate_j, ate_t = (jtraj.ate_rmse(p, gt, align=False) for p in (jp, tp))
    dt = np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1)
    if seed == 5:
        for stats in (jstats, tstats):
            st = dict(stats)[25]
            assert st["sol_jump"] > 0.25 and st["n_inliers"] < 40, st
        assert ate_j > 1.0 and ate_t > 1.0, (ate_j, ate_t)
        # the inliers fall to ~120-160 over frames 20-24 and the two part
        # by up to 1.13e-2 m there (frame 24) before both fail at 25
        np.testing.assert_allclose(tp[:25], jp[:25], atol=2 * PARTED_TOL_M, rtol=0, err_msg=str(dt.round(4)))
    else:
        assert ate_j < 0.08 and ate_t < 0.08, (ate_j, ate_t)
        np.testing.assert_allclose(tp, jp, atol=PARTED_TOL_M, rtol=0, err_msg=str(dt.round(4)))


def _write_euroc(root, scene, n):
    """The EuRoC layout (mav0/cam0|cam1 with data.csv, imu0/data.csv, ns
    timestamps) of a scene and a STEREO_IMU config: an identity raw rig,
    the scene's gravity (the synthetic body is not EuRoC-mounted)."""
    mav0 = root / "mav0"
    ns = [int(round(t * 1e9)) for t in scene.times[:n]]
    for i, cam in enumerate(("cam0", "cam1")):
        os.makedirs(mav0 / cam / "data")
        (mav0 / cam / "data.csv").write_text("#ts,name\n" + "".join(f"{t},{t}.png\n" for t in ns))
        for f, t in enumerate(ns):
            img = np.clip(scene.render(f, right=bool(i)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(mav0 / cam / "data" / f"{t}.png")
    os.makedirs(mav0 / "imu0")
    (mav0 / "imu0" / "data.csv").write_text("#ts,w,a\n" + "".join(
        f"{int(round(r[0] * 1e9))}," + ",".join(f"{v:.17g}" for v in r[1:7]) + "\n" for r in scene.imu))
    W, H = scene.width, scene.height
    K = [FX, 0.0, W / 2.0, 0.0, FX, H / 2.0, 0.0, 0.0, 1.0]
    P = K[:3] + [0.0] + K[3:6] + [0.0] + K[6:] + [0.0]
    cam = (f"{{fx: {FX}, fy: {FX}, cx: {W / 2.0}, cy: {H / 2.0}, K: {{rows: 3, cols: 3, data: {K}}}, "
           f"D: {{rows: 1, cols: 5, data: [0, 0, 0, 0, 0]}}, R: {{rows: 3, cols: 3, data: [1, 0, 0, 0, 1, 0, 0, 0, 1]}}, "
           f"P: {{rows: 3, cols: 4, data: {P}}}}}")
    g = synthetic.GRAVITY_W.astype(float).tolist()
    cfg = root / "config.yaml"
    cfg.write_text(f"""rectified: false
slamMode: 0
dataset: "EuRoC"
imagesPath: "{mav0}"
Camera: {{width: {W}, height: {H}, fps: 20.0, bl: {BL}}}
Camera_l: {cam}
Camera_r: {cam}
FE: {{nFeatures: 512, nLevels: 4, imScale: 1.2}}
IMU: {{Hz: 200, gravity: {g}}}
""")
    return str(cfg)


@pytest.mark.slow
@pytest.mark.parametrize("ramp_tau", [None, 1.0], ids=["full-speed", "from-rest"])
def test_euroc_stereo_imu_needs_a_start_at_rest(tmp_path, ramp_tau):
    """The dataset drivers start STEREO_IMU at zero velocity, as the
    reference's does and as a real EuRoC capture starts (at rest). On the
    bench's scene (seed 3, 1.2 m/s from frame 0) both packages stay stuck
    at the start (ATE ~0.29 m over 10 frames at 376x240); from rest
    (make_scene's ramp_tau, as tests/test_fullscale.py's EuRoC drives and
    chip_smoke.py phase 17 do) both track. JAX and the port (both
    rectification routes) agree within 1e-3 m either way."""
    n = 10
    scene = synthetic.make_scene(n_frames=n, n_points=900, width=376, height=240, fps=20.0, seed=3,
                                 ramp_tau=ramp_tau)
    cfg = _write_euroc(tmp_path, scene, n)
    conf = JConfig(cfg)
    js = jsys.VSlamSystem(conf)
    for fr in jds.open_dataset(conf).frames(prefetch=False):
        js.track_stereo(fr.left, fr.right, imu=fr.imu)
    js.exit()
    jp = js.trajectory()
    gt = scene.poses_c2w[:n]
    for extra in ((), ("--no-prefetch",)):
        tp, r, _ = _torch_run(cfg, tmp_path / "t.txt", extra)
        assert r["mode"] == "STEREO_IMU" and r["frames"] == n
        np.testing.assert_allclose(tp, jp, atol=POSE_TOL_M, rtol=0)
    ate = jtraj.ate_rmse(jp, gt, align=False)
    assert (ate > 0.2) if ramp_tau is None else (ate < 0.01), ate
