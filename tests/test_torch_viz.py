"""The port's map exports (vslam_torch/utils/viz.py) and debug overlays
(vslam_torch/utils/debug_view.py) against vslam_tpu's: on a world tracked
by the JAX package and converted (convert.world_from_jax), export_ply,
export_html and LiveMapWriter write byte-equal files; render_overlay is
pixel-equal; the port tracker's debug_hook writes its overlays."""

import types

import numpy as np
import pytest
import torch
from PIL import Image

from vslam_torch.models import convert, map_state as tms, tracker as ttr
from vslam_torch.utils import debug_view as tdv, viz as tviz
from vslam_tpu.models import map_state as jms, tracker as jtr
from vslam_tpu.utils import debug_view as jdv, synthetic, viz as jviz

torch.set_num_threads(2)  # xdist runs several workers on one box

PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
WORLD = dict(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(n_frames=8, n_points=400, width=320, height=240, fps=10.0, seed=7)


@pytest.fixture(scope="module")
def tracked(scene):
    """tests/test_persistence.py's world, the scene's 8 frames tracked by
    the JAX package (its pipeline drained, so that the JAX world no longer
    moves), and its conversion to the port."""
    world = jms.WorldMap(**WORLD)
    trk = jtr.StereoTracker(scene.K.astype(np.float32), scene.baseline, scene.width,
                            scene.height, world, jtr.TrackerParams(**PARAMS))
    for f in range(8):
        trk.track(scene.render(f), scene.render(f, right=True))
    trk.flush()
    return world, trk, convert.world_from_jax(world, "cpu")


def test_ply_and_html_are_byte_equal(tmp_path, tracked):
    world, trk, tw = tracked
    traj = trk.trajectory()
    assert tw.n_keyframes >= 2 and int(tw.arrays.lm_valid.sum()) > 100
    for kw in ({}, {"active_ids": trk.active_ids}):
        tviz.export_ply(str(tmp_path / "t.ply"), tw, traj, **kw)
        jviz.export_ply(str(tmp_path / "j.ply"), world, traj, **kw)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        dt = tviz.export_html(str(tmp_path / "t.html"), tw, traj, live_reload_ms=500, **kw)
        dj = jviz.export_html(str(tmp_path / "j.html"), world, traj, live_reload_ms=500, **kw)
        assert dt == dj
        assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    # thinned to max_points, no trajectory
    tviz.export_html(str(tmp_path / "t.html"), tw, None, max_points=50)
    jviz.export_html(str(tmp_path / "j.html"), world, None, max_points=50)
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_live_map_writer_is_byte_equal(tmp_path, tracked):
    """Both writers export at the same keyframe counts and write the same
    page and .json; no .tmp file is left behind."""
    world, trk, tw = tracked
    host = types.SimpleNamespace(frame_records=trk.frame_records, active_ids=trk.active_ids)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    wt = tviz.LiveMapWriter(str(tmp_path / "t" / "live.html"), tw, every_n_kf=1)
    wj = jviz.LiveMapWriter(str(tmp_path / "j" / "live.html"), world, every_n_kf=1)
    assert wt.maybe_export(host) is True and wj.maybe_export(host) is True
    assert wt.maybe_export(host) is False and wj.maybe_export(host) is False
    for name in ("live.html", "live.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == ["live.html", "live.json"]


def test_render_overlay_is_pixel_equal():
    rng = np.random.default_rng(3)
    gray = rng.uniform(-20, 280, (61, 83)).astype(np.float32)
    xy = np.stack([rng.uniform(-5, 88, 200), rng.uniform(-5, 66, 200)], -1).astype(np.float32)
    valid = rng.random(200) < 0.8
    matched = np.sort(rng.choice(200, 60, replace=False))
    inl = matched[rng.random(60) < 0.7]
    stats = {"n_inliers": len(inl), "n_matched": 60, "n_keys": int(valid.sum())}
    for st in (None, stats):
        a = tdv.render_overlay(gray, xy, valid, matched, inl, st)
        b = jdv.render_overlay(gray, xy, valid, matched, inl, st)
        assert a.dtype == np.uint8 and a.shape == (61, 83, 3)
        np.testing.assert_array_equal(a, b)


def test_tracker_hook_writes_overlays(tmp_path, scene):
    """The port tracker calls its debug_hook once per processed frame;
    make_tracker_hook draws every 2nd frame whose left image it holds."""
    world = tms.WorldMap(**WORLD, device="cpu")
    trk = ttr.StereoTracker(scene.K.astype(np.float32), scene.baseline, scene.width,
                            scene.height, world, ttr.TrackerParams(**PARAMS), device="cpu")
    hook = tdv.make_tracker_hook(str(tmp_path / "dbg"), every=2)
    seen = []

    def spy(frame_idx, pose, outputs, stats):
        seen.append((frame_idx, stats["n_inliers"]))
        hook(frame_idx, pose, outputs, stats)

    trk.debug_hook = spy
    for f in range(6):
        hook.cache[f] = scene.render(f)
        trk.track(scene.render(f), scene.render(f, right=True))
    trk.flush()
    assert [f for f, _ in seen] == [1, 2, 3, 4, 5] and min(n for _, n in seen) > 50
    files = sorted(p.name for p in (tmp_path / "dbg").iterdir())
    assert files == ["frame_000002.png", "frame_000004.png"]
    im = np.asarray(Image.open(tmp_path / "dbg" / files[0]))
    assert im.shape == (240, 320, 3) and (im.max(axis=-1) != im.min(axis=-1)).any()
