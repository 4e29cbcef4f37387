"""The port's multi-sequence batch mode (vslam_torch/parallel/multi_seq.py)
against its own solo runs and against vslam_tpu's BatchedStereoFrontend on
the CPU, at tests/test_parallel.py's stereo shapes: 3 sequences x 10
frames of the 320x240 scene (400 points, seeds 7 + 3s), 512 features, 4
levels, each sequence with its own map and synchronous local mapper.

The module that holds the kernel is the extraction: a batched frame
extracts the 2S views of S stereo pairs in one call (one extract_windows
launch on a GPU), which must equal each pair's own extraction exactly and
the JAX package's extraction of the same views."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vslam_torch.models import local_mapper as tlm, map_state as tms, tracker as ttr
from vslam_torch.ops import extract as text
from vslam_torch.parallel import multi_seq as tms_seq
from vslam_torch.utils import trajectory as ttraj
from vslam_tpu.models import local_mapper as jlm, map_state as jms, tracker as jtr
from vslam_tpu.ops import extract as jext, stereo_match as jsm
from vslam_tpu.parallel import multi_seq as jms_seq
from vslam_tpu.utils import synthetic

torch.set_num_threads(2)  # xdist runs several workers on one box

N, S = 10, 3
PARAMS = dict(n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256, kf_min_stereo=60)
WORLD = dict(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
# the port's batch against its own solo runs: the same ops on the same
# inputs, so equal on the CPU (tests/test_parallel.py:292 allows 2e-3 m)
SOLO_TOL_M = 1e-6
# against JAX's batch: the tracker slice's tolerance
# (tests/test_torch_tracker.py:136) on every sequence and frame but the
# ones below, where the port's and JAX's SOLO runs already part by more
# (sequence 1, frame 7: 1.131 mm). The gap opens at the stereo frontend
# from frame 1, before any BA: JAX's jitted tracker._frontend matches
# another stereo set than its own eager match_stereo, which the port
# matches exactly (test_frontend_gap_is_jax_fusion pins it). There the
# batches must part by the solo runs' own gap, within BATCH_ADDS_M
JAX_TOL_M = 1e-3
OVER_JAX_TOL = {(1, 7)}
BATCH_ADDS_M = 2e-5
ATE_GATE_M = 0.04  # tests/test_parallel.py:296


@pytest.fixture(scope="module")
def scenes():
    out = []
    for s in range(S):
        sc = synthetic.make_scene(n_frames=N, n_points=400, width=320, height=240, fps=10.0,
                                  seed=7 + 3 * s)
        sc.frames = [(sc.render(f), sc.render(f, right=True)) for f in range(N)]
        out.append(sc)
    return out


def _pair(pkg, scene):
    """(tracker, mapper) of vslam_torch (on the CPU) or vslam_tpu."""
    trk_mod, map_mod, lm_mod = pkg
    K = scene.K.astype(np.float32)
    kw = {"device": "cpu"} if trk_mod is ttr else {}
    world = map_mod.WorldMap(**WORLD, **kw)
    trk = trk_mod.StereoTracker(K, scene.baseline, scene.width, scene.height, world,
                                trk_mod.TrackerParams(**PARAMS), **kw)
    mapper = lm_mod.LocalMapper(world, K, scene.baseline, lm_mod.LocalMapperConfig(n_levels=4, scale=1.2))
    return trk, mapper


TORCH, JAX = (ttr, tms, tlm), (jtr, jms, jlm)


def _service(trk, mapper, nk):
    if len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
        r = mapper.run(trk.new_kf_slots[-1])
        trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        trk.add_active(r["new_lm_ids"])


def _batched(pkg, front_cls, scenes):
    pairs = [_pair(pkg, sc) for sc in scenes]
    front = front_cls([p[0] for p in pairs])
    for f in range(N):
        nks = [len(p[0].new_kf_slots) for p in pairs]
        front.track([sc.frames[f] for sc in scenes])
        for (trk, mapper), nk in zip(pairs, nks):
            _service(trk, mapper, nk)
    front.flush()
    return pairs, front


def _solo(pkg, scene):
    trk, mapper = _pair(pkg, scene)
    for f in range(N):
        nk = len(trk.new_kf_slots)
        trk.track(*scene.frames[f])
        _service(trk, mapper, nk)
    trk.flush()
    return trk


@pytest.fixture(scope="module")
def runs(scenes):
    return {
        "solo": [_solo(TORCH, sc) for sc in scenes],
        "jax_solo": {s: _solo(JAX, scenes[s]) for s in sorted({s for s, _ in OVER_JAX_TOL})},
        "torch": _batched(TORCH, tms_seq.BatchedStereoFrontend, scenes),
        "jax": _batched(JAX, jms_seq.BatchedStereoFrontend, scenes),
    }


def test_extract_batch_of_2s_views_matches_each_pair_and_jax(scenes):
    """The 2S views of a batched frame [L0, R0, L1, R1, ...] in one
    extraction: every field equals each pair's own extraction exactly;
    against JAX's extract_batch on the same views, the keypoints are exact,
    the angles within 1e-4 rad and >= 99% of the descriptors identical
    (tests/test_torch_extract.py:283-306)."""
    views = np.stack([v for sc in scenes for v in sc.frames[1]]).astype(np.float32)
    kw = dict(n_levels=4, scale=1.2, total=512, edge_margin=19, fast_hi=20.0, fast_lo=7.0)
    t = text.extract_batch(torch.from_numpy(views), **kw)
    for s in range(S):
        own = text.extract_batch(torch.from_numpy(views[2 * s : 2 * s + 2]), **kw)
        for name, a, b in zip(text.Keys._fields, t, own):
            assert torch.equal(a[2 * s : 2 * s + 2], b), (s, name)
    j = jext.extract_batch(jnp.asarray(views), **kw)
    for name in ("xy", "octave", "valid", "response"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    valid = t.valid.numpy()
    assert valid.sum() > 250 * 2 * S
    np.testing.assert_allclose(t.angle.numpy()[valid], np.asarray(j.angle)[valid], atol=1e-4, rtol=0)
    dbits = (t.desc.numpy() != np.asarray(j.desc)).sum(axis=-1)[valid]
    assert (dbits == 0).mean() >= 0.99 and dbits.max() <= 2, np.bincount(dbits)


def test_batched_matches_solo_runs(scenes, runs):
    """Each sequence of the batch against its own solo run of the port
    (tests/test_parallel.py:224-296): the same keyframe slots, the same
    poses (within 1e-6 m), ATE under 0.04 m."""
    pairs, front = runs["torch"]
    assert front.metrics.summary()["track"]["count"] == N - 1
    for s, ((trk, _), solo) in enumerate(zip(pairs, runs["solo"])):
        batched = trk.trajectory()
        assert trk.new_kf_slots == solo.new_kf_slots, s
        assert len(batched) == N
        np.testing.assert_allclose(batched, solo.trajectory(), atol=SOLO_TOL_M, rtol=0)
        ate = ttraj.ate_rmse(batched, scenes[s].poses_c2w[:N], align=False)
        assert ate < ATE_GATE_M, (s, ate)


def _gaps(a, b) -> np.ndarray:
    """Per-frame largest translation difference of two trajectories."""
    return np.abs(a[:, :3, 3] - b[:, :3, 3]).max(axis=1)


def test_batched_matches_jax_batched(runs):
    """The port's batch against vslam_tpu's BatchedStereoFrontend on the
    same frames: the same keyframes at the same frames, the same BA count,
    poses within 1e-3 m on every frame but OVER_JAX_TOL's, and there the
    solo runs' own gap (the batch adds at most BATCH_ADDS_M)."""
    over = set()
    for s, ((tt, tm), (jt, jm)) in enumerate(zip(runs["torch"][0], runs["jax"][0])):
        assert tt.new_kf_slots == jt.new_kf_slots, s
        n_kf = jt.world.n_keyframes
        np.testing.assert_array_equal(tt.world.kf_frame_idx[:n_kf], jt.world.kf_frame_idx[:n_kf])
        assert tm.ba_count == jm.ba_count, (s, tm.ba_count, jm.ba_count)
        gap = _gaps(tt.trajectory(), jt.trajectory())
        assert np.isfinite(gap).all() and len(gap) == N
        over |= {(s, int(f)) for f in np.flatnonzero(gap > JAX_TOL_M)}
        for f in range(N):
            if (s, f) in OVER_JAX_TOL:
                solo = _gaps(runs["solo"][s].trajectory(), runs["jax_solo"][s].trajectory())[f]
                assert solo > JAX_TOL_M and abs(gap[f] - solo) <= BATCH_ADDS_M, (s, f, gap[f], solo)
    assert over <= OVER_JAX_TOL, over


def test_frontend_gap_is_jax_fusion(scenes):
    """The cause of OVER_JAX_TOL, on sequence 1's 10 frames: the port's
    tracker._frontend gives exactly the stereo matches (idx_r) of JAX's
    eager match_stereo run on JAX's own extraction of the same pair, on
    every frame; JAX's jitted _frontend (extraction and matching as one
    XLA program, vslam_tpu/models/tracker.py:155-184) matches another set
    on at least one frame (the fused program rounds the SAD sums
    differently; ROADMAP.md queue C)."""
    sc = scenes[1]
    trk_t, trk_j = _pair(TORCH, sc)[0], _pair(JAX, sc)[0]
    p = trk_t.params
    kw = dict(n_levels=p.n_levels, scale=p.scale, total=p.n_features, edge_margin=p.edge_margin,
              fast_hi=p.fast_hi, fast_lo=p.fast_lo)
    fx, bl, sf = trk_j.K[0, 0], trk_j.baseline, trk_j.scale_factors
    counts, fused_differs = [], []
    for f in range(N):
        LR = np.stack(sc.frames[f]).astype(np.float32)
        _, st = ttr._frontend(torch.from_numpy(LR), trk_t.K[0, 0], trk_t.baseline, trk_t.scale_factors, p)
        keys = jext.extract_batch(jnp.asarray(LR), **kw)
        kl, kr = (jext.Keys(*(a[i] for a in keys)) for i in (0, 1))
        eager = jsm.match_stereo(LR[0], LR[1], kl.xy, kl.octave, kl.desc, kl.valid, kr.xy, kr.octave,
                                 kr.desc, kr.valid, fx, bl, sf, close_factor=p.close_factor)
        idx_r = st["idx_r"].numpy()
        np.testing.assert_array_equal(idx_r, np.asarray(eager["idx_r"]), err_msg=f"frame {f}")
        _, fused = jtr._frontend(LR[0], LR[1], fx, bl, sf, trk_j._static)
        fused_idx = np.asarray(fused["idx_r"])
        counts.append((int((idx_r >= 0).sum()), int((fused_idx >= 0).sum())))
        fused_differs.append(not np.array_equal(fused_idx, idx_r))
    assert any(fused_differs), counts


def test_frontend_checks_its_sequences():
    """The constructor's checks (vslam_tpu/parallel/multi_seq.py:52-73):
    shapes and modes must agree."""
    sc = synthetic.make_scene(n_frames=1, n_points=50, width=320, height=240, seed=1)
    a = _pair(TORCH, sc)[0]
    world = tms.WorldMap(**{**WORLD, "keys_per_kf": 256}, device="cpu")
    b = ttr.StereoTracker(sc.K.astype(np.float32), sc.baseline, 320, 240, world,
                          ttr.TrackerParams(**{**PARAMS, "n_features": 256}), device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        tms_seq.BatchedStereoFrontend([a, b])
    with pytest.raises(ValueError):
        tms_seq.BatchedStereoFrontend([])

