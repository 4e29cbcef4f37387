"""Distributed local/global bundle adjustment over a device mesh (port of
vslam_tpu/parallel/sharded_ba.py).

The Schur-complement reduced camera system is a sum over landmarks of
per-landmark outer products, and the blocked normal equations a sum over
observations of per-observation outer products, so sharding the
observation rows over the mesh makes each shard linearize only its own
slice, and the dominant O(W^2 L) reduction shards over landmark slabs.
Poses and landmarks stay replicated, as does the 6W x 6W dense solve.

This wraps the SAME solver the single-device mapper runs
(:func:`vslam_torch.ops.schur.local_ba_two_rounds` with ``mesh``), so the
sharded solve keeps the full semantics (LM accept/reject on the summed
errors, the relativeErrorTol early exit, the 2-round chi-squared sweep)
and matches the single-device result to float reduction order.
"""

from __future__ import annotations

from vslam_torch.ops import schur


def sharded_two_rounds(mesh, iters1: int = 5, iters2: int = 10, n_slabs: int = 1):
    """The sharded 2-round local BA over `mesh`, as a function of the 16
    BAProblem fields (and an optional ``stats`` list that receives each
    round's iteration count). All inputs are replicated; the sharding is
    over the computation (observation rows, then landmark slabs). Returns
    (poses, pts, err, kill). `n_slabs > 1` also chunks the reduction over
    global landmark slabs (the map-scale composition); the landmark slots
    must divide by n_slabs x the mesh size."""

    def run(poses, fixed, pose_valid, pts, pt_valid,
            obs_kf, obs_lm, obs_uv, obs_stereo, obs_right, obs_w, obs_valid,
            K, baseline, odo_rel, odo_valid, stats=None):
        p = schur.BAProblem(
            poses=poses, fixed=fixed, pose_valid=pose_valid, pts=pts, pt_valid=pt_valid,
            obs_kf=obs_kf, obs_lm=obs_lm, obs_uv=obs_uv, obs_stereo=obs_stereo,
            obs_right=obs_right, obs_w=obs_w, obs_valid=obs_valid, K=K, baseline=baseline,
            odo_rel=odo_rel, odo_valid=odo_valid,
        )
        p2, err, kill = schur.local_ba_two_rounds(
            p, iters1=iters1, iters2=iters2, mesh=mesh, n_slabs=n_slabs, stats=stats
        )
        return p2.poses, p2.pts, err, kill

    return run


def run_problem(step_fn, p: schur.BAProblem, stats: list | None = None):
    """Apply a :func:`sharded_two_rounds` function to a BAProblem.
    Returns (p2, err, kill) exactly like ``schur.local_ba_two_rounds``."""
    poses, pts, err, kill = step_fn(*p, stats=stats)
    return p._replace(poses=poses, pts=pts), err, kill
