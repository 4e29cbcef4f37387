"""The port's measuring tools, the counterparts of the JAX repo's
``tools/`` scripts, each run on the card as ``python -m
vslam_torch.tools.<name>``:

- ``roofline``: the per-stage speed-of-light audit of one tracked frame;
- ``profile_rtt``: the card's per-call costs (fetch, launch, sync, upload);
- ``profile_extract``: the extraction sub-ops on one 752x480 image;
- ``profile_solver``: motion-only LM and projection matching alone;
- ``profile_frame``: upload, a tracked frame, ``LocalMapper.run``, the
  frontend and one extraction;
- ``profile_device``: the track step, the fused local BA and the
  triangulation, each with its device busy time;
- ``profile_bench``: per-frame wall of the bench loop with KF/BA markers;
- ``profile_depth``: pipeline depth 1 against 2, no BA;
- ``measure_ba_scaling``: LM iterations/s of the sharded BA on 1-8 shards;
- ``ab_kf_policy``: the keyframe-policy knobs on the bench scene.

``counts`` holds the hand FLOP and byte model the roofline's bounds come
from. Each tool prints its lines, then one JSON line with its rows and the
card's name and power limit. With no CUDA card a tool raises (only
``measure_ba_scaling --device cpu`` runs on the CPU, as its JAX
counterpart did).
"""
