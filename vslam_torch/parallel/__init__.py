"""Multi-sequence and multi-device execution (port of vslam_tpu/parallel):
S sequences tracked as one batched frame step (:mod:`multi_seq`), and the
window and global bundle adjustment sharded over a mesh of devices
(:mod:`mesh`, :mod:`sharded_ba`)."""
