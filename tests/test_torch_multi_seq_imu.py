"""The port's stereo-inertial multi-sequence batch on the CPU
(tests/test_parallel.py:399-470's shapes: 2 sequences x 8 frames, seeds
7 + 5s, per-sequence IMU constants, per-frame sample bins padded to the
longest): against the port's own solo runs (1e-6 m, ATE < 0.04 m) and
against vslam_tpu's BatchedStereoFrontend (the same keyframe slots, poses
within 1e-3 m). The helpers are tests/test_torch_multi_seq_inertial.py's."""

import pytest

from tests.test_torch_multi_seq_inertial import batch_runs, check_jax, check_solo


@pytest.fixture(scope="module")
def runs():
    return batch_runs("stereo_imu")


def test_stereo_imu_batch_matches_solo_runs(runs):
    check_solo(runs)


def test_stereo_imu_batch_matches_jax_batch(runs):
    check_jax(runs)
