"""frame_p90_ms (ms): the 90th percentile, over every frame of the window,
of the host wall from the call of track_stereo to its return (a keyframe's
frame includes its synchronous local BA)."""

import numpy as np


def read(rec: dict):
    walls = rec["frame_walls_s"]
    return float(np.percentile(walls, 90)) * 1e3 if walls else None
