"""fps (frames/s): every frame that track_stereo returned in the window,
over the window's seconds (drive starts, their facade builds and the final
device sync included)."""


def read(rec: dict):
    return rec["frames"] / rec["window_s"] if rec["window_s"] > 0 else None
