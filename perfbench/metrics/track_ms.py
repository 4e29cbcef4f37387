"""track_ms (ms): the tracker's own span, StageTimer "track" of each
drive's StereoTracker (models/tracker), total over count, summed over the
window's drives."""


def read(rec: dict):
    s = rec["spans"].get("track")
    return 1e3 * s["total_s"] / s["count"] if s and s["count"] else None
