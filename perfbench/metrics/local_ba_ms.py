"""local_ba_ms (ms): the local mapper's span, StageTimer "run" of each
drive's LocalMapper (models/local_mapper, ops/schur): triangulation,
window assembly, the two-round BA and the write-back, total over count,
summed over the window's drives. Nothing when no BA ran in the window."""


def read(rec: dict):
    s = rec["spans"].get("run")
    return 1e3 * s["total_s"] / s["count"] if s and s["count"] else None
