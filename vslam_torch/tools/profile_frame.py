"""Per-stage timing of the tracking loop on the card: the port of the JAX
repo's tools/profile_frame.py.

    python -m vslam_torch.tools.profile_frame

On the bench scene (30 frames) after the shared warm-up (8 frames tracked
and mapped): the upload of one stereo pair; a tracked frame end to end as
the pipelined loop runs it (frame 10 again and again; ``track`` reads the
host itself); one ``LocalMapper.run`` on the newest keyframe; the
frontend alone (``tracker._frontend``: extraction of both images and
stereo matching); one single-image ``extract.extract``. Each row: device
ms (and how it was taken), dispatch ms, blocked ms, kernel launches and
host syncs. Prints one line per row and one JSON line.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.models import tracker
from vslam_torch.ops import extract
from vslam_torch.tools import _common

N_FRAMES = 30


def run(reps: int = 20, mapper_reps: int = 5) -> list:
    _common.require_card("profile_frame")
    scene = _common.bench_scene(N_FRAMES)
    frames = _common.scene_frames(scene)
    dev = torch.device("cuda")
    staged = [torch.from_numpy(f).to(dev) for f in frames]
    trk, mapper = _common.make_tracker(scene, dev)
    _common.warm_up(trk, mapper, staged)
    p = trk.params
    LR_np = np.ascontiguousarray(frames[8])
    LR = staged[8].to(torch.float32)
    kw = dict(n_levels=p.n_levels, scale=p.scale, total=p.n_features, edge_margin=p.edge_margin,
              fast_hi=p.fast_hi, fast_lo=p.fast_lo)
    rows = []

    def add(name, fn, n):
        rows.append({"stage": name, **_common.measure(fn, n)})
        r = rows[-1]
        print(f"{name:34s}: dev={r['device_ms']:9.4f} ms ({r['device_method']}) "
              f"disp={r['dispatch_ms']:8.3f} blk={r['blocked_ms']:8.3f} launches={r['launches']} "
              f"syncs={r['syncs']}", flush=True)

    add("upload", lambda: torch.from_numpy(LR_np).to(dev), reps)
    add("frame e2e (pipelined)", lambda: trk.track(staged[10]), reps)
    trk.flush()
    slot = trk.new_kf_slots[-1]
    add("mapper.run (triangulate + BA + write-back)", lambda: mapper.run(slot), mapper_reps)
    add("frontend (extract x2 + stereo match)",
        lambda: tracker._frontend(LR, trk.K[0, 0], trk.baseline, trk.scale_factors, p), reps)
    add("extract1 (one image)", lambda: extract.extract(LR[0], **kw), reps)
    mapper.close()
    return rows


def main(reps: int = 20) -> dict:
    return _common.emit("profile_frame", run(reps))


if __name__ == "__main__":
    main()
