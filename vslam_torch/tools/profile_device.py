"""Device-time breakdown of the three largest device programs: the port of
the JAX repo's tools/profile_device.py.

    python -m vslam_torch.tools.profile_device

On the bench scene (24 frames) after the shared warm-up: the track step
(``tracker._track_step`` on frame 9, as the roofline runs it), the fused
local BA (``schur.local_ba_two_rounds`` on ``mapper._assemble`` of the
newest keyframe) and triangulation with its finish
(``_dispatch_triangulation``, ``_finish_triangulation``, the spawn budget
returned with ``world.release_landmarks``). The JAX tool estimated device
time as blocked time less a scalar round trip; here each row has the
profiler's device busy per call beside its blocked wall. Prints one line
per row and one JSON line.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.ops import schur
from vslam_torch.tools import _common, roofline

N_FRAMES = 24


def run(reps: int = 10) -> list:
    _common.require_card("profile_device")
    scene = _common.bench_scene(N_FRAMES)
    frames = _common.scene_frames(scene)
    dev = torch.device("cuda")
    staged = [torch.from_numpy(f).to(dev) for f in frames]
    trk, mapper = _common.make_tracker(scene, dev)
    _common.warm_up(trk, mapper, staged)
    step, _ = roofline.track_step_stage(trk, staged[roofline.FRAME].to(torch.float32))
    slot = trk.new_kf_slots[-1]
    prob = mapper._assemble(slot)[0]

    def tri():
        ids = mapper._finish_triangulation(mapper._dispatch_triangulation(slot))
        mapper.world.release_landmarks(np.asarray(ids))  # return the spawn budget
        return len(ids)

    rows = []
    for name, fn, n in (("track_step", step, reps),
                        ("local_ba fused (2 rounds)", lambda: schur.local_ba_two_rounds(prob), min(reps, 5)),
                        ("triangulate+finish", tri, min(reps, 5))):
        rows.append({"stage": name, **_common.measure(fn, n)})
        r = rows[-1]
        print(f"{name:26s}: blocked {r['blocked_ms']:8.3f} ms  device busy {r['device_busy_ms']:8.3f} ms "
              f"(device {r['device_ms']:.4f}, {r['device_method']}) launches={r['launches']} "
              f"syncs={r['syncs']}", flush=True)
    mapper.close()
    return rows


def main(reps: int = 10) -> dict:
    return _common.emit("profile_device", run(reps))


if __name__ == "__main__":
    main()
