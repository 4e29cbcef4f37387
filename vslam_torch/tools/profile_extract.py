"""The extraction sub-ops on the card: the port of the JAX repo's
tools/profile_extract.py.

    python -m vslam_torch.tools.profile_extract

One 752x480 image from ``np.random.default_rng(0)``: the uploads (16 B,
722 KB) and a scalar round trip; the 8-level pyramid; ``fast_score``,
``fast_score`` + ``nms3x3`` and ``detect`` on level 0; the level-0 blur;
``orientations`` and ``brief_descriptors`` at 256 keys; the full
single-image ``extract.extract``; and detection alone over all 8 levels.
Each row: device ms (and how it was taken), dispatch ms, blocked ms,
kernel launches and host syncs (``tools/_common.measure``). Prints one
line per row and one JSON line.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_torch.ops import extract, fast, orb, pyramid
from vslam_torch.tools import _common

H, W = 480, 752
N_LEVELS, SCALE, TOTAL = 8, 1.2, 1024


def inputs(seed: int = 0) -> dict:
    """The tool's numpy inputs: the f32 image, a 16 B array and a uint8
    stereo pair, in the JAX tool's draw order."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    tiny = np.zeros(4, np.float32)
    pair = rng.uniform(0, 255, (2, H, W)).astype(np.uint8)
    return {"img": img, "tiny": tiny, "pair": pair}


def detect_l0(img: torch.Tensor):
    """Level-0 detection as the JAX tool calls it (256 keys, cell 35)."""
    return fast.detect(img[None], 20.0, 7.0, cell=35, max_keypoints=256, edge_margin=19)


def detect_all_levels(img: torch.Tensor) -> list:
    """Pyramid + FAST + ANMS on every level with a quota (no description),
    at the JAX tool's per-level cell and margin."""
    out = []
    for im_l, q in zip(pyramid.build_pyramid(img, N_LEVELS, SCALE), extract.level_quotas(TOTAL, N_LEVELS, SCALE)):
        if q <= 0:
            continue
        h, w = im_l.shape
        out.append(fast.detect(im_l[None], 20.0, 7.0, cell=min(35, max(h, w)), max_keypoints=q,
                               edge_margin=min(19, min(h, w) // 4)))
    return out


def stages(x: dict, device) -> dict:
    """The compute rows as closures on `device`, by name, each returning
    its output."""
    dev = torch.device(device)
    img = torch.from_numpy(x["img"]).to(dev)
    blurred = pyramid.gaussian_blur(img)
    xy = detect_l0(img)[0][0]
    ang = orb.orientations(blurred, xy)
    return {
        "pyramid x8": lambda: pyramid.build_pyramid(img, N_LEVELS, SCALE),
        "fast L0": lambda: fast.fast_score(img[None], 7.0),
        "fast+nms L0": lambda: fast.nms3x3(fast.fast_score(img[None], 7.0)),
        "detect L0 (score+nms+topk)": lambda: detect_l0(img),
        "blur L0": lambda: pyramid.gaussian_blur(img),
        "orient 256": lambda: orb.orientations(blurred, xy),
        "brief 256": lambda: orb.brief_descriptors(blurred, xy, ang),
        "extract full": lambda: extract.extract(img, n_levels=N_LEVELS, scale=SCALE, total=TOTAL,
                                                edge_margin=19, fast_hi=20.0, fast_lo=7.0),
        "detect x8 (pyramid+fast+topk)": lambda: detect_all_levels(img),
    }


def run(reps: int = 20) -> list:
    _common.require_card("profile_extract")
    x = inputs()
    dev = torch.device("cuda")
    one = torch.tensor(1.0, device=dev)
    transfers = {
        "upload 16B": lambda: torch.from_numpy(x["tiny"]).to(dev),
        "upload 722KB": lambda: torch.from_numpy(x["pair"]).to(dev),
        "roundtrip (op + fetch scalar)": lambda: torch.sin(one).cpu(),
    }
    rows = []
    for name, fn in {**transfers, **stages(x, dev)}.items():
        rows.append({"stage": name, **_common.measure(fn, reps)})
        r = rows[-1]
        print(f"{name:32s}: dev={r['device_ms']:8.4f} ms ({r['device_method']}) "
              f"disp={r['dispatch_ms']:7.3f} blk={r['blocked_ms']:8.3f} launches={r['launches']} "
              f"syncs={r['syncs']}", flush=True)
    return rows


def main(reps: int = 20) -> dict:
    return _common.emit("profile_extract", run(reps))


if __name__ == "__main__":
    main()
