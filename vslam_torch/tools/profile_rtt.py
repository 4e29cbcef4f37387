"""The card's per-call costs, host side: the port of the JAX repo's
tools/profile_rtt.py.

    python -m vslam_torch.tools.profile_rtt

Per call, on the host's clock: ``.item()`` of a device scalar; ``.cpu()``
of 48 KB; a trivial op enqueued 50 times then one synchronize (the host
cost of one launch); the same op with a synchronize after each; a 16 KB
upload with a synchronize; upload + op + fetch (a miniature tracked
frame). Times a tracked frame's ~14-17k launches by the first, it is the
frame's launch floor. Prints one line per probe and one JSON line.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vslam_torch.tools import _common


def probes() -> dict:
    """The probes as closures on the card, by name: each makes one call."""
    dev = torch.device("cuda")
    x = torch.tensor(1.5, device=dev)
    big = torch.zeros(4096 * 3, dtype=torch.float32, device=dev)
    h = np.zeros(4096, np.int32)

    def trivial():
        return x + 1.0

    return {
        "fetch scalar (.item())": lambda: x.item(),
        "fetch 48KB (.cpu())": lambda: big.cpu(),
        "dispatch async (per call of 50)": trivial,
        "dispatch sync": lambda: (trivial(), torch.cuda.synchronize()),
        "upload 16KB sync": lambda: (torch.from_numpy(h).to(dev), torch.cuda.synchronize()),
        "up+prog+fetch": lambda: (torch.from_numpy(h).to(dev), trivial().cpu()),
    }


def run(reps: int = 50) -> list:
    """Each probe `reps` times after a warm-up; ms per call. The async
    dispatch probe synchronizes once after its `reps` calls, inside the
    timed window."""
    _common.require_card("profile_rtt")
    rows = []
    for name, fn in probes().items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if name.startswith("dispatch async"):
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        rows.append({"probe": name, "ms_per_call": ms, "calls": reps})
        print(f"{name:32s}: {ms:8.4f} ms", flush=True)
    return rows


def main(reps: int = 50) -> dict:
    return _common.emit("profile_rtt", run(reps))


if __name__ == "__main__":
    main()
