"""vslam_torch — the PyTorch + CUDA port of vslam_tpu.

The JAX package ``vslam_tpu`` is the reference; this package mirrors its
layout and names (``geometry/``, ``ops/``, ``models/``, ``utils/``,
``parallel/``) so each module's counterpart is easy to find, and adds
``kernels/`` for the CUDA sources and their loader.

Rules of the port:
- tensors live on the device the caller names (``StereoTracker`` and
  ``WorldMap`` take an explicit ``device``); nothing picks a device on its
  own, and nothing falls back from the GPU to the CPU;
- every Pallas kernel of the reference is a hand-written CUDA kernel here
  (``kernels/csrc``), with a plain PyTorch version beside it that serves
  CPU tensors and is the kernel's parity oracle;
- ``vmap`` becomes an explicit batch dimension, ``lax.while_loop`` a Python
  loop, ``shard_map`` a Python loop over the mesh's shards with explicit
  collectives, and ``jit`` has no counterpart;
- this package never imports ``jax``.
"""

__version__ = "0.1.0"

import torch as _torch

# Same rationale as vslam_tpu/__init__.py: the geometry and LM code does
# many tiny matrix products whose accuracy matters for convergence, and the
# gather/one-hot-free paths must stay exact. TF32 would break both.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from vslam_torch.utils.config import ConfigFile, SlamMode  # noqa: E402,F401
