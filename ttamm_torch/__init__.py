"""ttamm_torch — the PyTorch/CUDA port of ttamm_tpu for NVIDIA Hopper.

The serving slice: towers and adaptive-mimic tables as eval-mode
``nn.Module``s, corpus encoding, exact MIPS top-k (``ops/topk.py``) over
hand-written CUDA kernels (``csrc/``), the TTFLAT1 flat index, the
retrieval service and the bundle export. The package imports ``torch`` and
never ``jax``; the JAX package's host-side layers (data, config, HTTP
front end), which are free of JAX, are reused by import.
"""

from . import device  # noqa: F401  (sets the float32 matmul precision flags)

__version__ = "0.1.0"
