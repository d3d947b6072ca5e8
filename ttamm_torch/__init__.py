"""ttamm_torch — the PyTorch/CUDA port of ttamm_tpu for NVIDIA Hopper.

Serving, training and the retrieval eval on one card: towers and
adaptive-mimic tables as ``nn.Module``s, the training step (negative
sampling, BCE + mimic + category-alignment losses, dense AdamW and
sparse-row Adam), checkpoints in the JAX package's format, the trainer with
its per-epoch eval, early stopping and best-only checkpoints, corpus
encoding, exact (and masked) MIPS top-k, the TTFLAT1 flat index, the
retrieval service and its HTTP front end, and the bundle export. Every TPU
kernel on those paths is a hand-written CUDA
kernel (``csrc/``, bound in ``ops/kernels.py``). The package imports
``torch`` and never ``jax`` or ``ttamm_tpu``: it carries its own copy of the
host-side data, config and HTTP layers. Entry points run on the CUDA card
unless the caller asks for the CPU.
"""

from . import device  # noqa: F401  (float32 matmul flags; the first CPU vector-math call)

__version__ = "0.3.0"
