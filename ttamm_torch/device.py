"""Device resolution and the process-wide float settings of the port.

"float32" in this package means full float32 on the card: the exact,
FAISS-parity scoring mode. PyTorch would let a float32 matmul or convolution
run in TF32 (about three decimal digits) when these flags are on, so this
module — the one place that owns them — turns both off when it is imported,
and every entry point of the package imports it.

On the CPU, PyTorch sends ``sqrt``, ``exp``, ``log``, ``tanh`` (and ``erf``,
``sin`` and the rest of MKL's vector math, VML) to MKL split over its
threads, at least 2048 elements a thread. When several threads make a
process's first VML call at once, MKL can return one thread's part at 12
to 15 correct bits (PyTorch 2.13, MKL 2024.2;
``scripts/torch_vml_first_call.py`` counts it). So this module also makes
the process's first VML call itself when it is imported: a square root of
16 values, below PyTorch's 2048-element grain, runs on this thread alone.
The card's math is untouched.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.sqrt(torch.ones(16))


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the ``torch.device`` to run on.

    ``None`` means ``cuda``: the port runs on the card unless the caller asks
    for the CPU by name. A CUDA device is required to exist: asking for it
    on a machine without one raises instead of running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type: {dev.type}")
    return dev


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device`` without a host sync: on a card through
    pinned memory and a copy that does not block the host (the caching host
    allocator keeps the pinned block until the copy has run), on the CPU as
    a tensor over the array."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)
