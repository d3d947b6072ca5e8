"""Process-group start-up for multi-device runs (port of
``ttamm_tpu/parallel/launch.py``).

``torchrun --nproc_per_node N -m ttamm_torch.train ...`` starts one process
per device and describes the job in the environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
:func:`maybe_initialize_distributed` joins that job: NCCL for a CUDA device
(each process on ``cuda:LOCAL_RANK``), gloo for the CPU. A failed start
raises; there is no single-process fallback that would hide the devices.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

logger = get_logger("parallel")

DEFAULT_TIMEOUT_SECONDS = 600.0


def world_size_from_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def maybe_initialize_distributed(device: torch.device) -> torch.device:
    """Join the job torchrun describes when it has more than one process
    (or a process group exists already); returns this process's device:
    ``cuda:LOCAL_RANK`` for a CUDA ``device``, else ``device``. Every
    collective of the group fails after ``DEFAULT_TIMEOUT_SECONDS`` instead
    of hanging when another rank has died."""
    if device.type == "cuda" and (dist.is_initialized() or world_size_from_env() > 1):
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized() or world_size_from_env() <= 1:
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, timeout=timedelta(seconds=DEFAULT_TIMEOUT_SECONDS),
        **({"device_id": device} if device.type == "cuda" else {}),
    )
    logger.info(
        "Process group up: rank %d/%d (%s) on %s",
        dist.get_rank(), dist.get_world_size(), backend, device,
    )
    return device


def is_primary_host() -> bool:
    """True on the process that writes artifacts and prints results."""
    return not dist.is_initialized() or dist.get_rank() == 0
