"""Checkpoints of the port's training state, in the JAX package's format
(port of ``ttamm_tpu/train/checkpoint.py``, flat ``.npz`` only).

One ``.npz`` holds every leaf of the JAX ``TrainState`` under its pytree-path
key (``tables/user_id``, ``dense/.../w``, ``opt_dense/m/...``,
``opt_sparse/user_id/m``, ``step``; see ``ttamm_torch.models.convert``)
plus a JSON ``__meta__`` entry (epoch, metric, timestamp). So
``ttamm_tpu.train.checkpoint.load_checkpoint`` restores a port checkpoint,
this module restores a JAX one, and ``python -m
ttamm_torch.pipelines.export --checkpoint`` reads both.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from ..models.convert import train_state_from_flat, train_state_to_flat
from .state import TrainState


def checkpoint_filename(
    template: str | None,
    *,
    experiment_name: str,
    metric_name: str | None,
    metric_value: float | None,
    epoch: int,
) -> str:
    """The JAX package's (and the reference's) filename templating; ``@``
    and ``/`` in metric names are sanitised."""
    safe_metric = (metric_name or "metric").replace("@", "at").replace("/", "_")
    value = metric_value if metric_value is not None else 0.0
    return (template or "{experiment}_{metric}_epoch{epoch}.pt").format(
        experiment=experiment_name, metric=safe_metric, value=value, epoch=epoch
    )


def save_checkpoint(
    directory: Path | str,
    state: TrainState | Mapping[str, np.ndarray],
    *,
    experiment_name: str,
    epoch: int,
    metric_name: str | None,
    metric_value: float | None,
    template: str | None = None,
) -> Path:
    """Write ``state`` (pulled to the host), or its flat host arrays from
    ``train_state_to_flat`` (so several files share one pull), to
    ``directory``; returns the file's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / checkpoint_filename(
        template, experiment_name=experiment_name, metric_name=metric_name,
        metric_value=metric_value, epoch=epoch,
    )
    arrays = dict(state) if isinstance(state, Mapping) else train_state_to_flat(state)
    meta = {
        "epoch": epoch,
        "metric_name": metric_name,
        "metric_value": metric_value,
        "timestamp": time.time(),
        "format_version": 1,
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as handle:
        np.savez(handle, **arrays)
    return path


def load_checkpoint(
    path: Path | str, template_state: TrainState
) -> tuple[TrainState, dict[str, Any]]:
    """Restore a checkpoint (the port's or the JAX package's flat ``.npz``)
    into ``template_state`` (built by ``create_train_state`` for the same
    config), in place; returns it and the metadata."""
    with np.load(Path(path), allow_pickle=False) as blob:
        meta = json.loads(bytes(blob["__meta__"]).decode("utf-8"))
        train_state_from_flat(template_state, blob)
    return template_state, meta
