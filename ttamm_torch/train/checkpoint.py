"""Checkpoints of the port's training state, in the JAX package's format
(port of ``ttamm_tpu/train/checkpoint.py``), and the background writer of
``checkpointing.async_save`` (:class:`AsyncCheckpointer`).

One ``.npz`` holds every leaf of the JAX ``TrainState`` under its pytree-path
key (``tables/user_id``, ``dense/.../w``, ``opt_dense/m/...``,
``opt_sparse/user_id/m``, or ``opt_sparse/user_id/mv`` for packed moments,
``step``; see ``ttamm_torch.models.convert``) plus a JSON ``__meta__`` entry
(epoch, metric, timestamp). Either moment layout loads into either. So
``ttamm_tpu.train.checkpoint.load_checkpoint`` restores a port checkpoint,
this module restores a JAX one, and ``python -m
ttamm_torch.pipelines.export --checkpoint`` reads both. The per-process
sharded directories are ``ttamm_torch/train/sharded_checkpoint.py``.
"""

from __future__ import annotations

import json
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

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


def checkpoint_path(
    directory: Path | str,
    *,
    experiment_name: str,
    epoch: int,
    metric_name: str | None,
    metric_value: float | None,
    template: str | None = None,
) -> Path:
    """Where :func:`save_checkpoint` (or the sharded save) writes under
    these names."""
    return Path(directory) / checkpoint_filename(
        template, experiment_name=experiment_name, metric_name=metric_name,
        metric_value=metric_value, epoch=epoch,
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
    Path(directory).mkdir(parents=True, exist_ok=True)
    path = checkpoint_path(
        directory, experiment_name=experiment_name, metric_name=metric_name,
        metric_value=metric_value, epoch=epoch, template=template,
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
        write_npz(handle, arrays)
    return path


def write_npz(handle, arrays: Mapping[str, np.ndarray]) -> None:
    """``np.savez(handle, **arrays)``: the same zip of ``<key>.npy`` members
    (stored, zip64), each array's bytes handed to the zip as they lie in
    memory. ``np.savez`` copies every 16 MB of an array into a bytes object
    while it holds the interpreter lock; here the only work on the data,
    the zip's CRC and the file writes, releases it, so a background writer
    leaves the training loop's Python free."""
    with zipfile.ZipFile(handle, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, value in arrays.items():
            arr = np.asanyarray(value)
            if not (arr.flags.c_contiguous or arr.flags.f_contiguous):
                arr = np.ascontiguousarray(arr)
            header = np.lib.format.header_data_from_array_1_0(arr)
            data = arr.T if header["fortran_order"] else arr  # C-ordered either way
            with zf.open(key + ".npy", "w", force_zip64=True) as member:
                np.lib.format.write_array_header_1_0(member, header)
                member.write(memoryview(data.reshape(-1)).cast("B"))


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


class AsyncCheckpointer:
    """Writes an epoch's checkpoints on a background thread while the next
    epoch trains (the JAX ``AsyncCheckpointer``).

    :meth:`submit` takes a snapshot that nothing writes any more: a clone of
    the training state on its device (the best-state copy of an improved
    epoch serves as one), or host arrays the caller already pulled (the flat
    format on a mesh gathers the state over the ranks, a collective that
    stays on the main thread). The writer pulls a clone on a stream of its
    own, after an event recorded behind the clone on the caller's stream,
    into pinned host buffers that every later save reuses: so the pull
    neither waits for the next epoch's kernels nor holds them up. Then it
    writes each job's file, flat or (``sharded=True``) this rank's shard
    directory under ``mesh``.

    Each submit starts one thread that first joins the one before it, so
    writes to the same file (``{experiment}_last.pt``) stay in order, and a
    pending write completes even if the caller raises (the threads are not
    daemons). :meth:`wait` joins them and raises the first failure.
    """

    def __init__(self, *, sharded: bool = False, mesh=None) -> None:
        self._sharded = sharded
        self._mesh = mesh
        self._last: threading.Thread | None = None
        self._errors: list[Exception] = []
        self._stream: torch.cuda.Stream | None = None
        self._pinned: dict[str, torch.Tensor] = {}

    def submit(self, snapshot, jobs: list[dict[str, Any]]) -> list[Path]:
        """Queue ``snapshot`` to be written under each job (the keyword
        arguments of :func:`save_checkpoint` but the state); returns the
        files' paths at once."""
        paths = [checkpoint_path(**job) for job in jobs]
        ready = None
        if not isinstance(snapshot, Mapping) and snapshot.tables["user_id"].is_cuda:
            dev = snapshot.tables["user_id"].device
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=dev)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))  # behind the clone
        prev = self._last

        def work() -> None:
            if prev is not None:
                prev.join()
            try:
                host = self._host(snapshot, ready)
                for job in jobs:
                    if self._sharded:
                        from .sharded_checkpoint import save_sharded_checkpoint

                        save_sharded_checkpoint(host_pieces=host, mesh=self._mesh, **job)
                    else:
                        save_checkpoint(state=host, **job)
            except Exception as exc:  # raised by wait()
                self._errors.append(exc)

        self._last = threading.Thread(target=work, name="ttamm-ckpt-writer", daemon=False)
        self._last.start()
        return paths

    def wait(self) -> None:
        """Block until every submitted write is on disk; raise the first
        failure."""
        if self._last is not None:
            self._last.join()
            self._last = None
        if self._errors:
            raise RuntimeError("Async checkpoint save failed") from self._errors[0]

    def _host(self, snapshot, ready: torch.cuda.Event | None):
        """The snapshot's host arrays (this rank's pieces when sharded)."""
        if isinstance(snapshot, Mapping):
            return snapshot
        pull = None if ready is None else lambda tensors: self._pull(tensors, ready)
        if self._sharded:
            from .sharded_checkpoint import state_to_host_shards

            return state_to_host_shards(snapshot, self._mesh, pull)
        return train_state_to_flat(snapshot, pull)

    def _pull(self, tensors: dict[str, torch.Tensor], ready: torch.cuda.Event) -> dict[str, torch.Tensor]:
        """Copy card tensors into the reused pinned buffers on the writer's
        stream, once ``ready`` has passed on the caller's stream."""
        out = {}
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for key, t in tensors.items():
                buf = self._pinned.get(key)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                out[key] = buf.copy_(t, non_blocking=True)
        self._stream.synchronize()
        return out
