"""Per-process sharded checkpoints of a state on a mesh, in the JAX
package's directory format (port of ``ttamm_tpu/train/sharded_checkpoint.py``).

``<name>/`` (a directory, named by ``checkpoint_filename``)
    ``manifest.json``      meta (epoch, metric, timestamp, ``num_processes``),
                           written by rank 0
    ``shards_p00000.npz``  one file per rank: the pieces it owns

A piece key is ``<leaf key>::<bounds>``, with the flat keys of
``train_state_to_flat`` and bounds ``"r0:r1;c0:c1"`` in global coordinates
of the JAX leaf (empty for scalars). Each piece is written once: a
row-sharded tensor by the ranks of data shard 0 (its rows of the padded
layout), a tensor-parallel slice of a dense leaf or its moment
(``mesh.tensor_parallel``) by the same ranks, in JAX's ``[in, out]``
orientation (``"0:in;c0:c1"`` for a column layer's ``w``, ``"c0:c1"`` for
its ``b``, ``"r0:r1;0:out"`` for a row layer's ``w``), everything else by
rank 0. So ``ttamm_tpu.train.sharded_checkpoint.load_sharded_checkpoint``
reads a port directory, and :func:`load_sharded_checkpoint` a JAX one,
whatever mesh, tensor parallelism and sparse-Adam moment layout (separate
``m`` / ``v`` or packed ``mv``) either was saved under: a rank assembles
its block from the pieces that overlap it, a table's cut to its logical
rows (pad rows stay zero). Every rank must see every shard file (a shared file system), unless
the mesh is unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch.distributed as dist

from ..models.convert import train_state_from_flat, train_state_to_flat
from .checkpoint import checkpoint_path, write_npz
from .state import TrainState

Bounds = tuple[tuple[int, int], ...]

MANIFEST = "manifest.json"


def _bounds_str(bounds: Bounds) -> str:
    return ";".join(f"{a}:{b}" for a, b in bounds)


def _parse_bounds(text: str) -> Bounds:
    if not text:
        return ()
    return tuple((int(a), int(b)) for a, b in (part.split(":") for part in text.split(";")))


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class _Region(NamedTuple):
    """Where a sharded leaf's local array sits in the global (JAX) leaf: a
    block ``[start, start + local)`` along ``axis``, whole along the other
    dims; ``logical``: the rows past which a row-sharded table is padding
    (None for a tensor-parallel slice)."""

    axis: int
    start: int
    logical: int | None

    def bounds(self, shape: tuple[int, ...], cut: bool = False) -> Bounds:
        """The block in global coordinates; with ``cut``, a table's block
        cut back to its logical rows."""
        out = [(0, n) for n in shape]
        stop = self.start + shape[self.axis]
        if cut and self.logical is not None:
            stop = min(stop, self.logical)
        out[self.axis] = (self.start, stop)
        return tuple(out)


def _regions(state: TrainState, mesh) -> dict[str, _Region]:
    """A :class:`_Region` for each sharded leaf of this rank: the row-sharded
    tensors and the tensor-parallel slices."""
    from ..parallel.mesh import MODEL_AXIS, axis_index
    from ..parallel.sharding import logical_rows, row_offset, row_sharded_tensors, tp_sharded_tensors

    out: dict[str, _Region] = {}
    for key, (name, t) in row_sharded_tensors(state).items():
        start = 0 if mesh is None else row_offset(mesh, t.shape[0])
        out[key] = _Region(0, start, logical_rows(state.model, name))
    if state.tensor_parallel:
        for key, (dim, t) in tp_sharded_tensors(state, mesh).items():
            axis = 1 - dim if key.endswith("/w") else dim  # JAX's w is [in, out]
            out[key] = _Region(axis, axis_index(mesh, MODEL_AXIS) * t.shape[dim], None)
    if state.packed_moments:  # the mv leaf holds the rows of m and v
        out.update({f"opt_sparse/{n}/mv": out[f"opt_sparse/{n}/m"] for n in state.opt_sparse})
    return out


def state_to_host_shards(state: TrainState, mesh=None, pull=None) -> dict[str, np.ndarray]:
    """This rank's pieces, pulled to the host once (pass them to several
    :func:`save_sharded_checkpoint` calls of one epoch); ``pull`` as in
    ``train_state_to_flat``."""
    from ..parallel.mesh import DATA_AXIS, axis_index

    data_index = 0 if mesh is None else axis_index(mesh, DATA_AXIS)
    regions = _regions(state, mesh)
    pieces: dict[str, np.ndarray] = {}
    for key, arr in train_state_to_flat(state, pull).items():
        region = regions.get(key)
        if region is not None:
            if data_index:
                continue  # another data shard holds the same block
            bounds = region.bounds(arr.shape)
        elif _rank():
            continue  # replicated: rank 0 writes it
        else:
            bounds = tuple((0, d) for d in arr.shape)
        pieces[f"{key}::{_bounds_str(bounds)}"] = arr
    return pieces


def save_sharded_checkpoint(
    directory: Path | str,
    state: TrainState | None = None,
    *,
    experiment_name: str,
    epoch: int,
    metric_name: str | None,
    metric_value: float | None,
    template: str | None = None,
    mesh=None,
    host_pieces: dict[str, np.ndarray] | None = None,
) -> Path:
    """Each rank writes its shard file; rank 0 adds the manifest (and drops
    shard files of an earlier save by more processes). Returns the
    directory. No barrier is taken: a reader in the same run waits for
    every rank first."""
    path = checkpoint_path(
        directory, experiment_name=experiment_name, metric_name=metric_name,
        metric_value=metric_value, epoch=epoch, template=template,
    )
    path.mkdir(parents=True, exist_ok=True)
    rank, world = _rank(), _world()
    if rank == 0:
        for stale in path.glob("shards_p*.npz"):
            if int(stale.stem.rpartition("p")[2]) >= world:
                stale.unlink()
    pieces = host_pieces if host_pieces is not None else state_to_host_shards(state, mesh)
    with open(path / f"shards_p{rank:05d}.npz", "wb") as handle:
        write_npz(handle, pieces)
    if rank == 0:
        meta = {
            "epoch": epoch,
            "metric_name": metric_name,
            "metric_value": metric_value,
            "timestamp": time.time(),
            "format_version": 2,
            "num_processes": world,
        }
        (path / MANIFEST).write_text(json.dumps(meta))
    return path


def _piece_index(path: Path, num_processes: int | None):
    """``leaf key -> [(bounds, loader)]`` over the manifest's shard files."""
    blobs, by_leaf = [], {}
    for shard in sorted(path.glob("shards_p*.npz")):
        if num_processes is not None and int(shard.stem.rpartition("p")[2]) >= num_processes:
            continue
        blob = np.load(shard, allow_pickle=False)
        blobs.append(blob)
        for piece_key in blob.files:
            leaf, _, text = piece_key.rpartition("::")
            by_leaf.setdefault(leaf, []).append((_parse_bounds(text), lambda b=blob, k=piece_key: b[k]))
    if not blobs:
        raise FileNotFoundError(f"No shard files under {path}")
    return blobs, by_leaf


def _moment_layout_pieces(key: str, shape: tuple[int, ...], by_leaf) -> list:
    """The pieces of a sparse-Adam ``m`` / ``v`` leaf cut from the left /
    right half of packed ``mv`` pieces (the JAX loader's
    ``_convert_moment_layout``). The layouts differ by a column offset
    only, which composes with row sharding."""
    prefix, _, leaf = key.rpartition("/")
    out = []
    if leaf in ("m", "v") and len(shape) == 2:
        lo = 0 if leaf == "m" else shape[1]
        for ((r0, r1), (c0, c1)), get in by_leaf.get(f"{prefix}/mv", []):
            a, b = max(c0, lo), min(c1, lo + shape[1])
            if a < b:
                cut = lambda g=get, x=a - c0, y=b - c0: g()[:, x:y]  # noqa: E731
                out.append((((r0, r1), (a - lo, b - lo)), cut))
    return out


def _assemble(pieces: list[tuple[Bounds, Callable[[], np.ndarray]]], want: Bounds,
              out: np.ndarray, key: str) -> None:
    """Fill ``out`` (the region ``want``, or its leading part) from the
    overlapping pieces; raise unless they cover ``want``."""
    covered = 0
    for bounds, get in pieces:
        overlap = tuple((max(a, wa), min(b, wb)) for (a, b), (wa, wb) in zip(bounds, want))
        if any(a >= b for a, b in overlap):
            continue
        src = get()[tuple(slice(a - pa, b - pa) for (a, b), (pa, _) in zip(overlap, bounds))]
        out[tuple(slice(a - wa, b - wa) for (a, b), (wa, _) in zip(overlap, want))] = src
        covered += int(np.prod([b - a for a, b in overlap]))
    need = int(np.prod([b - a for a, b in want]))
    if covered != need:
        raise ValueError(
            f"Checkpoint pieces cover {covered}/{need} elements of '{key}' region {want}: "
            "saved under another config?"
        )


def load_sharded_checkpoint(
    path: Path | str, template_state: TrainState, mesh=None
) -> tuple[TrainState, dict[str, Any]]:
    """Restore a sharded checkpoint (the port's or the JAX package's) into
    ``template_state`` in place: with ``mesh``, this rank's part of a
    placed state; without, a one-device state. Returns it and the meta."""
    path = Path(path)
    meta = json.loads((path / MANIFEST).read_text())
    blobs, by_leaf = _piece_index(path, meta.get("num_processes"))
    separate = dataclasses.replace(template_state, packed_moments=False)
    regions = _regions(separate, mesh)
    flat: dict[str, np.ndarray] = {}
    try:
        for key, arr in train_state_to_flat(separate).items():
            pieces = by_leaf.get(key) or _moment_layout_pieces(key, arr.shape, by_leaf)
            if not pieces:
                raise ValueError(f"Checkpoint {path} has no pieces for '{key}'")
            if arr.ndim == 0:
                flat[key] = np.asarray(pieces[0][1]()).astype(arr.dtype)
                continue
            out = np.zeros(arr.shape, arr.dtype)
            region = regions.get(key)
            want = tuple((0, d) for d in arr.shape) if region is None else region.bounds(arr.shape, cut=True)
            if all(b > a for a, b in want):
                _assemble(pieces, want, out[tuple(slice(0, b - a) for a, b in want)], key)
            flat[key] = out
    finally:
        for blob in blobs:
            blob.close()
    return train_state_from_flat(template_state, flat), meta
