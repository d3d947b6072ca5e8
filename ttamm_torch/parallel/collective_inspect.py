"""The collectives of a step, recorded where they are issued (port of
``ttamm_tpu/parallel/hlo_inspect.py``).

Numeric tests cannot see whether the sharded step moves its rows
efficiently: a step that all-gathered a whole ``[rows, D]`` table would
compute the same values. The JAX package reads the collectives off the
compiled HLO; the port issues every collective through three primitives of
``parallel/mesh.py``, and :func:`record_collectives` swaps those for
versions that list each call (op, result shape, dtype, payload bytes,
group size, mesh axis) while it is active. Outside it the primitives are
the plain ``torch.distributed`` calls: the record costs nothing when off.
The functions below keep the JAX names and take a record where JAX takes
HLO text.

A record is made on the host while the helpers run, so it covers an eager
step and the capture of a CUDA graph alike (a replay issues the captured
collectives and runs no Python). ``parallel/sparse_update.py`` tags what
the owner routing's full-width fallback issues with ``branch="overflow"``:
on a card both branches of its ``ops/device_cond.py`` are captured once and
every call lists both (:func:`replay_records` at the calls that run the
graphs), as the HLO of a ``lax.cond`` holds both; on the CPU only the
branch taken runs, so the fallback's collectives appear only on an
overflowing step. The bytes are this rank's: an all-to-all with
uneven splits counts what this rank received.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from . import mesh as _mesh

_HLO_DTYPES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.int32: "s32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64",
}


@dataclass(frozen=True)
class CollectiveOp:
    """One collective the helpers issued. ``result_shapes`` and
    ``max_component_bytes`` are the JAX record's fields, rendered from
    ``shape`` and ``dtype`` (one tensor a call here)."""

    op: str  # JAX's name: 'all-gather', 'all-reduce' or 'all-to-all'
    shape: tuple[int, ...]  # the result's shape on this rank
    bytes: int  # result payload bytes on this rank
    group_size: int | None = None  # ranks of the group (the axis' size)
    axis: str = "world"  # 'data', 'model' or 'world'
    dtype: str = "float32"  # the result's torch dtype, without 'torch.'
    branch: str | None = None  # 'overflow' in the owner routing's fallback

    @property
    def result_shapes(self) -> tuple[str, ...]:
        """As HLO writes them, e.g. ``('f32[256,64]',)``."""
        short = _HLO_DTYPES.get(getattr(torch, self.dtype, None), self.dtype)
        return (f"{short}[{','.join(map(str, self.shape))}]",)

    @property
    def max_component_bytes(self) -> int:
        return self.bytes

    def __str__(self) -> str:
        where = self.axis if self.branch is None else f"{self.axis}, {self.branch}"
        return f"{self.op} {'+'.join(self.result_shapes)} ({self.bytes} B, {where})"


_active: list[list[CollectiveOp]] = []  # the open records, outermost first
_branches: list[str] = []  # the branch tags in force
_plain = {name: getattr(_mesh, name) for name in ("_all_reduce", "_all_gather", "_all_to_all")}


def _record(op: str, result: torch.Tensor, group, axis: str) -> None:
    entry = CollectiveOp(
        op=op, shape=tuple(result.shape), bytes=result.numel() * result.element_size(),
        group_size=dist.get_world_size(group), axis=axis,
        dtype=str(result.dtype).removeprefix("torch."), branch=_branches[-1] if _branches else None,
    )
    for records in _active:
        records.append(entry)


def _all_reduce(t, op, group, axis):
    _record("all-reduce", t, group, axis)
    _plain["_all_reduce"](t, op, group, axis)


def _all_gather(out, t, group, axis):
    _record("all-gather", out, group, axis)
    _plain["_all_gather"](out, t, group, axis)


def _all_to_all(out, t, out_splits, in_splits, group, axis):
    _record("all-to-all", out, group, axis)
    _plain["_all_to_all"](out, t, out_splits, in_splits, group, axis)


_recording = {"_all_reduce": _all_reduce, "_all_gather": _all_gather, "_all_to_all": _all_to_all}


@contextlib.contextmanager
def record_collectives(mesh=None):
    """Yield a list that receives a :class:`CollectiveOp` for every
    collective ``parallel/mesh.py``'s helpers issue on this rank while the
    block runs. Records nest (an inner one's entries reach the outer ones
    too). ``mesh``: where given, each entry's group size must be its axis'
    size on this mesh (a helper that named the wrong axis raises)."""
    records: list[CollectiveOp] = []
    if not _active:
        for name, fn in _recording.items():
            setattr(_mesh, name, fn)
    _active.append(records)
    try:
        yield records
    finally:
        _active.remove(records)
        if not _active:
            for name, fn in _plain.items():
                setattr(_mesh, name, fn)
    if mesh is not None:
        sizes = {axis: _mesh.axis_size(mesh, axis) for axis in (_mesh.DATA_AXIS, _mesh.MODEL_AXIS)}
        sizes[_mesh.WORLD_AXIS] = mesh.size()
        wrong = [str(c) for c in records if c.group_size != sizes[c.axis]]
        if wrong:
            raise AssertionError(f"collectives whose group is not their axis' {sizes}: {wrong}")


@contextlib.contextmanager
def branch(name: str | None):
    """Tag what is recorded in this block with ``branch=name`` (None: no
    tag of its own)."""
    if name is None:
        yield
        return
    _branches.append(name)
    try:
        yield
    finally:
        _branches.pop()


def replay_records(entries: list[CollectiveOp]) -> None:
    """Add ``entries`` (what a captured graph issues) to every open record."""
    for records in _active:
        records.extend(entries)


def collect_collectives(records) -> list[CollectiveOp]:
    """The entries of a record, in the order they were issued."""
    return list(records)


def collective_summary(records) -> dict[str, dict[str, int]]:
    """Per-op-kind ``{count, bytes}`` totals of a record."""
    summary: dict[str, dict[str, int]] = {}
    for c in collect_collectives(records):
        entry = summary.setdefault(c.op, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += c.bytes
    return summary


def oversized_collectives(records, limit_bytes: int) -> list[CollectiveOp]:
    """Collectives moving a single tensor of at least ``limit_bytes``."""
    return [c for c in collect_collectives(records) if c.max_component_bytes >= limit_bytes]


def assert_no_table_sized_collectives(
    records, table_shapes: dict[str, tuple[int, ...]], *,
    element_bytes: int = 4, fraction: float = 0.5,
) -> None:
    """Raise if any collective moves >= ``fraction`` of the smallest table.

    ``table_shapes`` maps table name -> (rows, dim). A step that gathers or
    reduces a whole row-sharded table moves at least a shard of it; every
    legitimate exchange of the step is batch-sized, orders of magnitude
    smaller when rows >> batch.
    """
    smallest = min(rows * dim * element_bytes for rows, dim in table_shapes.values())
    limit = int(smallest * fraction)
    bad = oversized_collectives(records, limit)
    if bad:
        listing = "\n  ".join(str(c) for c in bad)
        raise AssertionError(
            f"Collectives moving >= {limit} bytes (>= {fraction:.0%} of the smallest table) "
            f"recorded:\n  {listing}"
        )


def wire_bytes_per_device(op: str, result_bytes: int, n: int | None) -> float:
    """Per-device link traffic of one collective under ring algorithms, for
    an ``n``-rank group (the cost model of the JAX package's
    ``scripts/predict_scaling.py``)."""
    if not n or n <= 1:
        return 0.0
    if op == "all-gather":
        return result_bytes * (n - 1) / n
    if op == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return float(result_bytes) * (n - 1)
    if op in ("all-to-all", "ragged-all-to-all"):
        return result_bytes * (n - 1) / n
    if op == "collective-permute":
        return float(result_bytes)
    return float(result_bytes)
