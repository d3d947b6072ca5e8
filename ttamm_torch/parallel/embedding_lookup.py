"""Row lookups of row-sharded tables (port of
``ttamm_tpu/parallel/embedding_lookup.py``).

Each model shard owns a contiguous row range. A lookup at global ids that
every rank of a model group holds alike: the shard reads the rows it owns,
leaves zeros for the others, and a sum over ``model`` combines the shards'
parts.

The embedding tables' reads (:func:`sharded_table_rows` for the sparse
tables: the ID tables and, under ``adaptive_mimic.sparse``, the mimic
tables; :func:`sharded_lookup` for the dense ones) are one masked
``gather_rows`` launch a table: the kernel localises the ids and writes
the zeros itself. :func:`sharded_rows` serves the feature matrices, the
padded positives and the category ids (not 2-D float32 rows of a width the
kernel takes; an integer sum of one owner's value and zeros is exact) with
PyTorch ops.

:func:`sharded_table_rows` reads outside autograd: the sparse tables' rows
become fresh leaves whose gradients go to the sharded sparse-row update.
:func:`sharded_lookup` is differentiable in the table shard: its backward
rounds each lane's gradient to the wire dtype (``comm_dtype``), all-gathers
the lanes of every data shard over ``data`` in that dtype (batch-sized
traffic, as the JAX transpose moves; a sum of the shard gradients over
``data`` would move a table shard a step) and sums the lanes this shard
owns into its rows, in the fixed order of ``sum_rows`` over the gathered
lanes (rank-major): the dense optimizer's table gradient. With one model
shard no sum over ``model`` runs.

Feature rows stored in bfloat16 (``data.features_dtype``) are summed over
``model`` in bfloat16: exact, since each lane has one owner and zeros
elsewhere (an owner's -0.0 comes back as +0.0).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import kernels
from ..ops.sparse_adam import sum_rows
from .mesh import DATA_AXIS, MODEL_AXIS, all_gather_rows, all_reduce, axis_size
from .sharding import row_offset


def _owned(rows: int, idx: torch.Tensor, mesh: DeviceMesh) -> tuple[torch.Tensor, torch.Tensor]:
    """``(owned [N] bool, shard-local row [N] int64, 0 where not owned)``
    for a shard of ``rows`` rows."""
    lane = idx.long() - row_offset(mesh, rows)
    owned = (lane >= 0) & (lane < rows)
    return owned, torch.where(owned, lane, 0)


def _lookup(local: torch.Tensor, idx: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This shard's rows at the lanes it owns and zeros elsewhere (one masked
    ``gather_rows``), summed over ``model`` above one model shard."""
    rows = kernels.gather_rows(local, idx, masked=True, base=row_offset(mesh, local.shape[0]))
    if axis_size(mesh, MODEL_AXIS) > 1:
        all_reduce(rows, mesh, MODEL_AXIS)
    return rows


@torch.no_grad()
def sharded_rows(local: torch.Tensor | None, idx: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor | None:
    """Rows ``[N, ...]`` of the row-sharded array whose local shard is
    ``local``, at global ids ``idx``; None for an absent (or empty) array."""
    if local is None or local.numel() == 0:
        return None
    if axis_size(mesh, MODEL_AXIS) == 1:
        return torch.index_select(local, 0, idx)
    owned, lane = _owned(local.shape[0], idx, mesh)
    rows = torch.index_select(local, 0, lane)
    rows = torch.where(owned.view(-1, *([1] * (rows.dim() - 1))), rows, torch.zeros_like(rows))
    return all_reduce(rows, mesh, MODEL_AXIS)


@torch.no_grad()
def sharded_table_rows(local: torch.Tensor, idx: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Rows ``[N, D]`` of a row-sharded f32 table at int32 global ids
    ``idx``, outside autograd, at any number of model shards."""
    return _lookup(local, idx, mesh)


def pad_lanes(idx: torch.Tensor, grads: torch.Tensor, lanes: int | None):
    """Lanes padded to ``lanes`` (None: as they are) with id -1 and zero
    gradients, so that every data shard gathers one width."""
    extra = 0 if lanes is None else lanes - idx.shape[0]
    if extra == 0:
        return idx, grads
    return (torch.cat([idx, idx.new_full((extra,), -1)]),
            torch.cat([grads, grads.new_zeros((extra, grads.shape[1]))]))


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, idx, mesh, wire_dtype, lanes):
        ctx.save_for_backward(idx)
        ctx.mesh, ctx.rows, ctx.wire, ctx.lanes = mesh, local.shape[0], wire_dtype, lanes
        return _lookup(local, idx, mesh)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        wire = grad.dtype if ctx.wire is None else ctx.wire
        idx, lane_grads = pad_lanes(idx, grad.to(wire), ctx.lanes)
        # every data shard's lanes, rank-major, in the wire dtype
        idx = all_gather_rows(idx, ctx.mesh, DATA_AXIS)
        lane_grads = all_gather_rows(lane_grads, ctx.mesh, DATA_AXIS).to(grad.dtype)
        owned, lane = _owned(ctx.rows, idx, ctx.mesh)
        # lanes another shard owns add their (zeroed) rows to a dropped row
        target = torch.where(owned, lane, ctx.rows)
        g = sum_rows(target, torch.where(owned[:, None], lane_grads, 0.0), ctx.rows + 1)[: ctx.rows]
        return g, None, None, None, None


def sharded_lookup(local: torch.Tensor, idx: torch.Tensor, mesh: DeviceMesh,
                   wire_dtype: torch.dtype | None = None, lanes: int | None = None) -> torch.Tensor:
    """Differentiable rows ``[N, D]`` of a row-sharded table at global ids
    ``idx``; the gradient reaching ``local`` is this shard's table gradient,
    summed over the data shards, each lane's gradient first rounded to
    ``wire_dtype`` (None: as it is). ``lanes``: the lane count every data
    shard pads to for the backward's gather (None: ``N``, the same on
    every rank)."""
    return _ShardedLookup.apply(local, idx, mesh, wire_dtype, lanes)
