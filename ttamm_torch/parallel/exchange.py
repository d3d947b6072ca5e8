"""Bucketed all-to-all embedding exchange (port of
``ttamm_tpu/parallel/exchange.py``), ``mesh.embedding_exchange: alltoall``.

The explicit alternative to the masked lookup of ``embedding_lookup.py``
(every model shard reads the lanes it owns, zeros elsewhere, then a sum
over ``model``). Each model shard owns a contiguous row range of a table.
The ranks of one data shard hold the same lanes; each takes an equal
sub-chunk of them (padded to a multiple of the model axis, as the JAX
package splits a batch over ``(data, model)``) and

1. sorts its ids by owning shard (one stable argsort, :func:`route_by_owner`);
2. sends each bucket of ids to its owner (``all_to_all_single`` over
   ``model``);
3. the owner reads its rows for the ids it received with the
   ``gather_rows`` kernel (out-of-range slots clipped, as the JAX
   ``jnp.take`` of clipped ids);
4. the rows go back the same way and the sort is undone;
5. the sub-chunks are all-gathered over ``model`` (above one model shard),
   so every rank of the data shard has every lane's row (the JAX exchange
   leaves them sharded over ``(data, model)``; the port's step computes the
   whole data shard on each of its model ranks).

Two collective layouts share that plan:

- ``dense``: a fixed capacity of ``n`` ids a (source, owner) pair, equal
  splits; exact for any id distribution, no host sync. ``variant="auto"``
  takes it, as the JAX package does off the TPU.
- ``ragged``: only the real bucket sizes move (``all_to_all_single`` with
  split sizes). The split sizes are needed on the host, so every lookup
  costs one device-to-host sync of the ``[S, S]`` count matrix, and it
  raises inside a CUDA graph capture (a replayed step); the trainer never
  selects it. ``dense`` has no host read and is captured.

:func:`exchange_rows` reads outside autograd (the sparse tables);
:func:`exchange_lookup` is differentiable in the table shard (the dense
ones), the counterpart of the JAX ``make_exchange_lookup`` /
``padded_exchange_lookup`` (the ids are padded to the model axis inside).
The rows are copies, so both equal ``index_select`` of the whole table bit
for bit. The backward (:func:`exchange_lookup`'s, for the dense-optimizer
tables) rounds each lane's gradient to the wire dtype (``comm_dtype``),
routes every rank's sub-chunk of it to the owners with the same plan
(``all_to_all_single``, in the wire dtype), all-gathers what each owner
received over ``data`` (batch-sized, never a table shard), widens it and
sums the lanes into the shard's rows in the fixed order of ``sum_rows``.
The owner receives each data shard's lanes in lane order, so the sums are
the masked lookup's (``sharded_lookup``) bit for bit. The JAX transpose
all-gathers the row gradients over ``data`` and scatter-adds the global
batch; its sums run in another order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import kernels
from ..ops.sparse_adam import sum_rows
from .mesh import DATA_AXIS, MODEL_AXIS, all_gather_rows, all_to_all, axis_index, axis_size

VARIANTS = ("dense", "ragged")


class RoutePlan(NamedTuple):
    """How ``n`` local ids are routed to their owning shards."""

    order: torch.Tensor  # [n] permutation sorting the ids by owner (stable)
    inv_order: torch.Tensor  # [n] its inverse
    sorted_ids: torch.Tensor  # [n] the ids grouped by owner
    counts: torch.Tensor  # [S] ids bound for each shard
    starts: torch.Tensor  # [S] each bucket's start (exclusive cumsum of counts)
    slots: torch.Tensor  # [n] each sorted id's place in an [S, capacity] send buffer


def route_by_owner(ids: torch.Tensor, rows_per_shard: int, num_shards: int,
                   capacity: int) -> RoutePlan:
    """The routing of ``ids`` to ``num_shards`` shards of ``rows_per_shard``
    rows (owners clipped to the shards, as the JAX package's). No host
    sync: the counts are a scatter-add (``torch.bincount`` reads the
    largest id on the host) and the inverse permutation a scatter."""
    n = ids.shape[0]
    owner = torch.clamp(ids.long() // rows_per_shard, 0, num_shards - 1)
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order]
    lanes = torch.arange(n, device=ids.device)
    counts = torch.zeros(num_shards, dtype=torch.int64, device=ids.device).scatter_add_(
        0, owner, torch.ones_like(owner))
    starts = torch.cumsum(counts, 0) - counts
    inv_order = torch.empty_like(order).scatter_(0, order, lanes)
    return RoutePlan(order, inv_order, ids[order], counts, starts,
                     sorted_owner * capacity + lanes - starts[sorted_owner])


def _resolve(variant: str) -> str:
    variant = "dense" if variant == "auto" else variant
    if variant not in VARIANTS:
        raise ValueError(f"Unknown exchange variant: {variant}")
    return variant


def _owner_rows(local: torch.Tensor, got_ids: torch.Tensor, me: int) -> torch.Tensor:
    """The owner's rows for the ids it received (one ``gather_rows``)."""
    rows = local.shape[0]
    lane = torch.clamp(got_ids.long() - me * rows, 0, rows - 1).to(torch.int32)
    return kernels.gather_rows(local, lane)


def _dense_rows(local: torch.Tensor, ids: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Steps 1-4 with fixed capacity-``n`` buckets (equal splits)."""
    n, rows, num_shards = ids.shape[0], local.shape[0], axis_size(mesh, MODEL_AXIS)
    me = axis_index(mesh, MODEL_AXIS)
    plan = route_by_owner(ids, rows, num_shards, capacity=n)
    send = ids.new_zeros(num_shards * n).index_copy_(0, plan.slots, plan.sorted_ids)
    got = all_to_all(torch.empty_like(send), send, mesh, MODEL_AXIS)
    # slots past a bucket's count carry id 0: their rows ride back unread
    out = _owner_rows(local, got, me)
    back = all_to_all(torch.empty_like(out), out, mesh, MODEL_AXIS)
    return back[plan.slots[plan.inv_order]]


def _ragged_rows(local: torch.Tensor, ids: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Steps 1-4 moving only the real buckets; one host sync for the sizes,
    so it refuses to run inside a CUDA graph capture."""
    if ids.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the ragged all-to-all exchange reads its split sizes on the host and cannot run "
            "in a captured step: use variant='dense' (what embedding_exchange: alltoall takes)")
    rows, num_shards = local.shape[0], axis_size(mesh, MODEL_AXIS)
    me = axis_index(mesh, MODEL_AXIS)
    plan = route_by_owner(ids, rows, num_shards, capacity=ids.shape[0])
    counts = all_gather_rows(plan.counts.reshape(1, num_shards), mesh, MODEL_AXIS).tolist()
    send = [int(c) for c in counts[me]]  # my bucket for each owner
    recv = [int(counts[r][me]) for r in range(num_shards)]  # each rank's bucket for me
    got = all_to_all(ids.new_empty(sum(recv)), plan.sorted_ids, mesh, MODEL_AXIS, recv, send)
    out = _owner_rows(local, got, me)
    back = all_to_all(out.new_empty((ids.shape[0], out.shape[1])), out, mesh, MODEL_AXIS, send, recv)
    return back[plan.inv_order]


def _sub_chunk(ids: torch.Tensor, mesh: DeviceMesh) -> tuple[torch.Tensor, int]:
    """``(this model rank's sub-chunk of the ids, padded to mp equal ones,
    the chunk length)``; the pad ids are 0."""
    mp = axis_size(mesh, MODEL_AXIS)
    chunk = -(-ids.shape[0] // mp)
    if chunk * mp != ids.shape[0]:
        ids = torch.cat([ids, ids.new_zeros(chunk * mp - ids.shape[0])])
    start = axis_index(mesh, MODEL_AXIS) * chunk
    return ids[start : start + chunk], chunk


@torch.no_grad()
def exchange_rows(local: torch.Tensor, ids: torch.Tensor, mesh: DeviceMesh, *,
                  variant: str = "auto") -> torch.Tensor:
    """Rows ``[n, D]`` of the row-sharded table whose shard is ``local`` at
    this data shard's global ids ``ids`` (the same on every model rank),
    outside autograd, through the exchange."""
    variant = _resolve(variant)
    sub, _ = _sub_chunk(ids, mesh)
    rows = (_ragged_rows if variant == "ragged" else _dense_rows)(local, sub, mesh)
    if axis_size(mesh, MODEL_AXIS) == 1:
        return rows
    return all_gather_rows(rows, mesh, MODEL_AXIS)[: ids.shape[0]]


class _ExchangeLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, ids, mesh, variant, wire_dtype, lanes):
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.rows, ctx.wire, ctx.lanes = mesh, local.shape[0], wire_dtype, lanes
        return exchange_rows(local, ids, mesh, variant=variant)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        mesh, rows = ctx.mesh, ctx.rows
        num_shards = axis_size(mesh, MODEL_AXIS)
        me = axis_index(mesh, MODEL_AXIS)
        wire = grad.dtype if ctx.wire is None else ctx.wire
        n = ids.shape[0]
        # one sub-chunk width on every data shard: the lanes padded to ctx.lanes
        sub, chunk = _sub_chunk(ids if ctx.lanes is None else
                                torch.cat([ids, ids.new_zeros(ctx.lanes - n)]), mesh)
        start = me * chunk
        g = grad[start : start + chunk].to(wire)
        sentinel = num_shards * rows  # no shard's row: dropped at the owner
        sub = torch.where(torch.arange(start, start + chunk, device=ids.device) < n,
                          sub.long(), sentinel)
        g = torch.cat([g, g.new_zeros((chunk - g.shape[0], g.shape[1]))])  # the pad lanes
        plan = route_by_owner(sub, rows, num_shards, capacity=chunk)
        send_ids = sub.new_full((num_shards * chunk,), sentinel).index_copy_(
            0, plan.slots, plan.sorted_ids)
        send_g = g.new_zeros((num_shards * chunk, g.shape[1])).index_copy_(
            0, plan.slots, g[plan.order])
        got_ids = all_to_all(torch.empty_like(send_ids), send_ids, mesh, MODEL_AXIS)
        got_g = all_to_all(torch.empty_like(send_g), send_g, mesh, MODEL_AXIS)
        # what every data shard sent this shard, rank-major
        got_ids = all_gather_rows(got_ids, mesh, DATA_AXIS)
        got_g = all_gather_rows(got_g, mesh, DATA_AXIS).to(grad.dtype)
        local = got_ids - me * rows
        target = torch.where((local >= 0) & (local < rows), local, rows)
        return sum_rows(target, got_g, rows + 1)[:rows], None, None, None, None, None


def exchange_lookup(local: torch.Tensor, ids: torch.Tensor, mesh: DeviceMesh, *,
                    variant: str = "auto", wire_dtype: torch.dtype | None = None,
                    lanes: int | None = None) -> torch.Tensor:
    """Differentiable :func:`exchange_rows`: the gradient reaching ``local``
    is this shard's table gradient, summed over the data shards, each
    lane's gradient first rounded to ``wire_dtype`` (None: as it is).
    ``lanes``: the lane count every data shard pads to for the backward
    (None: ``ids``' length, the same on every rank)."""
    return _ExchangeLookup.apply(local, ids, mesh, _resolve(variant), wire_dtype, lanes)
