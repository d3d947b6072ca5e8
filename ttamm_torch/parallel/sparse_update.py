"""Sparse-row Adam on a row-sharded table: one ``sparse_adam_rows`` launch
on each shard's own rows (port of ``ttamm_tpu/parallel/sparse_update.py``).

Every rank holds the row gradients of its data shard's lanes; each model
shard applies the update to the rows it owns. Two routings for the exchange
of row gradients over ``data``:

``allgather``:
1. all-gather the ``(indices, row_grads)`` lanes over ``data`` (batch-sized
   traffic, never a table-sized gradient) and put them in the one-device
   order (``gather_order``);
2. coalesce duplicate indices as the single-device update does (stable sort,
   then each run summed in lane order by ``segment_reduce``);
3. keep the head lane of each run and map its global row id to this shard's
   range; every other lane (a run's non-heads, the rows another shard owns,
   which after the sort sit at the head and the tail) gets idx = -1;
4. one ``sparse_adam_rows`` launch reads, steps and writes back the owned
   rows' weights and moments in place.
Each live row is the target of exactly one lane, so the read-modify-write
kernel applies each row's update once. This routing gives the
single-device update's bits. Steps 1 and 2 are :func:`gather_lanes`, which
the step's global-norm clip runs first and hands to the update
(``gathered``), so a table's lanes are gathered and sorted once a step.

``owner``: the batch is replicated over ``model``, so each rank already
holds every lane its shard owns from its own data shard. It coalesces its
local lanes, compacts the ones its model shard owns into a fixed buffer of
``owner_capacity`` lanes (sentinel -1 after them), all-gathers only that
buffer over ``data`` and coalesces again, non-head lanes -1 (the same row
from two data shards arrives twice). At one data shard the buffer already
holds distinct sorted rows and its sentinel tail, so it is not coalesced
again. The receive per rank drops from ``n`` lanes to ``dp * capacity``.
Duplicates are summed in two phases, so the result matches the allgather
routing to ``allclose`` (1e-5), not bit for bit.

Overflow is never dropped: if any rank owns more coalesced lanes than the
capacity, a one-integer ``all_reduce(MAX)`` over the whole mesh tells every
rank, and that step takes the allgather routing (with ``gathered`` where
the caller has it), as the JAX ``lax.cond`` after a ``pmax``. The flag
stays on the device: ``ops/device_cond.py`` takes one branch by it (on a
card two IF nodes of a CUDA graph, each branch captured once), so a step
that does not overflow runs the owner routing's collectives alone, and the
step runs the same code eagerly and as a replayed graph with no host sync.
The checks and the overflows are counted on the device
(:func:`owner_stats`, one host read where a caller asks).
``owner_unchecked`` skips the check and drops overflowing lanes; use it
only where the capacity has been audited.

Every data replica of a table shard applies the same update, so replicas
stay bit-identical without a reduction.

Row gradients in a narrower wire dtype (``comm_dtype: bfloat16``) cross
every all-gather over ``data`` in that dtype and are widened to the
table's dtype right after; the arithmetic stays in the table's dtype.
Under the owner routing the lanes are widened and coalesced first, and
the buffer's coalesced totals are rounded to the wire dtype once more
before their all-gather; an overflowing step re-exchanges the unsummed
wire-dtype lanes. So at the wire dtype owner and allgather round in
different places and differ by more than the two-phase sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import device_cond, kernels
from ..ops.sparse_adam import SparseAdamState
from . import collective_inspect
from .mesh import DATA_AXIS, MODEL_AXIS, WORLD_AXIS, all_gather_rows, all_reduce, axis_size
from .sharding import row_offset

ROUTINGS = ("allgather", "owner", "owner_unchecked")
# owner routing, by device: int64 [checks, overflows], a check a sparse table
# a step, an overflow where it took the allgather routing
_owner_counts: dict[torch.device, torch.Tensor] = {}


def owner_stats() -> dict[str, int]:
    """The owner routing's checks and overflows since the last reset,
    summed over devices (one host read of each device's counters)."""
    checks = overflows = 0
    for counts in _owner_counts.values():
        c, o = counts.tolist()
        checks, overflows = checks + c, overflows + o
    return {"checks": checks, "overflows": overflows}


def reset_owner_stats() -> None:
    """Zero the counters in place (a captured step keeps adding to them)."""
    for counts in _owner_counts.values():
        counts.zero_()


def _count_check(flag: torch.Tensor) -> None:
    """One check, and an overflow where ``flag`` is set, on the device.
    The counters are made by the first (eager) step on a device."""
    counts = _owner_counts.get(flag.device)
    if counts is None:
        counts = _owner_counts[flag.device] = torch.zeros(2, dtype=torch.int64, device=flag.device)
    counts.add_(torch.cat([torch.ones_like(flag), flag]).to(torch.int64))


def _pick_block(n: int) -> int | None:
    """The JAX package's DMA block choice (largest of 256..8 dividing n);
    the port's kernels take any n, so only :func:`owner_capacity` reads it,
    to size the buffer as the JAX package does."""
    for block in (256, 128, 64, 32, 16, 8):
        if n % block == 0:
            return block
    return None


def owner_capacity(n: int, dp: int, mp: int, capacity_factor: float) -> int:
    """Lanes per rank of the owner routing's buffer, for ``n`` global lanes:
    ``capacity_factor`` x the balanced share of this rank's ``n / dp``
    lanes, rounded up to 256 when that fits, else to the smallest capacity
    whose ``dp`` copies the JAX package's DMA blocks divide, at most the
    local lane count (which cannot overflow)."""
    n_local = n // dp
    c = max(1, -(-int(capacity_factor * n_local) // mp))
    c256 = -(-c // 256) * 256
    if c256 <= n_local:
        return c256
    for cand in range(min(c, n_local), n_local + 1):
        if _pick_block(dp * cand) is not None:
            return cand
    return n_local


class SortedLanes(NamedTuple):
    """Lanes stably sorted by row id, with their runs of equal ids:
    ``idx`` int64 ``[n]`` sorted, ``grads`` ``[n, D]`` in the same order,
    ``is_head`` (the first lane of each run), ``seg`` (each lane's run,
    -1 for lanes before the first head) and ``lengths`` (the run lengths,
    padded to ``n`` with empty runs)."""

    idx: torch.Tensor
    grads: torch.Tensor
    is_head: torch.Tensor
    seg: torch.Tensor
    lengths: torch.Tensor

    def totals(self) -> torch.Tensor:
        """Each lane's run total, summed in lane order (as
        ``coalesce_row_grads``); lanes before the first head join run 0 as
        zeros (exact), so no host sync is needed to drop them."""
        data = torch.where((self.seg >= 0)[:, None], self.grads, 0.0)
        summed = torch.segment_reduce(data, "sum", lengths=self.lengths, unsafe=True)
        return summed[self.seg]

    def scaled(self, scale: torch.Tensor) -> "SortedLanes":
        """The same lanes with every gradient times ``scale``: the bits of
        scaling the lanes before the sort."""
        return self._replace(grads=self.grads * scale)


def sort_lanes(idx: torch.Tensor, grads: torch.Tensor, *, head_init: int) -> SortedLanes:
    """Stable-sort lanes by row id and find their runs. ``head_init`` must
    sort below every id (-1 for ids >= 0, -2 where sentinel -1 lanes
    occur); lanes equal to it form no run of their own (seg -1), as in the
    JAX package."""
    n = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    prev = torch.cat([sorted_idx.new_full((1,), head_init), sorted_idx[:-1]])
    is_head = sorted_idx != prev
    seg = torch.cumsum(is_head, 0) - 1
    lengths = torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, seg.clamp_min(0), torch.ones_like(seg)
    )
    return SortedLanes(sorted_idx, grads[order], is_head, seg, lengths)


def _coalesce_sorted(idx: torch.Tensor, grads: torch.Tensor, *, head_init: int):
    """``(sorted_idx, totals, is_head, seg)`` of :func:`sort_lanes`, every
    lane of a run carrying the run's total (the JAX package's
    ``_coalesce_sorted``)."""
    lanes = sort_lanes(idx, grads, head_init=head_init)
    return lanes.idx, lanes.totals(), lanes.is_head, lanes.seg


def gather_lanes(
    mesh: DeviceMesh, indices: torch.Tensor, row_grads: torch.Tensor,
    gather_order: torch.Tensor | None = None, dtype: torch.dtype = torch.float32,
) -> SortedLanes:
    """The lanes of every data shard, all-gathered over ``data`` in
    ``row_grads``' dtype and widened to ``dtype``, put in the one-device
    order (``gather_order``, see :func:`sharded_sparse_adam_apply`) and
    sorted: what the allgather routing and the global-norm clip both start
    from."""
    idx_all = all_gather_rows(indices.to(torch.int64), mesh, DATA_AXIS)
    g_all = all_gather_rows(row_grads, mesh, DATA_AXIS).to(dtype)
    if gather_order is not None:
        idx_all, g_all = idx_all[gather_order], g_all[gather_order]
    return sort_lanes(idx_all, g_all, head_init=-2)


def _apply(table, state, lane_idx, grads, *, scalars, decay) -> None:
    """One ``sparse_adam_rows`` launch on this shard's rows, in place, at
    the step's scalars. ``lane_idx`` is shard-local, -1 where the lane is
    skipped, and holds each live row once."""
    kernels.sparse_adam_rows(
        table, state.m, state.v, lane_idx, grads, scalars=scalars, decay=decay
    )


def _localize(sorted_idx: torch.Tensor, base: int, rows: int,
              heads: torch.Tensor | None = None) -> torch.Tensor:
    """Shard-local int32 row ids, -1 for lanes of other shards, sentinel
    lanes and (given ``heads``) every lane that is not a head."""
    local = sorted_idx - base
    live = (local >= 0) & (local < rows)
    if heads is not None:
        live &= heads
    return torch.where(live, local, -1).to(torch.int32)


@torch.no_grad()
def sharded_sparse_adam_update(
    mesh: DeviceMesh,
    table: torch.Tensor,
    state: SparseAdamState,
    indices: torch.Tensor,
    row_grads: torch.Tensor,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    **options,
) -> torch.Tensor | None:
    """One SparseAdam step of a row-sharded table at ``state.step + 1``,
    which it advances: :func:`sharded_sparse_adam_apply` with the step's
    scalars formed here (``options``: its keywords after ``decay``)."""
    state.step += 1
    row = kernels.adam_row(table.device, step=state.step, lr=lr, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay)
    return sharded_sparse_adam_apply(mesh, table, state, indices, row_grads, **row, **options)


@torch.no_grad()
def sharded_sparse_adam_apply(
    mesh: DeviceMesh,
    table: torch.Tensor,
    state: SparseAdamState,
    indices: torch.Tensor,
    row_grads: torch.Tensor,
    *,
    scalars: torch.Tensor,
    decay: bool,
    routing: str = "allgather",
    capacity_factor: float = 2.0,
    gather_order: torch.Tensor | None = None,
    gathered: SortedLanes | None = None,
) -> torch.Tensor | None:
    """One SparseAdam step of a row-sharded table, in place on this rank's
    ``table`` / ``state.m`` / ``state.v`` shards, at the step's f32 scalars
    (``kernels.adam_scalars``' row on the device; ``state.step`` is left as
    it is).

    ``indices`` int ``[n / dp]`` (global row ids; -1 marks a padding lane)
    and ``row_grads`` ``[n / dp, D]`` are this rank's data shard, in the
    wire dtype (the table's, or bfloat16 under ``comm_dtype``); every rank
    passes the same count. ``gather_order``: an optional permutation of the
    ``n`` lanes gathered over ``data`` (rank-major) into the order the
    coalesce sums them in. ``gathered``: :func:`gather_lanes` of these
    lanes, where the caller has it already; the allgather routing (and an
    owner step that overflows) then gathers and sorts nothing again.
    Returns the owner routing's overflow flag (int32 ``[1]`` on the device,
    the same on every rank: nonzero where the step took the allgather
    routing), None under the other routings."""
    if routing not in ROUTINGS:
        raise ValueError(f"Unknown update routing: {routing}")
    rows = table.shape[0]
    base = row_offset(mesh, rows)
    dp, mp = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    idx = indices.to(torch.int64)

    def allgather_update(scalars, lanes: SortedLanes) -> None:
        _apply(table, state, _localize(lanes.idx, base, rows, lanes.is_head), lanes.totals(),
               scalars=scalars, decay=decay)

    def gathered_lanes(idx, row_grads, gather_order=None) -> SortedLanes:
        # the unsummed lanes cross the wire in their own dtype
        return gather_lanes(mesh, idx, row_grads, gather_order, table.dtype)

    if routing == "allgather":
        allgather_update(scalars, gathered if gathered is not None else
                         gathered_lanes(idx, row_grads, gather_order))
        return None

    n = idx.shape[0] * dp
    cap = owner_capacity(n, dp, mp, capacity_factor)
    grads = row_grads.to(table.dtype)  # coalesced in the table's dtype
    sorted_idx, g_coal, is_head, _ = _coalesce_sorted(idx, grads, head_init=-2)
    local = sorted_idx - base
    owned = is_head & (local >= 0) & (local < rows)

    def owner_update(scalars, owned, sorted_idx, g_coal, *_) -> None:
        # compact the owned head lanes into the [cap] buffer; slot cap takes
        # every discarded write (lanes not owned, and overflow under
        # owner_unchecked)
        pos = torch.cumsum(owned, 0) - 1
        tgt = torch.where(owned & (pos < cap), pos, cap)
        idx_c = sorted_idx.new_full((cap + 1,), -1).index_copy_(
            0, tgt, torch.where(owned, sorted_idx, -1)
        )[:cap]
        g_c = g_coal.new_zeros((cap + 1, g_coal.shape[1])).index_copy_(
            0, tgt, torch.where(owned[:, None], g_coal, 0.0)
        )[:cap]
        idx_all = all_gather_rows(idx_c, mesh, DATA_AXIS)
        # the coalesced totals rounded to the wire dtype again
        g_all = all_gather_rows(g_c.to(row_grads.dtype), mesh, DATA_AXIS).to(table.dtype)
        if dp == 1:
            # one data shard: the buffer holds distinct sorted rows already,
            # its sentinel tail last
            _apply(table, state, _localize(idx_all, base, rows), g_all, scalars=scalars,
                   decay=decay)
        else:
            allgather_update(scalars, sort_lanes(idx_all, g_all, head_init=-2))

    head = (scalars, owned, sorted_idx, g_coal)
    if routing == "owner_unchecked":
        owner_update(*head)
        return None
    flag = (owned.sum() > cap).to(torch.int32).reshape(1)
    all_reduce(flag, mesh, WORLD_AXIS, op=dist.ReduceOp.MAX)
    _count_check(flag)
    if gathered is not None:
        def fallback(scalars, *rest):
            allgather_update(scalars, SortedLanes(*rest[3:]))

        tail = tuple(gathered)
    else:
        def fallback(scalars, *rest):
            allgather_update(scalars, gathered_lanes(*rest[3:]))

        tail = (idx, row_grads) + (() if gather_order is None else (gather_order,))
    # the key holds the data group (whose communicator the branches' all-gathers
    # use; a new group is a new object) and the row update they capture (a
    # check that swaps in a plain version gets graphs of its own)
    key = ("sharded_sparse_adam", table.data_ptr(), state.m.data_ptr(), state.v.data_ptr(),
           rows, base, dp, cap, decay, row_grads.dtype, gathered is None,
           mesh.get_group(DATA_AXIS), _apply, kernels.sparse_adam_rows)
    _recorded_cond(flag, fallback, owner_update, head + tail, key)
    return flag


def _recorded_cond(flag: torch.Tensor, fallback, owner_update, operands: tuple, key: tuple) -> None:
    """``device_cond.cond(flag, fallback, owner_update, ...)`` with the
    collectives of the fallback recorded under ``branch="overflow"``
    (``collective_inspect``). On the CPU only the branch taken runs and
    issues. On a card a key's first call captures both branches, and what
    they issued is kept with their graphs and added to the open records at
    every later call (whose graphs run no Python): each call lists both
    branches, as the HLO of a ``lax.cond`` holds both."""
    on_card, issued = flag.device.type == "cuda", []

    def recorded(fn, tag):
        def run(*args):
            with collective_inspect.branch(tag):
                if not on_card:
                    return fn(*args)
                with collective_inspect.record_collectives() as got:
                    fn(*args)
                issued.extend(got)
        return run

    device_cond.cond(flag, recorded(fallback, "overflow"), recorded(owner_update, None), operands,
                     key=key, on_replay=lambda: collective_inspect.replay_records(issued))
