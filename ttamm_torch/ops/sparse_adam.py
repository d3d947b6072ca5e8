"""Sparse-row Adam: ``torch.optim.SparseAdam`` semantics for embedding tables
(port of ``ttamm_tpu/ops/sparse_adam.py``, its row-kernel path).

- only rows that received gradients this step are updated;
- duplicate indices are coalesced (gradients summed) before the update;
- first and second moments are per row, in table-shaped tensors;
- bias correction uses one step count per table;
- optional decoupled weight decay on the touched rows only (0 = SparseAdam).

The training step gathers rows outside the differentiated function, so
gradients arrive as ``(indices [N], row_grads [N, D])``, never as a
table-shaped zero tensor. The update computes the JAX kernel path's
function: coalesce (a stable sort, a segment sum, and every lane that is
not the head of its segment masked, idx = -1), then one
``kernels.sparse_adam_rows`` launch that reads each head lane's m, v and
weight row, applies Adam and writes the three back in place (the JAX
package: ``gather_rows`` x 3, the arithmetic, ``scatter_set_rows`` x 3,
with the duplicate lanes written to the scratch row). The masked lanes
touch nothing, so the table's scratch row (its last row) stays zero. Any N
(the TPU kernels needed N to divide a DMA block).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from . import kernels


@dataclass
class SparseAdamState:
    m: torch.Tensor  # [rows, D] first moments (rows include the scratch row)
    v: torch.Tensor  # [rows, D] second moments
    step: int = 0


def init_sparse_adam(table: torch.Tensor) -> SparseAdamState:
    return SparseAdamState(m=torch.zeros_like(table), v=torch.zeros_like(table))


def coalesce_row_grads(
    indices: torch.Tensor, row_grads: torch.Tensor, *, scratch_row: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum duplicate-index row gradients.

    Returns ``(target_rows int32 [N], summed_grads [N, D])``: the head lane
    of each run of equal (sorted) indices carries its row and the run's
    summed gradient; every other lane targets ``scratch_row`` (-1: no row)
    with a zero payload. Each run is summed in lane order by one thread per
    column (``segment_reduce``; no atomics), so the card gives the same bits
    on every run, and the CPU the same bits as a sequential sum.
    """
    n = indices.shape[0]
    order = torch.argsort(indices, stable=True)
    sorted_idx = indices[order].to(torch.int32)
    is_head = torch.ones(n, dtype=torch.bool, device=indices.device)
    is_head[1:] = sorted_idx[1:] != sorted_idx[:-1]
    segment_ids = torch.cumsum(is_head, 0) - 1
    # run lengths, padded to N with empty runs (no host sync for the count)
    lengths = torch.zeros(n, dtype=torch.int64, device=indices.device).scatter_add_(
        0, segment_ids, torch.ones_like(segment_ids)
    )
    summed = torch.segment_reduce(row_grads[order], "sum", lengths=lengths, unsafe=True)
    target_rows = torch.where(is_head, sorted_idx, scratch_row).to(torch.int32)
    return target_rows, torch.where(is_head[:, None], summed[segment_ids], 0.0)


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, indices, rows, num_rows):
        ctx.save_for_backward(indices)
        # Each row gets its run's sum once and zeros from the other lanes
        # (sent to row 0): adding zeros is exact in any order.
        target_rows, summed = coalesce_row_grads(indices, rows, scratch_row=0)
        return rows.new_zeros((num_rows, rows.shape[1])).index_add_(0, target_rows, summed)

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        return None, grad.index_select(0, indices), None


def sum_rows(indices: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``zeros([num_rows, D]).index_add_(0, indices, rows)`` with each row's
    sum in the fixed order of :func:`coalesce_row_grads`, where the card's
    ``index_add_`` adds with atomics in no fixed order. Differentiable in
    ``rows`` (the gradient is a gather). Indices lie in ``[0, num_rows)``."""
    return _SumRows.apply(indices, rows, num_rows)


@torch.no_grad()
def sparse_adam_update(
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
) -> None:
    """One SparseAdam step for the rows at ``indices``, in place on
    ``table``, ``state.m`` and ``state.v`` (all with the scratch row as
    their last row, which no lane touches), at ``state.step + 1``, which it
    advances: :func:`sparse_adam_apply` with the step's scalars formed here."""
    state.step += 1
    sparse_adam_apply(table, state, indices, row_grads, **kernels.adam_row(
        table.device, step=state.step, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))


@torch.no_grad()
def sparse_adam_apply(
    table: torch.Tensor,
    state: SparseAdamState,
    indices: torch.Tensor,
    row_grads: torch.Tensor,
    *,
    scalars: torch.Tensor,
    decay: bool,
) -> None:
    """The update of :func:`sparse_adam_update` with the step's f32
    scalars on the device (``kernels.adam_scalars``' row) and ``state.step``
    left as it is: what a train step runs, its scalars read from a table
    of per-step scalars (``train/step.py``)."""
    # non-head lanes masked: each live row is the target of one lane
    target_rows, grads = coalesce_row_grads(indices, row_grads.to(table.dtype), scratch_row=-1)
    kernels.sparse_adam_rows(
        table, state.m, state.v, target_rows, grads, scalars=scalars, decay=decay
    )


def unfused_row_update(
    table: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    idx: torch.Tensor,
    grads: torch.Tensor,
    *,
    gather: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    scatter: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], object],
    **hyper,
) -> None:
    """The row update in separate passes, in place: ``gather(t, idx)`` of
    m, v and the weights, :func:`adam_rows` (``hyper``: its keywords), then
    ``scatter(t, idx, rows)`` of the three back. With the masked plain row
    functions it is ``kernels.sparse_adam_rows``' plain version; with the
    masked row kernels, the composition the fused kernel replaced on the
    mesh path; with the unmasked ones at scratch-row targets, the one it
    replaced on one device."""
    m_rows = gather(m, idx)
    v_rows = gather(v, idx)
    w_rows = gather(table, idx)
    w_new, m_new, v_new = adam_rows(w_rows, m_rows, v_rows, grads, **hyper)
    scatter(table, idx, w_new)
    scatter(m, idx, m_new)
    scatter(v, idx, v_new)


def adam_rows(
    w_rows: torch.Tensor,
    m_rows: torch.Tensor,
    v_rows: torch.Tensor,
    grads: torch.Tensor,
    *,
    scalars: torch.Tensor | None = None,
    decay: bool = False,
    step: int | None = None,
    lr: float | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Adam arithmetic of gathered rows: ``(new weights, new m, new
    v)``, the step's scalars as ``kernels.sparse_adam_rows`` takes them (the
    f32 row of ``kernels.adam_scalars`` and ``decay``, or by value). One
    eager op per step of the by-value form on the card, each 0-d scalar of
    the row where that form had its Python scalar, and each division by a
    Python scalar a multiply by the row's reciprocal (which is how eager
    PyTorch divides on the card): the arithmetic of
    :func:`unfused_row_update`, which ``csrc/rows.cu``
    (``sparse_adam_rows``) repeats op for op, so all compute the same
    bits. Every operation rounds to nearest, the square root too
    (:func:`sqrt_rn`), on the CPU as on the card."""
    s, decay = kernels._adam_row(w_rows, scalars, decay, step, lr, b1, b2, eps, weight_decay)
    b1_, one_b1, b2_, one_b2, inv_bc1, inv_bc2, eps_, lr_, lr_wd = s.unbind()
    m_new = b1_ * m_rows + one_b1 * grads
    v_new = b2_ * v_rows + one_b2 * torch.square(grads)
    m_hat = m_new * inv_bc1
    v_hat = v_new * inv_bc2
    delta = lr_ * m_hat / (sqrt_rn(v_hat) + eps_)
    if decay:
        delta = delta + lr_wd * w_rows
    return w_rows - delta, m_new, v_new


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The f32 square root rounded to nearest, as ``__fsqrt_rn`` in the
    kernel and ``torch.sqrt`` on the card. On the CPU, ``torch.sqrt`` calls
    MKL's vector math (VML) on 2048-element chunks across PyTorch's threads:
    it is off by an ulp or two in some elements, and when several threads
    make a process's first VML call together, MKL can return one chunk at
    about 12 correct bits (PyTorch 2.13, MKL 2024.2). numpy's sqrt is the
    IEEE instruction, one thread."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)
