"""The sharded training steps and the sharded exact top-k (port of
``ttamm_tpu/parallel/step.py``).

torch has no jit, so :func:`make_sharded_train_step` is a thin wrapper
around ``make_train_step(..., mesh=)``, kept so that a reader of the JAX
package finds the counterpart. :func:`make_sharded_multi_train_step` and
:func:`make_sharded_multi_eval_loss_step` are the JAX scanned steps: on a
card K steps of the mesh in one call, every step past the first a replay
of one captured CUDA graph of the sharded step, collectives included
(``train/step.py`` ``make_multi_train_step(mesh=)``); on the CPU (gloo
ranks) the loop of K steps.

:func:`sharded_mips_topk` is the eval's distributed search: each model shard
searches its own item rows (its pad rows never among them, blocked ids
mapped to its range), the shards' top-k are all-gathered over ``model`` and
merged by the ``small_k_topk`` kernel, ties to the lowest global id. Only
``[B, k]``-sized results cross the link, never the corpus.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..models.two_tower import ModelConfig
from ..ops import kernels
from ..ops.topk import mips_topk
from ..train.step import (
    TrainStepConfig,
    make_multi_eval_loss_step,
    make_multi_train_step,
    make_train_step,
)
from .mesh import MODEL_AXIS, all_gather_rows, axis_index, axis_size


def make_sharded_train_step(cfg: ModelConfig, tscfg: TrainStepConfig, mesh: DeviceMesh):
    """The training step on this rank's part of a placed state
    (``make_train_step(cfg, tscfg, mesh=mesh)``; tensor-parallel where the
    state was placed so)."""
    return make_train_step(cfg, tscfg, mesh=mesh)


def make_sharded_multi_train_step(cfg: ModelConfig, tscfg: TrainStepConfig, mesh: DeviceMesh):
    """``multi(state, data, u_all [K, B], p_all [K, B], *, generator,
    dropout_generator=None) -> (state, losses [K])``: K sharded steps in one
    call, bit for bit K calls of :func:`make_sharded_train_step`, the
    generators' draws included (the JAX package scans them in one device
    call; here replays of one captured step on a card)."""
    return make_multi_train_step(cfg, tscfg, mesh=mesh)


def make_sharded_multi_eval_loss_step(cfg: ModelConfig, tscfg: TrainStepConfig, mesh: DeviceMesh):
    """``multi(state, data, u_all [K, B], p_all [K, B], *, generator) ->
    losses [K]``: K sharded eval-loss steps in one call
    (``make_multi_eval_loss_step(mesh=)``)."""
    return make_multi_eval_loss_step(cfg, tscfg, mesh=mesh)


@torch.no_grad()
def sharded_mips_topk(
    queries: torch.Tensor,
    local_items: torch.Tensor,
    *,
    k: int,
    mesh: DeviceMesh,
    num_valid_rows: int,
    mask_rows: torch.Tensor | None = None,
    normalize_queries: bool = False,
    score_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an item corpus row-sharded over ``model``.

    ``queries`` ``[B, D]`` are the same on every model rank; ``local_items``
    is this shard's ``[rows, D]`` slice of the corpus padded to ``rows *
    mp`` rows, of which the first ``num_valid_rows`` are items.
    ``mask_rows`` ``[B, M]`` holds global item ids to block (ids >= the item
    count are padding). Returns ``(scores f32 [B, k], global ids int64
    [B, k])``, descending, ties to the lowest id; where fewer than ``k``
    items are left, the tail scores ``-inf`` with id -1. Pad rows are never
    returned.
    """
    if normalize_queries:
        queries = F.normalize(queries, dim=-1)
    rows = local_items.shape[0]
    base = axis_index(mesh, MODEL_AXIS) * rows
    valid = min(max(num_valid_rows - base, 0), rows)
    k_local = min(k, rows)  # one width on every shard, for the gather
    batch = queries.shape[0]
    scores = queries.new_full((batch, k_local), float("-inf"), dtype=torch.float32)
    ids = torch.full((batch, k_local), -1, dtype=torch.int64, device=queries.device)
    if valid:
        local_mask = None
        if mask_rows is not None:
            local = mask_rows.long() - base
            local_mask = torch.where((local >= 0) & (local < valid), local, rows)
        kk = min(k_local, valid)
        s, i = mips_topk(
            queries, local_items, k=kk, num_valid_rows=valid, mask_rows=local_mask,
            score_dtype=score_dtype,
        )
        scores[:, :kk], ids[:, :kk] = s, i + base
    # [mp * B, k_local] shard-major -> [B, mp * k_local]
    mp = axis_size(mesh, MODEL_AXIS)
    all_scores = all_gather_rows(scores, mesh, MODEL_AXIS).view(mp, batch, k_local)
    all_ids = all_gather_rows(ids, mesh, MODEL_AXIS).view(mp, batch, k_local)
    all_scores = all_scores.permute(1, 0, 2).reshape(batch, mp * k_local).contiguous()
    all_ids = all_ids.permute(1, 0, 2).reshape(batch, mp * k_local)
    top, pos = kernels.small_k_topk(all_scores, min(k, mp * k_local))
    return top, torch.gather(all_ids, 1, pos.long())


def make_sharded_topk(
    mesh: DeviceMesh,
    *,
    k: int,
    num_valid_rows: int,
    normalize_queries: bool = False,
    score_dtype: str = "float32",
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """``search(queries, local_items, mask_rows=None) -> (scores, ids)``:
    :func:`sharded_mips_topk` with its settings bound."""

    def search(queries, local_items, mask_rows=None):
        return sharded_mips_topk(
            queries, local_items, k=k, mesh=mesh, num_valid_rows=num_valid_rows,
            mask_rows=mask_rows, normalize_queries=normalize_queries, score_dtype=score_dtype,
        )

    return search
