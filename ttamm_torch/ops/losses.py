"""Training losses: the sampled BCE retrieval loss and the category-alignment
regulariser (port of ``ttamm_tpu/ops/losses.py``).

- ``bce_with_logits`` is ``nn.BCEWithLogitsLoss`` (mean), written in the
  stable form ``max(x, 0) - x*y + log1p(exp(-|x|))`` as the JAX package does.
- ``category_alignment_loss``: mean over the non-major categories with >= 2
  batch members of the squared Frobenius distance between that category's
  batch covariance and the major category's (id 0; ids are
  frequency-ordered). Categories are the static set ``[0, max_categories)``;
  ids outside it are ignored. The per-category second moments come from the
  ``segment_second_moments`` kernel (operands rounded to bf16, f32 sums, as
  the TPU kernel computes them) through an autograd function whose backward
  is the backward kernel. The port has no f32 second path for them.
  Under a mesh each rank computes the counts, sums and second moments of its
  data shard's rows with the same kernels, and the ``[C]``, ``[C, D]`` and
  ``[C, D, D]`` statistics are summed over ``data`` before the loss, so every
  rank holds the global loss and its gradient reaches each rank's own rows
  once (``all_reduce_statistic``).
"""

from __future__ import annotations

import torch

from . import kernels
from .sparse_adam import sum_rows


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean binary cross-entropy on logits."""
    x, y = logits, labels
    return torch.mean(torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs())))


class SegmentSecondMoments(torch.autograd.Function):
    """``M2[c] = sum_{cat(n)=c} bf16(x_n) bf16(x_n)^T`` with the kernel's
    gradient ``dx_n = bf16(G_c + G_c^T) bf16(x_n)``.

    The rows are grouped by category once (the kernels' work list, on the
    device) and the backward reuses the forward's grouping.
    """

    @staticmethod
    def forward(ctx, cat_ids: torch.Tensor, x: torch.Tensor, num_categories: int):
        ctx.save_for_backward(cat_ids, x)
        ctx.grouping = kernels.category_grouping(cat_ids, num_categories)
        return kernels.segment_second_moments(cat_ids, x, num_categories, ctx.grouping)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        cat_ids, x = ctx.saved_tensors
        h = (grad + grad.transpose(-1, -2)).contiguous()
        return None, kernels.segment_second_moments_bwd(cat_ids, x, h, ctx.grouping), None


def category_alignment_loss(
    item_category_ids: torch.Tensor,
    item_embeddings: torch.Tensor,
    *,
    max_categories: int = 64,
    mesh=None,
) -> torch.Tensor:
    """Covariance-alignment regulariser over the batch's item embeddings
    (``[N]`` int category ids, ``[N, D]`` f32 embeddings), from per-category
    counts, sums and second moments; a 0-d tensor, with no host sync.
    ``mesh``: the rows are this rank's data shard of the batch, and the
    loss is the global batch's."""
    c = max_categories
    x = item_embeddings.contiguous()
    ids = item_category_ids.to(torch.int64)
    # ids outside [0, C) go to a dropped bucket C
    key = torch.where((ids >= 0) & (ids < c), ids, c)
    # whole numbers: exact in any order of addition
    counts = torch.zeros(c + 1, dtype=x.dtype, device=x.device).index_add_(
        0, key, torch.ones_like(key, dtype=x.dtype)
    )[:c]
    sums = sum_rows(key, x, c + 1)[:c]  # in a fixed order: no float atomics
    m2 = SegmentSecondMoments.apply(item_category_ids, x, c)
    if mesh is not None:
        from ..parallel.mesh import DATA_AXIS, all_reduce_statistic

        d = x.shape[1]
        flat = all_reduce_statistic(
            torch.cat([counts, sums.reshape(-1), m2.reshape(-1)]), mesh, DATA_AXIS
        )
        counts, sums, m2 = flat[:c], flat[c : c + c * d].view(c, d), flat[c + c * d :].view(c, d, d)

    safe_n = counts.clamp_min(1.0)
    means = sums / safe_n[:, None]
    # cov_c = (M2_c - n mu mu^T) / (n - 1), zero when n <= 1
    mu_outer = means[:, :, None] * means[:, None, :]
    covs = (m2 - counts[:, None, None] * mu_outer) / (counts - 1.0).clamp_min(1.0)[:, None, None]
    covs = torch.where((counts > 1.0)[:, None, None], covs, 0.0)

    diffs = covs - covs[0][None]
    contribs = torch.sum(diffs * diffs, dim=(1, 2))  # [C]
    use = (counts >= 2.0) & (torch.arange(c, device=x.device) != 0)
    loss_sum = torch.sum(torch.where(use, contribs, 0.0))
    compared = use.sum()
    # zero when the major category has < 2 members or nothing to compare
    valid = (counts[0] >= 2.0) & (compared > 0)
    return torch.where(valid, loss_sum / compared.clamp_min(1), 0.0)
