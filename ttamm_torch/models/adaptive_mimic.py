"""Adaptive mimic mechanism: per-user and per-item augmentation tables
(port of ``ttamm_tpu/models/adaptive_mimic.py``).

At inference the table rows are added to the base tower outputs
(``augment``). ``mimic_forward`` also returns the two mimic losses, which
only training consumes.
"""

from __future__ import annotations

import torch
from torch import nn


class MimicTables(nn.Module):
    """``user_aug`` [num_users, D] and ``item_aug`` [num_items, D] tables,
    initialised N(0, init_std) when a generator is given. ``extra_rows``
    appends zero scratch rows to both (the layout of a table on the
    sparse-row optimizer, as the JAX ``init_mimic_tables`` builds it)."""

    def __init__(
        self,
        *,
        num_users: int,
        num_items: int,
        embedding_dim: int,
        init_std: float = 0.02,
        extra_rows: int = 0,
        generator: torch.Generator | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        if num_users <= 0 or num_items <= 0:
            raise ValueError("num_users and num_items must be positive.")
        self.user_aug = nn.Embedding(num_users + extra_rows, embedding_dim, device=device)
        self.item_aug = nn.Embedding(num_items + extra_rows, embedding_dim, device=device)
        if generator is not None:
            with torch.no_grad():
                for table, rows in ((self.user_aug, num_users), (self.item_aug, num_items)):
                    table.weight[:rows].normal_(0.0, init_std, generator=generator)
                    table.weight[rows:].zero_()

    def table(self, side: str) -> nn.Embedding:
        return self.user_aug if side == "user" else self.item_aug


def augment(aug_rows: torch.Tensor | None, base_embedding: torch.Tensor) -> torch.Tensor:
    """Inference-side augmentation: base embedding plus the table rows."""
    if aug_rows is None:
        return base_embedding
    return base_embedding + aug_rows.reshape(base_embedding.shape)


def mimic_forward(
    user_aug_rows: torch.Tensor,
    item_aug_rows: torch.Tensor,
    user_embedding: torch.Tensor,
    item_embedding: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(augmented_user, augmented_item, mimic_user_loss, mimic_item_loss)``;
    each loss is the mean squared distance of a table's rows to the detached
    opposite tower's embedding."""
    mimic_user_loss = torch.mean((user_aug_rows - item_embedding.detach()) ** 2)
    mimic_item_loss = torch.mean((item_aug_rows - user_embedding.detach()) ** 2)
    return (
        user_embedding + user_aug_rows,
        item_embedding + item_aug_rows,
        mimic_user_loss,
        mimic_item_loss,
    )
