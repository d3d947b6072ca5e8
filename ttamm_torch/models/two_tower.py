"""Two-tower model: towers, similarity and adaptive mimic as one
``nn.Module`` (port of ``ttamm_tpu/models/two_tower.py``).

The model is built in eval mode with gradients off (serving, export);
``ttamm_torch.train.state.create_train_state`` switches a model to training
(dropout on, gradients on its dense layers)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch
from torch import nn

from ..device import resolve_device
from .adaptive_mimic import MimicTables, augment, mimic_forward
from .encoders import Tower, TowerConfig, parse_tower_config


@dataclass(frozen=True)
class ModelConfig:
    user_tower: TowerConfig
    item_tower: TowerConfig
    similarity: str = "cosine"  # 'cosine' | 'dot'
    mimic_enabled: bool = True
    mimic_init_std: float = 0.02
    # Mimic tables on sparse-row Adam instead of dense AdamW (the JAX
    # ``adaptive_mimic.sparse``): each then ends in a zero scratch row.
    mimic_sparse: bool = False

    @property
    def embedding_dim(self) -> int:
        return self.user_tower.output_dim


def parse_model_config(
    model_cfg: Mapping[str, Any] | None,
    *,
    user_feature_dim: int,
    item_feature_dim: int,
) -> ModelConfig:
    """Resolve the YAML ``model:`` section, as the JAX package does."""
    cfg = dict(model_cfg or {})
    compute_dtype = str(cfg.get("precision", "float32")).lower()
    if compute_dtype in {"bf16", "bfloat16"}:
        compute_dtype = "bfloat16"
    elif compute_dtype in {"fp32", "float32"}:
        compute_dtype = "float32"
    else:
        raise ValueError(f"Unsupported model.precision: {compute_dtype}")
    user_tower = parse_tower_config(
        cfg.get("user_encoder", {}), feature_dim=user_feature_dim,
        compute_dtype=compute_dtype,
    )
    item_tower = parse_tower_config(
        cfg.get("item_encoder", {}), feature_dim=item_feature_dim,
        compute_dtype=compute_dtype,
    )
    similarity = str(cfg.get("similarity", "cosine")).lower()
    if similarity not in {"cosine", "dot"}:
        raise ValueError(f"Unsupported similarity function: {similarity}")
    mimic_cfg = dict(cfg.get("adaptive_mimic", {}) or {})
    mimic_enabled = bool(mimic_cfg.get("enabled", True))
    if mimic_enabled and user_tower.output_dim != item_tower.output_dim:
        raise ValueError(
            "Adaptive mimic requires user and item embedding dimensions to match."
        )
    return ModelConfig(
        user_tower=user_tower,
        item_tower=item_tower,
        similarity=similarity,
        mimic_enabled=mimic_enabled,
        mimic_init_std=float(mimic_cfg.get("init_std", 0.02)),
        mimic_sparse=bool(mimic_cfg.get("sparse", False)),
    )


def similarity_scores(
    cfg: ModelConfig, user_embedding: torch.Tensor, item_embedding: torch.Tensor
) -> torch.Tensor:
    """Row-wise similarity (cosine or dot) between matching rows."""
    if cfg.similarity == "cosine":
        u = user_embedding / user_embedding.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        v = item_embedding / item_embedding.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return (u * v).sum(dim=-1)
    return (user_embedding * item_embedding).sum(dim=-1)


class TwoTower(nn.Module):
    """User and item towers plus the mimic tables, in eval mode.

    With ``seed`` the parameters are initialised on the CPU from
    ``torch.Generator().manual_seed(seed)`` (so one seed gives the same
    weights on every device) and then moved to ``device`` (``None``: the
    CUDA card); without it they are left for a loader
    (``ttamm_torch.models.convert``) to fill. A table on the sparse-row
    optimizer (an ID table with ``sparse: true``, both mimic tables with
    ``mimic_sparse``) carries one zero scratch row after its ``num_users`` /
    ``num_items`` rows, as in the JAX ``init_model``; only that optimizer
    writes it and nothing reads it.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        num_users: int,
        num_items: int,
        seed: int | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed)) if seed is not None else None
        self.cfg = cfg
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.user_tower = Tower(
            cfg.user_tower, num_users, generator=gen,
            extra_rows=int(cfg.user_tower.embedding.sparse),
        )
        self.item_tower = Tower(
            cfg.item_tower, num_items, generator=gen,
            extra_rows=int(cfg.item_tower.embedding.sparse),
        )
        self.mimic = (
            MimicTables(
                num_users=num_users, num_items=num_items,
                embedding_dim=cfg.embedding_dim, init_std=cfg.mimic_init_std,
                extra_rows=int(cfg.mimic_sparse), generator=gen,
            )
            if cfg.mimic_enabled
            else None
        )
        self.requires_grad_(False)  # inference only
        self.to(device)
        self.eval()

    def tables(self) -> dict[str, torch.Tensor]:
        """The row tables by their JAX names (the live weights)."""
        tables = {
            "user_id": self.user_tower.id_embedding.weight,
            "item_id": self.item_tower.id_embedding.weight,
        }
        if self.mimic is not None:
            tables["user_aug"] = self.mimic.user_aug.weight
            tables["item_aug"] = self.mimic.item_aug.weight
        return tables

    def dense_parameters(self) -> list[tuple[str, nn.Parameter]]:
        """The dense parameters, each with its JAX pytree path under
        ``dense/`` (a ``.../w`` is the transpose of the ``nn.Linear``
        weight)."""
        out: list[tuple[str, nn.Parameter]] = []
        for key, layer in self.dense_layers():
            out.append((f"{key}/w", layer.weight))
            out.append((f"{key}/b", layer.bias))
        return out

    def dense_layers(self) -> list[tuple[str, nn.Linear]]:
        """The linear layers of both towers with their JAX pytree paths
        under ``dense/`` (``user_tower/gate/fc1``, ...), in
        :meth:`dense_parameters` order."""
        return [(f"{side}_tower/{name}", layer) for side in ("user", "item")
                for name, layer in self.tower(side).named_linears()]

    def tower(self, side: str) -> Tower:
        if side not in {"user", "item"}:
            raise ValueError(f"side must be 'user' or 'item', got {side!r}")
        return self.user_tower if side == "user" else self.item_tower

    @torch.no_grad()
    def encode_tower(
        self,
        side: str,
        indices: torch.Tensor,
        features: torch.Tensor | None = None,
        *,
        augment_with_mimic: bool = False,
    ) -> torch.Tensor:
        """Gather + tower forward (+ mimic augmentation) for one side."""
        emb = self.tower(side)(indices, features)
        if augment_with_mimic and self.mimic is not None:
            emb = augment(self.mimic.table(side)(indices), emb)
        return emb

    @torch.no_grad()
    def forward(
        self,
        user_inputs: Mapping[str, torch.Tensor],
        item_inputs: Mapping[str, torch.Tensor],
        *,
        return_embeddings: bool = False,
    ) -> dict[str, torch.Tensor]:
        """Eval forward on positive pairs (the JAX ``model_forward``): keys
        ``score``, ``mimic_user_loss``/``mimic_item_loss`` when mimic is on,
        and the embeddings when asked for."""
        u_idx, i_idx = user_inputs["indices"], item_inputs["indices"]
        user_embedding = self.encode_tower("user", u_idx, user_inputs.get("features"))
        item_embedding = self.encode_tower("item", i_idx, item_inputs.get("features"))
        outputs: dict[str, torch.Tensor] = {}
        if self.mimic is not None:
            user_embedding, item_embedding, mu_loss, mi_loss = mimic_forward(
                self.mimic.user_aug(u_idx), self.mimic.item_aug(i_idx),
                user_embedding, item_embedding,
            )
            outputs["mimic_user_loss"] = mu_loss
            outputs["mimic_item_loss"] = mi_loss
        if return_embeddings:
            outputs["user_embedding"] = user_embedding
            outputs["item_embedding"] = item_embedding
        outputs["score"] = similarity_scores(self.cfg, user_embedding, item_embedding)
        return outputs
