"""Training state: the model, its dense and sparse-row optimizer states and
the step count (port of ``ttamm_tpu/train/state.py``).

The parameters split the way the JAX package (and the reference) splits
optimizers:

- ``tables``: the user/item ID tables and the mimic tables. ID tables marked
  ``sparse: true``, and the mimic tables under ``adaptive_mimic.sparse``,
  are updated by sparse-row Adam (``opt_sparse``, ``sparse_weight_decay``)
  and carry one zero scratch row after their ``num_users`` / ``num_items``
  rows (the JAX layout); every other table is updated by the dense
  optimizer (and its weight decay).
- the dense parameters (feature MLPs, gates, projections), always on the
  dense optimizer, together with the dense tables (``opt_dense``, one
  moment per tensor in :meth:`TrainState.dense_targets` order).

The model's own eval path (``encode_corpus``, export) reads the tables'
first ``num_users`` / ``num_items`` rows, never the scratch row.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.two_tower import ModelConfig, TwoTower
from ..ops.sparse_adam import SparseAdamState, init_sparse_adam
from .optim import DenseOptState, init_dense_opt


def sparse_table_names(cfg: ModelConfig) -> tuple[str, ...]:
    names = []
    if cfg.user_tower.embedding.sparse:
        names.append("user_id")
    if cfg.item_tower.embedding.sparse:
        names.append("item_id")
    if cfg.mimic_enabled and cfg.mimic_sparse:
        names.extend(["user_aug", "item_aug"])
    return tuple(names)


def dense_table_names(cfg: ModelConfig) -> tuple[str, ...]:
    sparse = set(sparse_table_names(cfg))
    names = [n for n in ("user_id", "item_id") if n not in sparse]
    if cfg.mimic_enabled and not cfg.mimic_sparse:
        names.extend(["user_aug", "item_aug"])
    return tuple(names)


@dataclass
class TrainState:
    model: TwoTower
    opt_dense: DenseOptState  # over dense_targets()
    opt_sparse: dict[str, SparseAdamState]
    step: int = 0
    # training.packed_moments: checkpoints hold each sparse table's moments
    # as one [rows, 2D] leaf ``mv`` = [m | v] (the JAX packed layout)
    packed_moments: bool = False
    # mesh.tensor_parallel: the dense tower layers and their moments hold
    # this rank's Megatron slices over ``model`` (parallel/sharding.py)
    tensor_parallel: bool = False

    @property
    def tables(self) -> dict[str, torch.Tensor]:
        return self.model.tables()

    def dense_targets(self) -> list[tuple[str, torch.Tensor]]:
        """What the dense optimizer updates, with the JAX pytree paths of
        ``{"dense": ..., "tables": ...}``: the dense parameters, then the
        dense tables in ``dense_table_names`` order."""
        tables = self.tables
        return [(f"dense/{k}", p) for k, p in self.model.dense_parameters()] + [
            (f"tables/{n}", tables[n]) for n in dense_table_names(self.model.cfg)
        ]


@dataclass
class BatchData:
    """Device-resident dataset arrays the steps read."""

    user_features: torch.Tensor | None  # [U, Fu] or None
    item_features: torch.Tensor | None  # [I, Fi] or None
    positive_rows: torch.Tensor  # int32 [U, cap] padded per-user positives
    category_ids: torch.Tensor | None  # int32 [I] frequency-ordered primary categories
    item_log_q: torch.Tensor | None = None  # f32 [I] log train frequency (in-batch loss)


def create_train_state(
    cfg: ModelConfig,
    *,
    num_users: int,
    num_items: int,
    seed: int,
    device: torch.device | str | None = None,
    packed_moments: bool = False,
) -> TrainState:
    """A seeded model in training mode (dropout on, gradients on its dense
    layers; the tables are updated by the optimizers, not by autograd) on
    ``device`` (``None``: the CUDA card), with zero optimizer states.
    ``packed_moments`` (``training.packed_moments``) writes each sparse
    table's moments to checkpoints as one ``[rows, 2D]`` leaf, as the JAX
    packed layout does; in memory they stay two ``[rows, D]`` tensors, so
    the steps are those of the separate layout."""
    model = TwoTower(cfg, num_users=num_users, num_items=num_items, seed=seed, device=device)
    model.train()
    for _, param in model.dense_parameters():
        param.requires_grad_(True)
    state = TrainState(model=model, opt_dense=DenseOptState(m=[], v=[]), opt_sparse={},
                       packed_moments=packed_moments)
    state.opt_dense = init_dense_opt([t for _, t in state.dense_targets()])
    tables = state.tables
    state.opt_sparse = {n: init_sparse_adam(tables[n]) for n in sparse_table_names(cfg)}
    return state
