"""The training step, the eval-loss step and corpus encoding (port of
``ttamm_tpu/train/step.py``).

One training step, in the JAX step's order:

1. sample the negatives on the device (5 per positive by default);
2. gather every table's rows as fresh leaf tensors (outside the
   differentiated function, so table gradients arrive batch-row shaped);
3. run the towers (dropout from the caller's generator) and the mimic;
4. BCE over [positives; negatives] + the mimic losses + category alignment;
5. backward;
6. rebuild each dense table's gradient by an index-add into zeros;
7. the optional global-norm clip (sparse row gradients coalesced first);
8. the dense optimizer over the dense parameters and dense tables;
9. sparse-row Adam on the sparse tables.

The state is updated in place. Parity notes (as in the JAX package):
training logits are dot products whatever ``model.similarity`` says; mimic
targets are the base (pre-augmentation) opposite-tower embeddings;
negatives get mimic augmentation but no mimic loss; category alignment sees
the augmented positive and negative item embeddings; the eval loss is the
same stack without dropout and without the auxiliary terms.

Only ``loss: bce`` is ported; the in-batch softmax and its options raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..models.adaptive_mimic import mimic_forward
from ..models.two_tower import ModelConfig, TwoTower
from ..ops.losses import bce_with_logits, category_alignment_loss
from ..ops.sampling import sample_negative_items
from ..ops.sparse_adam import coalesce_row_grads, sparse_adam_update, sum_rows
from .optim import DenseOptConfig, dense_opt_update, lr_scale
from .state import BatchData, TrainState, dense_table_names, sparse_table_names


class TrainStepConfig(NamedTuple):
    num_items: int
    negatives_per_positive: int = 5
    loss_type: str = "bce"
    lambda_mimic_user: float = 0.0
    lambda_mimic_item: float = 0.0
    lambda_category_alignment: float = 0.0
    gradient_clip_norm: float | None = None
    cal_max_categories: int = 64
    sampling_rounds: int = 8
    # Decoupled weight decay on the sparse tables' touched rows (0 = SparseAdam).
    sparse_weight_decay: float = 0.0
    opt: DenseOptConfig = DenseOptConfig()


def _gather_opt(features: torch.Tensor | None, idx: torch.Tensor) -> torch.Tensor | None:
    if features is None or features.numel() == 0:
        return None
    return torch.index_select(features, 0, idx)


def _negatives(
    tscfg: TrainStepConfig,
    data: BatchData,
    u_idx: torch.Tensor,
    generator: torch.Generator | None,
    negatives: torch.Tensor | None,
) -> torch.Tensor:
    """Flat int32 ``[B * NEG]`` negatives: the injected ones, else drawn."""
    if negatives is not None:
        return negatives.reshape(-1).to(torch.int32)
    if generator is None:
        raise ValueError("a generator is needed to draw the negatives")
    return sample_negative_items(
        torch.index_select(data.positive_rows, 0, u_idx),
        num_items=tscfg.num_items,
        num_negatives=tscfg.negatives_per_positive,
        generator=generator,
        num_rounds=tscfg.sampling_rounds,
    ).reshape(-1)


def _row_indices(u_idx: torch.Tensor, item_idx_all: torch.Tensor) -> dict[str, torch.Tensor]:
    """Which rows of each table a step reads: users for the user tables,
    [positives; negatives] for the item tables."""
    return {
        "user_id": u_idx, "user_aug": u_idx,
        "item_id": item_idx_all, "item_aug": item_idx_all,
    }


def _forward_embeddings(
    model: TwoTower,
    tscfg: TrainStepConfig,
    data: BatchData,
    u_idx: torch.Tensor,
    item_idx_all: torch.Tensor,
    rows: dict[str, torch.Tensor],
    generator: torch.Generator | None,
):
    """``(user_emb, pos_emb, neg_emb [B, NEG, D], mimic_user_loss,
    mimic_item_loss)`` from pre-gathered table rows (items ordered
    [positives; negatives]); dropout only with a ``generator``."""
    batch = u_idx.shape[0]
    user_base = model.user_tower.forward_rows(
        rows["user_id"], _gather_opt(data.user_features, u_idx), generator=generator
    )
    item_base_all = model.item_tower.forward_rows(
        rows["item_id"], _gather_opt(data.item_features, item_idx_all), generator=generator
    )
    pos_base, neg_base = item_base_all[:batch], item_base_all[batch:]
    zero = user_base.new_zeros(())
    if model.cfg.mimic_enabled:
        item_aug = rows["item_aug"]
        user_emb, pos_emb, mu_loss, mi_loss = mimic_forward(
            rows["user_aug"], item_aug[:batch], user_base, pos_base
        )
        neg_emb = neg_base + item_aug[batch:]
    else:
        user_emb, pos_emb, neg_emb = user_base, pos_base, neg_base
        mu_loss = mi_loss = zero
    neg_emb = neg_emb.reshape(batch, tscfg.negatives_per_positive, -1)
    return user_emb, pos_emb, neg_emb, mu_loss, mi_loss


def _bce_stack(user_emb, pos_emb, neg_emb) -> torch.Tensor:
    pos_logits = torch.sum(user_emb * pos_emb, dim=-1)
    neg_logits = torch.einsum("bd,bnd->bn", user_emb, neg_emb).reshape(-1)
    logits = torch.cat([pos_logits, neg_logits])
    labels = torch.cat([torch.ones_like(pos_logits), torch.zeros_like(neg_logits)])
    return bce_with_logits(logits, labels)


def _check_supported(tscfg: TrainStepConfig) -> None:
    if tscfg.loss_type != "bce":
        raise NotImplementedError(
            f"training.loss={tscfg.loss_type} is not ported yet (bce only; ROADMAP Queue 1)"
        )


TrainStep = Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]


def make_train_step(cfg: ModelConfig, tscfg: TrainStepConfig) -> TrainStep:
    """Build ``train_step(state, data, u_idx, pos_idx, *, generator,
    negatives=None) -> (state, metrics)``.

    ``generator`` (on the data's device) draws the negatives and the dropout
    masks; ``negatives`` ``[B, NEG]`` replaces the draw (tests inject the
    JAX draws). The state is updated in place and returned; the metrics are
    0-d device tensors (``loss`` and the four loss terms), read by the
    caller when it likes, so a step issues no host sync.
    """
    _check_supported(tscfg)
    sparse_names = sparse_table_names(cfg)
    dense_tbl_names = dense_table_names(cfg)
    opt = tscfg.opt

    def train_step(state, data, u_idx, pos_idx, *, generator, negatives=None):
        model = state.model
        u_idx, pos_idx = u_idx.to(torch.int32), pos_idx.to(torch.int32)
        neg_flat = _negatives(tscfg, data, u_idx, generator, negatives)
        item_idx_all = torch.cat([pos_idx, neg_flat])
        row_idx = _row_indices(u_idx, item_idx_all)
        tables = state.tables
        rows = {
            n: torch.index_select(t, 0, row_idx[n]).requires_grad_()
            for n, t in tables.items()
        }

        user_emb, pos_emb, neg_emb, mu_loss, mi_loss = _forward_embeddings(
            model, tscfg, data, u_idx, item_idx_all, rows, generator
        )
        retrieval_loss = _bce_stack(user_emb, pos_emb, neg_emb)
        total = retrieval_loss
        if cfg.mimic_enabled and tscfg.lambda_mimic_user > 0:
            total = total + tscfg.lambda_mimic_user * mu_loss
        if cfg.mimic_enabled and tscfg.lambda_mimic_item > 0:
            total = total + tscfg.lambda_mimic_item * mi_loss
        cal_loss = total.new_zeros(())
        if tscfg.lambda_category_alignment > 0 and data.category_ids is not None:
            cal_loss = category_alignment_loss(
                torch.index_select(data.category_ids, 0, item_idx_all),
                torch.cat([pos_emb, neg_emb.reshape(-1, pos_emb.shape[-1])]),
                max_categories=tscfg.cal_max_categories,
            )
            total = total + tscfg.lambda_category_alignment * cal_loss

        dense = [p for _, p in model.dense_parameters()]
        grads = torch.autograd.grad(
            total, [*dense, *rows.values()], allow_unused=True
        )
        grads = [
            torch.zeros_like(x) if g is None else g
            for x, g in zip([*dense, *rows.values()], grads)
        ]
        dense_grads = grads[: len(dense)]
        row_grads = dict(zip(rows, grads[len(dense) :]))
        # table-shaped gradients of the dense tables (duplicates summed)
        table_grads = [
            sum_rows(row_idx[n], row_grads[n], tables[n].shape[0]) for n in dense_tbl_names
        ]

        if tscfg.gradient_clip_norm is not None and tscfg.gradient_clip_norm > 0:
            # Global norm over every gradient, with each sparse table's
            # duplicate rows summed first (the true gradient's norm).
            sq = sum(torch.sum(torch.square(g)) for g in dense_grads + table_grads)
            for n in sparse_names:
                _, summed = coalesce_row_grads(
                    row_idx[n], row_grads[n], scratch_row=tables[n].shape[0] - 1
                )
                sq = sq + torch.sum(torch.square(summed))
            scale = torch.clamp(tscfg.gradient_clip_norm / (torch.sqrt(sq) + 1e-6), max=1.0)
            dense_grads = [g * scale for g in dense_grads]
            table_grads = [g * scale for g in table_grads]
            row_grads = {n: g * scale for n, g in row_grads.items()}

        dense_opt_update(
            [t for _, t in state.dense_targets()], dense_grads + table_grads,
            state.opt_dense, opt,
        )
        lr_t = opt.lr * lr_scale(opt, state.step + 1)
        for n in sparse_names:
            sparse_adam_update(
                tables[n], state.opt_sparse[n], row_idx[n], row_grads[n],
                lr=lr_t, b1=opt.b1, b2=opt.b2, weight_decay=tscfg.sparse_weight_decay,
            )
        state.step += 1
        metrics = {
            "loss": total.detach(),
            "retrieval_loss": retrieval_loss.detach(),
            "mimic_user_loss": mu_loss.detach(),
            "mimic_item_loss": mi_loss.detach(),
            "category_alignment_loss": cal_loss.detach(),
        }
        return state, metrics

    return train_step


def make_eval_loss_step(cfg: ModelConfig, tscfg: TrainStepConfig) -> Callable[..., torch.Tensor]:
    """Build ``eval_loss_step(state, data, u_idx, pos_idx, *, generator,
    negatives=None) -> loss``: the BCE on [positives; sampled negatives],
    no dropout, no auxiliary terms (0-d device tensor)."""
    _check_supported(tscfg)

    @torch.no_grad()
    def eval_loss_step(state, data, u_idx, pos_idx, *, generator, negatives=None):
        u_idx, pos_idx = u_idx.to(torch.int32), pos_idx.to(torch.int32)
        neg_flat = _negatives(tscfg, data, u_idx, generator, negatives)
        item_idx_all = torch.cat([pos_idx, neg_flat])
        row_idx = _row_indices(u_idx, item_idx_all)
        rows = {n: torch.index_select(t, 0, row_idx[n]) for n, t in state.tables.items()}
        user_emb, pos_emb, neg_emb, _, _ = _forward_embeddings(
            state.model, tscfg, data, u_idx, item_idx_all, rows, None
        )
        return _bce_stack(user_emb, pos_emb, neg_emb)

    return eval_loss_step


@torch.no_grad()
def encode_corpus(
    model: TwoTower,
    side: str,
    features: torch.Tensor | None = None,
    *,
    chunk_size: int = 65536,
) -> torch.Tensor:
    """Encode every user or item through its tower (+ mimic augmentation).

    Walks the rows in contiguous chunks of ``chunk_size`` on the model's
    device and returns f32 ``[num_rows, D]`` there. ``features`` is the
    side's ``[num_rows, F]`` feature matrix (or None / empty for an ID-only
    tower); chunks of it are moved to the model's device as they are used.
    """
    tower = model.tower(side)
    table = tower.id_embedding.weight  # a sparse table ends in its scratch row
    dev = table.device
    n = tower.num_embeddings
    if features is not None and features.numel() == 0:
        features = None
    aug = model.mimic.table(side).weight if model.mimic is not None else None
    out = torch.empty((n, tower.cfg.output_dim), dtype=torch.float32, device=dev)
    for start in range(0, n, chunk_size):
        end = min(start + chunk_size, n)
        feats = None if features is None else features[start:end].to(dev)
        emb = tower.forward_rows(table[start:end], feats)
        if aug is not None:
            emb = emb + aug[start:end]
        out[start:end] = emb
    return out
