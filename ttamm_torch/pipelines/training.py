"""Training on the card: config -> data -> train loop -> checkpoints (port of
``run_single_experiment`` in ``ttamm_tpu/pipelines/training.py``).

The steps follow the JAX pipeline: data prep (the port's own copy) -> the
train/validation/test split -> the padded per-user positives and the
frequency-ordered item categories -> a seeded training state on the device.
Then, each epoch: a permutation of the training interactions from
``np.random.default_rng(seed * 1000003 + epoch)``, the full batches, then the
remainder batch (drop_last=False). Step losses stay on the device until the
epoch ends (no per-step host sync). Each epoch logs its train loss, its
validation loss (the eval-loss step over the validation split) and its
examples/s, then writes ``{experiment}_last.pt``.

Not ported yet (ROADMAP Queue 1): the retrieval eval and its metrics, early
stopping and best-only checkpoints (the run logs this once and trains for
``num_epochs``), reports, the in-batch softmax and its options, sparse mimic
tables, ``comm_dtype``, ``packed_moments``, bf16 feature storage and the
mesh; each raises when a config asks for it. The TPU knobs
``steps_per_call`` and ``use_pallas`` are not read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..data import (
    TrainingDataset,
    build_item_categories,
    interaction_arrays,
    pack_positives,
    split_train_validation_test,
)
from ..device import resolve_device
from ..models.two_tower import parse_model_config
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.optim import parse_dense_opt_config
from ..train.state import BatchData, TrainState, create_train_state
from ..train.step import TrainStepConfig, make_eval_loss_step, make_train_step
from ..utils import configure_logging, get_logger
from .export import prepare_data

logger = get_logger("pipeline")


@dataclass
class TrainingResult:
    num_users: int
    num_items: int
    steps: int
    train_loss: list[float] = field(default_factory=list)  # per epoch
    val_loss: list[float] = field(default_factory=list)  # per epoch
    first_step_loss: float | None = None
    examples_per_second: float | None = None  # over every epoch's train loop
    train_seconds: float = 0.0
    checkpoint_path: Path | None = None
    # what the run trained with, for callers that go on using it
    state: TrainState | None = None
    data: BatchData | None = None
    step_config: TrainStepConfig | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _refuse_unported(config: Mapping[str, Any]) -> None:
    """Raise on each option of the JAX pipeline this port does not run yet."""
    training = dict(config.get("training", {}))
    data = dict(config.get("data", {}))
    mesh = dict(config.get("mesh", {}) or {})
    refused = {
        "training.loss": str(training.get("loss", "bce")).lower() != "bce",
        "training.comm_dtype": str(training.get("comm_dtype", "float32")).lower() != "float32",
        "training.packed_moments": bool(training.get("packed_moments", False)),
        "data.features_dtype": str(data.get("features_dtype", "float32")).lower() != "float32",
        "mesh": int(mesh.get("data_parallel", 1)) * int(mesh.get("model_parallel", 1)) > 1,
    }
    for name, asked in refused.items():
        if asked:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP Queue 1)")


def _dataset_loss(
    eval_step, state, data, users: np.ndarray, items: np.ndarray, batch_size: int,
    generator: torch.Generator, device: torch.device,
) -> float:
    """Sample-weighted mean eval loss over a split; one host read at the end."""
    if len(users) == 0:
        return float("nan")
    u = torch.from_numpy(users).to(device)
    p = torch.from_numpy(items).to(device)
    losses, sizes = [], []
    for start in range(0, len(users), batch_size):
        losses.append(eval_step(
            state, data, u[start : start + batch_size], p[start : start + batch_size],
            generator=generator,
        ))
        sizes.append(min(batch_size, len(users) - start))
    values = torch.stack(losses).cpu().numpy()
    return float(np.dot(values, sizes) / sum(sizes))


def run_single_experiment(
    config: Mapping[str, Any],
    *,
    device: torch.device | str | None = None,
    max_steps: int | None = None,
    dataset: TrainingDataset | None = None,
) -> TrainingResult:
    """Train ``config`` on ``device`` (``None``: the CUDA card) for
    ``training.num_epochs`` epochs, or until ``max_steps`` steps in all.
    ``dataset`` skips the data prep when the caller already holds it."""
    config = dict(config)
    configure_logging(str((config.get("logging") or {}).get("level", "INFO")))
    _refuse_unported(config)
    dev = resolve_device(device)
    seed = int((config.get("experiment") or {}).get("seed", 0))
    experiment_name = str((config.get("experiment") or {}).get("name", "experiment"))
    data_cfg = dict(config.get("data", {}))
    training_cfg = dict(config.get("training", {}))
    if data_cfg.get("use_cache"):
        logger.warning("data.use_cache: the port has no dataset cache; preparing the data")
    logger.info(
        "The retrieval eval, early stopping and best-only checkpoints are not "
        "ported yet: training runs every epoch and keeps the last checkpoint."
    )

    dataset = dataset if dataset is not None else prepare_data(config)
    num_users = len(dataset.user_mapping)
    num_items = len(dataset.item_mapping)
    train_df, val_df, _ = split_train_validation_test(
        dataset.interactions,
        train_fraction=data_cfg.get("train_fraction"),
        test_fraction=data_cfg.get("test_fraction"),
        seed=seed,
    )
    logger.info(
        "Dataset | users=%d items=%d train=%d validation=%d",
        num_users, num_items, len(train_df), len(val_df),
    )
    result = TrainingResult(num_users=num_users, num_items=num_items, steps=0)
    if train_df.empty:
        logger.warning("No training interactions available; exiting early.")
        return result

    model_cfg = parse_model_config(
        config.get("model", {}),
        user_feature_dim=dataset.user_feature_matrix.shape[1],
        item_feature_dim=dataset.item_feature_matrix.shape[1],
    )
    categories = build_item_categories(dataset.items, num_items=num_items)
    positives_cap = data_cfg.get("positives_cap")
    positives = pack_positives(
        dataset.user_positive_items, num_users=num_users, num_items=num_items,
        cap=int(positives_cap) if positives_cap else None,
    )

    def on_device(matrix: np.ndarray) -> torch.Tensor | None:
        return torch.from_numpy(np.ascontiguousarray(matrix)).to(dev) if matrix.size else None

    data = BatchData(
        user_features=on_device(dataset.user_feature_matrix.astype(np.float32)),
        item_features=on_device(dataset.item_feature_matrix.astype(np.float32)),
        positive_rows=on_device(positives.rows),
        category_ids=on_device(categories.category_ids) if categories is not None else None,
    )

    batch_size = int(training_cfg.get("batch_size", 512))
    num_epochs = int(training_cfg.get("num_epochs", 10))
    loss_weights = dict(training_cfg.get("loss_weights", {}))
    clip = training_cfg.get("gradient_clip_norm")
    if int(training_cfg.get("mixed_negatives", 0)):
        logger.warning("training.mixed_negatives ignored: only the in_batch_softmax loss uses it.")
    tscfg = TrainStepConfig(
        num_items=num_items,
        negatives_per_positive=int(training_cfg.get("negatives_per_positive", 5)),
        lambda_mimic_user=float(loss_weights.get("mimic_user", 0.0)),
        lambda_mimic_item=float(loss_weights.get("mimic_item", 0.0)),
        lambda_category_alignment=float(loss_weights.get("category_alignment", 0.0)),
        gradient_clip_norm=float(clip) if clip is not None else None,
        # as the JAX pipeline: the category count rounded up to a multiple
        # of 8, at most 64, unless the config sets it
        cal_max_categories=int(training_cfg.get(
            "category_alignment_max_categories",
            min(64, -(-len(categories.category_names) // 8) * 8) if categories else 0,
        )),
        sparse_weight_decay=float(training_cfg.get("sparse_weight_decay", 0.0)),
        opt=parse_dense_opt_config(
            training_cfg,
            total_steps=max(1, -(-len(train_df) // batch_size)) * num_epochs,
        ),
    )
    state = create_train_state(
        model_cfg, num_users=num_users, num_items=num_items, seed=seed, device=dev
    )
    train_step = make_train_step(model_cfg, tscfg)
    eval_step = make_eval_loss_step(model_cfg, tscfg)

    checkpoint_cfg = dict(training_cfg.get("checkpointing", {}))
    checkpoint_dir = Path(checkpoint_cfg.get("dir", "artifacts/checkpoints"))
    start_epoch = 1
    if training_cfg.get("resume_from"):
        state, meta = load_checkpoint(Path(training_cfg["resume_from"]), state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        logger.info("Resumed from %s at epoch %d", training_cfg["resume_from"], start_epoch)

    train_users, train_items = interaction_arrays(train_df)
    val_users, val_items = (
        interaction_arrays(val_df) if not val_df.empty
        else (np.empty(0, np.int32), np.empty(0, np.int32))
    )
    generator = torch.Generator(device=dev).manual_seed(seed)
    examples = 0
    for epoch in range(start_epoch, num_epochs + 1):
        if max_steps is not None and result.steps >= max_steps:
            break
        _sync(dev)
        epoch_start = time.perf_counter()
        perm = np.random.default_rng(seed * 1000003 + epoch).permutation(len(train_users))
        users = torch.from_numpy(train_users[perm]).to(dev)  # one upload per epoch
        items = torch.from_numpy(train_items[perm]).to(dev)
        losses, sizes = [], []
        for start in range(0, len(perm), batch_size):
            if max_steps is not None and result.steps >= max_steps:
                break
            state, metrics = train_step(
                state, data, users[start : start + batch_size],
                items[start : start + batch_size], generator=generator,
            )
            losses.append(metrics["loss"])
            sizes.append(min(batch_size, len(perm) - start))
            result.steps += 1
        values = torch.stack(losses).cpu().numpy()  # syncs the epoch's work
        epoch_seconds = time.perf_counter() - epoch_start
        if result.first_step_loss is None:
            result.first_step_loss = float(values[0])
        seen = int(sum(sizes))
        examples += seen
        result.train_seconds += epoch_seconds
        result.train_loss.append(float(np.dot(values, sizes) / seen))
        val_gen = torch.Generator(device=dev).manual_seed(seed * 1000003 + 7_000_003 + epoch)
        result.val_loss.append(_dataset_loss(
            eval_step, state, data, val_users, val_items, batch_size, val_gen, dev
        ))
        logger.info(
            "Epoch %03d/%03d | train_loss=%.4f | val_loss=%.4f | %d steps | %.1f examples/s",
            epoch, num_epochs, result.train_loss[-1], result.val_loss[-1], len(sizes),
            seen / max(epoch_seconds, 1e-9),
        )
        if bool(checkpoint_cfg.get("enabled", False)) and bool(checkpoint_cfg.get("keep_last", True)):
            result.checkpoint_path = save_checkpoint(
                checkpoint_dir, state, experiment_name=experiment_name, epoch=epoch,
                metric_name=None, metric_value=None, template="{experiment}_last.pt",
            )
    result.examples_per_second = examples / max(result.train_seconds, 1e-9)
    result.state, result.data, result.step_config = state, data, tscfg
    return result
