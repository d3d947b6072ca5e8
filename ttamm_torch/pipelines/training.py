"""Training on the card: config -> data -> train loop -> per-epoch eval ->
checkpoints -> retrieval artifacts (port of ``run_single_experiment`` in
``ttamm_tpu/pipelines/training.py``).

The steps follow the JAX pipeline: data prep (the port's own copy) -> the
train/validation/test split -> the padded per-user positives and the
frequency-ordered item categories -> a seeded training state on the device
-> the val and test eval plans, built once from one packed train-positives
matrix. Then, each epoch: a permutation of the training interactions from
``np.random.default_rng(seed * 1000003 + epoch)``, the full batches, then the
remainder batch (drop_last=False); step losses stay on the device until the
epoch ends (no per-step host sync). After the steps: one encode of the item
corpus, the val loss and the val retrieval eval (recall, precision, ndcg,
hit rate and map at each ``evaluation.metrics_k``), the test loss and the
test eval, the improvement bookkeeping of ``training.early_stopping`` (or
of the val loss when no metric is monitored), a copy of the best state, and
the checkpoints by ``training.checkpointing``: the best one under
``filename_template``, one per epoch unless ``save_best_only``, and
``{experiment}_last.pt``; with ``checkpointing.async_save`` (the default,
as in the JAX package) a background writer (``AsyncCheckpointer``) pulls a
device clone of the state and writes the files while the next epoch trains,
and the run waits for it before it goes on. Early stopping ends the loop;
the best state is restored at the end. Then the end-of-run diagnostics of
the JAX trainer, from samples drawn by one ``random.Random(seed)`` (the
same on every rank): ``diagnostics.item_sample_size`` items and
``user_sample_size`` users encoded with the mimic augmentation, their
embedding norms, item-neighbour category overlap, user / feature
alignment, fusion-gate and mimic-row statistics, and the feature
correlations of the item sample; and ``recommendations.sample_users``
users' top ``recommendations.top_k`` items over the final corpus, their
history filtered out. Last, ``serving.score_dtype: auto`` re-runs the final
val eval in bf16 and takes bf16 only if no recall@k drops by more than
``bf16_recall_gate``, the item index (TTFLAT1) and embeddings are written
to ``evaluation.faiss.index_path`` / ``embedding_path``, with the best
state's ``user_embeddings.npy`` and ``vocab.json`` beside the index (that
directory is a serving bundle, ``RetrievalService.from_artifacts``), and
the loss plot, the Markdown report (with the sample recommendations) and
the JSON embedding summary go to ``diagnostics.loss_plot_path``,
``report_path`` and ``embedding_summary_path``. Without matplotlib the
plot is left out with a warning and the report is written without it.

``data.use_cache`` keeps the prepared dataset in ``data.cache_dir``
(``ttamm_torch.data.cache``) and reads it on the next run.

``run_training`` is the entry point: one run, or one per point of the
Cartesian ``experiment.grid`` (named ``{experiment.name}_sweepNN``), then
the sweep ledger at ``experiment.benchmark_report`` when the config names
one (``ttamm_torch.reporting.write_benchmark_report``).

With ``evaluation.faiss.enabled: false`` the eval takes the sampled path
(``candidate_samples`` random candidates per user).
``evaluation.faiss.batch_size`` (the chunk of the JAX package's ``chunked``
search) is not read: the port sizes a chunk from its score budget, and the
answer does not depend on the chunk (``ttamm_torch/ops/topk.py``).

The mesh: ``mesh: {data_parallel: dp, model_parallel: mp}`` with dp x mp > 1
runs under ``torchrun --nproc_per_node dp*mp -m ttamm_torch.train``, one
process per device (NCCL on cards, gloo with ``--device cpu``). Every rank
builds the same data and seeded state, keeps its part
(``parallel.sharding``: row-sharded tables, moments and dataset arrays,
replicated dense parameters), walks the same global batches through the
sharded step (negatives from a generator seeded alike on every rank,
dropout from one seeded per data shard, so the model ranks of a data shard
draw the same masks) and runs the same eval (the sharded search when mp >
1). ``training.update_routing`` / ``update_capacity_factor`` choose the
sparse tables' exchange of row gradients, ``mesh.embedding_exchange``
(``gspmd`` | ``alltoall``) how the tables' rows are read
(``parallel/exchange.py``). ``mesh.tensor_parallel: true`` also splits the dense
tower layers (the feature MLPs and the σ-gates) and their AdamW moments
over ``model`` in Megatron column / row slices (``parallel/sharding.py``,
``models/encoders.py``), as the JAX trainer does on a mesh; on one device
the flag has no effect, as there. The eval's and the end-of-run encodes
read a model whose split layers are gathered whole once per epoch and once
at the end (``encode_model``). ``checkpointing.sharded`` (``auto``: more than
one process, where the JAX package says more than one host) writes
per-rank shard directories in the JAX format; otherwise the state is
gathered and rank 0 writes the flat ``.npz`` (the gather stays on the main
thread; only the write goes to the background). ``resume_from`` and the
export CLI take either. Every rank takes part in the end-of-run
sample encodes (the sharded row reads); only rank 0 logs and writes the
serving bundle, the reports and the ledger. Under ``data.use_cache`` rank 0
writes the cache and the others read it after a barrier.

The retrieval loss is ``training.loss``: ``bce`` (sampled negatives) or
``in_batch_softmax`` with ``softmax_temperature``, ``logq_correction`` (over
the train split's log item frequencies, floored at one occurrence, built
only when the loss reads them) and ``mixed_negatives``; with
``adaptive_mimic.sparse`` the mimic tables take sparse-row Adam
(``configs/in_batch_softmax.yaml`` sets both), on one device and on the
mesh.

``training.comm_dtype: bfloat16`` rounds every table-row gradient once at
the wire (``train/step.py``), on one device too; ``data.features_dtype:
bfloat16`` stores the user and item feature matrices on the device in
bf16, rounded once from the host float32 matrices (the dataset and its
cache stay float32), widened in the towers. The end-of-run diagnostics
read the sample embeddings through the device (bf16) features and the
feature correlations and user alignment from the host float32 matrices,
as the JAX trainer does. ``configs/pod_2x4.yaml`` sets all three wire
options.

``training.packed_moments`` writes each sparse table's Adam moments to its
checkpoints as one ``[rows, 2D]`` leaf ``mv``, the JAX packed layout (a TPU
layout: in memory the moments stay two tensors, so the steps are the
separate layout's); checkpoints of either layout resume into either, on one
device and on the mesh.
``model.precision: bfloat16`` runs the towers' matmuls on bf16 operands
with float32 sums (``ttamm_torch/models/encoders.py``).

``diagnostics.profile_dir`` traces the first epoch's train loop (not its
eval) with ``torch.profiler`` (host ops, and on a card its kernels) and
writes the Chrome trace ``{experiment.name}_epoch{NNN}.pt.trace.json``
there, as the JAX trainer writes its ``jax.profiler`` trace; on a mesh rank
0 alone traces and writes.

``training.steps_per_call`` (``auto``, the JAX rule of
:func:`_pick_steps_per_call`: the whole epoch at the canonical corpus, or an
int >= 1) runs an epoch's full batches in chunks of that many steps through
``make_multi_train_step``, the remainder batch through the single step,
and the eval loss's full batches through ``make_multi_eval_loss_step``; on
a card the steps of a chunk are replays of one captured CUDA graph of the
step (``train/step.py``), bit for bit the eager steps. On a mesh the chunks
go through ``make_sharded_multi_train_step`` (the JAX trainer's choice
where ``batch_size`` splits evenly over ``data``; the port's sharded step
takes any split) and the eval loss's through
``make_sharded_multi_eval_loss_step``: the sharded step's collectives are
captured with it, and the owner routing's overflow is taken on the device.
``1`` runs eager single steps. The TPU knobs ``use_pallas`` and
``mesh.multi_host`` are not read.
"""

from __future__ import annotations

import copy
import json
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

import pandas as pd
import torch.nn.functional as F

from ..data import (
    TrainingDataset,
    build_item_categories,
    interaction_arrays,
    pack_positives,
    parse_category_tokens,
    positives_from_frame,
    split_train_validation_test,
)
from ..data.cache import cache_path, dataset_cache_key, load_training_dataset, save_training_dataset
from ..device import resolve_device
from ..evaluation import (
    EvalPlan,
    RankingMetrics,
    analyze_item_neighbors,
    build_eval_plan,
    compute_feature_correlations,
    compute_mimic_statistics,
    compute_ranking_metrics,
    encode_user_batch,
    evaluate_retrieval,
    evaluate_retrieval_metrics,
    summarize_embedding_norms,
    summarize_gate_values,
    summarize_user_alignment,
)
from ..evaluation.retrieval import full_corpus, model_mesh, side_rows
from ..models.convert import train_state_to_flat
from ..models.encoders import tower_gate_values
from ..models.two_tower import TwoTower, parse_model_config
from ..ops.topk import mips_topk
from ..parallel import (
    DATA_AXIS,
    build_mesh,
    encode_model,
    gather_state_flat,
    is_primary_host,
    maybe_initialize_distributed,
    pad_batch_data,
    pad_state_rows,
    parse_mesh_config,
    place_data,
    place_state,
)
from ..reporting import (
    save_loss_curves,
    write_benchmark_report,
    write_embedding_summary,
    write_recommendation_report,
)
from ..parallel.step import make_sharded_multi_eval_loss_step, make_sharded_multi_train_step
from ..serve.flat_index import build_flat_index
from ..train.checkpoint import (
    AsyncCheckpointer,
    checkpoint_path,
    load_checkpoint,
    save_checkpoint,
)
from ..train.sharded_checkpoint import (
    MANIFEST,
    load_sharded_checkpoint,
    save_sharded_checkpoint,
    state_to_host_shards,
)
from ..train.optim import parse_dense_opt_config
from ..train.state import BatchData, TrainState, create_train_state
from ..train.step import (
    LOSSES,
    TrainStepConfig,
    encode_corpus,
    make_eval_loss_step,
    make_multi_eval_loss_step,
    make_multi_train_step,
    make_train_step,
)
from ..utils import configure_logging, expand_grid, get_logger
from .export import prepare_data

logger = get_logger("pipeline")


@dataclass
class EarlyStoppingController:
    """max/min monitored-metric controller (ref ``training.py:85-116``)."""

    metric: str
    mode: str = "max"
    patience: int = 3
    min_delta: float = 0.0
    best_value: float | None = None
    best_epoch: int | None = None
    epochs_without_improvement: int = 0

    def update(self, value: float | None, epoch: int) -> bool:
        """Record ``value`` for ``epoch``; True when training should stop."""
        if value is None:
            return False
        if self.best_value is None:
            improved = True
        elif self.mode == "max":
            improved = value > (self.best_value + self.min_delta)
        else:
            improved = value < (self.best_value - self.min_delta)
        if improved:
            self.best_value = value
            self.best_epoch = epoch
            self.epochs_without_improvement = 0
            return False
        self.epochs_without_improvement += 1
        return self.epochs_without_improvement >= max(self.patience, 1)


def extract_metric_value(metrics_summary: Any, metric: str) -> float | None:
    """Parse ``recall@10``-style monitor names (ref ``training.py:119-138``)."""
    if metrics_summary is None:
        return None
    metric = metric.lower()
    if "@" in metric:
        prefix, k_str = metric.split("@", 1)
        try:
            k = int(k_str)
        except ValueError:
            return None
        table = getattr(metrics_summary, prefix, None)
        if table is None:
            return None
        return table.get(k)
    value = getattr(metrics_summary, metric, None)
    if isinstance(value, (int, float)):
        return float(value)
    return None


@dataclass
class TrainingResult:
    num_users: int
    num_items: int
    steps: int
    train_loss: list[float] = field(default_factory=list)  # per epoch
    val_loss: list[float] = field(default_factory=list)  # per epoch
    test_loss: list[float] = field(default_factory=list)  # per epoch
    # per epoch; None where the split is empty
    val_metrics: list[RankingMetrics | None] = field(default_factory=list)
    test_metrics: list[RankingMetrics | None] = field(default_factory=list)
    # per epoch, host-clock seconds by phase: train, val_loss (the corpus
    # encode included), val_eval, test_loss, test_eval, ckpt
    phase_seconds: list[dict[str, float]] = field(default_factory=list)
    first_step_loss: float | None = None
    examples_per_second: float | None = None  # over every epoch's train loop
    train_seconds: float = 0.0
    checkpoint_path: Path | None = None  # the last one ({experiment}_last.pt)
    best_epoch: int | None = None
    best_checkpoint_path: Path | None = None
    best_val_metrics: RankingMetrics | None = None
    serving_score_dtype: str | None = None  # of the written index; None: not written
    checkpoint_wait_seconds: float = 0.0  # host clock, the end-of-run wait for the writer
    loss_plot_path: Path | None = None  # None: not written (no losses, or no matplotlib)
    embedding_summary_path: Path | None = None
    # what the run trained with (the best state), for callers that go on using it
    state: TrainState | None = None
    data: BatchData | None = None
    step_config: TrainStepConfig | None = None
    val_plan: EvalPlan | None = None
    # what the sweep ledger reads (ttamm_tpu's TrainingResult)
    config: Mapping[str, Any] | None = None  # this run's config
    runtime_seconds: float = 0.0  # host clock, data prep to artifacts
    best_metric: float | None = None  # the monitored value (or loss) of the best epoch
    overrides: Mapping[str, Any] | None = None  # this grid point's values


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pick_steps_per_call(num_full_batches: int, cap: int = 8192) -> int:
    """``training.steps_per_call: auto`` (the JAX trainer's rule): the K <=
    ``cap`` that makes an epoch's ``num_full // K`` multi-step calls plus
    ``num_full % K`` single steps fewest, the whole epoch wherever it fits
    under the cap."""
    if num_full_batches <= 1:
        return max(num_full_batches, 1)
    best_k, best_cost = 1, num_full_batches
    for k in range(2, min(cap, num_full_batches) + 1):
        cost = num_full_batches // k + num_full_batches % k
        if cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def _steps_per_call(training_cfg: Mapping[str, Any], num_full_batches: int) -> int:
    """``training.steps_per_call``: ``auto`` (or unset) or an int >= 1."""
    raw = training_cfg.get("steps_per_call", "auto")
    if raw is None or str(raw).lower() == "auto":
        return _pick_steps_per_call(num_full_batches)
    if int(raw) < 1:
        raise ValueError(f"training.steps_per_call must be auto or >= 1, got {raw!r}")
    return int(raw)


def _dataset_loss(
    eval_step, multi_eval_step, state, data, users: np.ndarray, items: np.ndarray,
    batch_size: int, generator: torch.Generator, device: torch.device,
) -> float:
    """Sample-weighted mean eval loss over a split; one host read at the end.
    The full batches go through ``multi_eval_step`` in one call (None: one
    by one), the remainder batch through ``eval_step``."""
    if len(users) == 0:
        return float("nan")
    u = torch.from_numpy(users).to(device)
    p = torch.from_numpy(items).to(device)
    losses, sizes = [], []
    num_full = len(users) // batch_size
    start = 0
    if multi_eval_step is not None and num_full:
        full = num_full * batch_size
        losses.append(multi_eval_step(
            state, data, u[:full].view(num_full, batch_size), p[:full].view(num_full, batch_size),
            generator=generator,
        ))
        sizes += [batch_size] * num_full
        start = full
    for start in range(start, len(users), batch_size):
        losses.append(eval_step(
            state, data, u[start : start + batch_size], p[start : start + batch_size],
            generator=generator,
        ).reshape(1))
        sizes.append(min(batch_size, len(users) - start))
    values = torch.cat(losses).cpu().numpy()
    return float(np.dot(values, sizes) / sum(sizes))


def dropout_generator(seed: int, mesh, device: torch.device) -> torch.Generator:
    """The dropout masks' generator of this rank of a mesh run: one stream a
    data shard, shared by its model ranks, which compute the same batch
    rows (so the replicated dense parameters stay equal on every rank)."""
    return torch.Generator(device=device).manual_seed(
        seed * 1000003 + 5_000_011 + mesh.get_local_rank(DATA_AXIS)
    )


def features_dtype(data_cfg: Mapping[str, Any]) -> torch.dtype:
    """``data.features_dtype`` (float32 | bfloat16): the device dtype of the
    feature matrices."""
    name = str(data_cfg.get("features_dtype", "float32")).lower()
    if name not in {"float32", "bfloat16"}:
        raise ValueError(f"Unsupported data.features_dtype: {name}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def train_step_config(config: Mapping[str, Any], *, num_items: int, num_categories: int,
                      total_steps: int) -> TrainStepConfig:
    """The step configuration the trainer runs ``config`` with, for a
    corpus of ``num_items`` items in ``num_categories`` categories and a
    run of ``total_steps`` steps (the learning-rate schedule's length)."""
    training_cfg = dict(config.get("training", {}))
    loss_type = str(training_cfg.get("loss", "bce")).lower()
    loss_weights = dict(training_cfg.get("loss_weights", {}))
    clip = training_cfg.get("gradient_clip_norm")
    mixed_negatives = int(training_cfg.get("mixed_negatives", 0))
    if mixed_negatives and loss_type != "in_batch_softmax":
        logger.warning(
            "training.mixed_negatives=%d ignored: only the in_batch_softmax loss consumes a "
            "mixed-negative pool.", mixed_negatives,
        )
        mixed_negatives = 0
    return TrainStepConfig(
        num_items=num_items,
        negatives_per_positive=int(training_cfg.get("negatives_per_positive", 5)),
        loss_type=loss_type,
        lambda_mimic_user=float(loss_weights.get("mimic_user", 0.0)),
        lambda_mimic_item=float(loss_weights.get("mimic_item", 0.0)),
        lambda_category_alignment=float(loss_weights.get("category_alignment", 0.0)),
        gradient_clip_norm=float(clip) if clip is not None else None,
        # as the JAX pipeline: the category count rounded up to a multiple
        # of 8, at most 64, unless the config sets it
        cal_max_categories=int(training_cfg.get(
            "category_alignment_max_categories",
            min(64, -(-num_categories // 8) * 8) if num_categories else 0,
        )),
        softmax_temperature=float(training_cfg.get("softmax_temperature", 1.0)),
        logq_correction=bool(training_cfg.get("logq_correction", True)),
        mixed_negatives=mixed_negatives,
        sparse_weight_decay=float(training_cfg.get("sparse_weight_decay", 0.0)),
        update_routing=str(training_cfg.get("update_routing", "allgather")).lower(),
        update_capacity_factor=float(training_cfg.get("update_capacity_factor", 2.0)),
        comm_dtype=str(training_cfg.get("comm_dtype", "float32")).lower(),
        embedding_exchange=str((config.get("mesh") or {}).get("embedding_exchange", "gspmd")).lower(),
        opt=parse_dense_opt_config(training_cfg, total_steps=total_steps),
    )


def _serving_dtype_request(config: Mapping[str, Any]) -> tuple[str, float]:
    """``serving.score_dtype`` (auto | float32 | bfloat16, with the fp32 /
    bf16 aliases) and ``serving.bf16_recall_gate``."""
    serving = dict(config.get("serving", {}) or {})
    requested = str(serving.get("score_dtype", "auto")).lower()
    requested = {"fp32": "float32", "bf16": "bfloat16"}.get(requested, requested)
    if requested not in {"auto", "float32", "bfloat16"}:
        raise ValueError(
            f"Unsupported serving.score_dtype: {requested!r} (expected auto, float32, or bfloat16)"
        )
    return requested, float(serving.get("bf16_recall_gate", 0.002))


def run_single_experiment(
    config: Mapping[str, Any],
    *,
    device: torch.device | str | None = None,
    max_steps: int | None = None,
    dataset: TrainingDataset | None = None,
    overrides: Mapping[str, Any] | None = None,
) -> TrainingResult:
    """Train ``config`` on ``device`` (``None``: the CUDA card) for
    ``training.num_epochs`` epochs, or until early stopping or ``max_steps``
    steps in all, evaluating after every epoch. ``dataset`` skips the data
    prep when the caller already holds it; ``overrides`` (the grid point's
    values) is recorded for the ledger."""
    start_time = time.time()
    config = dict(config)
    configure_logging(str((config.get("logging") or {}).get("level", "INFO")))
    feat_dtype = features_dtype(dict(config.get("data", {})))
    dev = resolve_device(device)
    mesh_cfg = parse_mesh_config(config.get("mesh", {}) or {})
    tensor_parallel = bool((config.get("mesh") or {}).get("tensor_parallel", False))
    mesh = None
    if mesh_cfg.num_devices > 1:
        dev = maybe_initialize_distributed(dev)
        mesh = build_mesh(mesh_cfg, dev.type)
        if not is_primary_host():
            configure_logging("WARNING")  # rank 0 logs
    seed = int((config.get("experiment") or {}).get("seed", 0))
    experiment_name = str((config.get("experiment") or {}).get("name", "experiment"))
    data_cfg = dict(config.get("data", {}))
    training_cfg = dict(config.get("training", {}))

    eval_cfg = dict(config.get("evaluation", {}))
    metrics_k = eval_cfg.get("metrics_k", [10])
    metrics_k = [int(metrics_k)] if isinstance(metrics_k, int) else [int(k) for k in metrics_k]
    candidate_samples = int(eval_cfg.get("candidate_samples", 500))
    mips_cfg = dict(eval_cfg.get("mips", eval_cfg.get("faiss", {})) or {})
    mips_enabled = bool(mips_cfg.get("enabled", True))
    index_path = Path(mips_cfg.get("index_path", "artifacts/faiss/items.index"))
    embedding_path = Path(mips_cfg.get("embedding_path", "artifacts/faiss/item_embeddings.npy"))
    eval_user_batch = int(eval_cfg.get("user_batch_size", 1024))
    requested_dtype, gate_eps = _serving_dtype_request(config)
    diag_cfg = dict(config.get("diagnostics", {}) or {})
    report_path = Path(diag_cfg.get("report_path", "artifacts/reports/recommendation_report.md"))
    loss_plot_target = Path(diag_cfg.get("loss_plot_path", "artifacts/reports/loss_curve.png"))
    embedding_summary_path = Path(
        diag_cfg.get("embedding_summary_path", "artifacts/reports/embedding_diagnostics.json")
    )
    profile_dir = diag_cfg.get("profile_dir")

    monitor_cfg = dict(training_cfg.get("early_stopping", {}))
    monitor_metric = monitor_cfg.get("metric") if monitor_cfg.get("enabled", False) else None
    min_delta = float(monitor_cfg.get("min_delta", 0.0))
    early = None
    if monitor_metric:
        mode = str(monitor_cfg.get("mode", "max")).lower()
        if mode not in {"max", "min"}:
            raise ValueError("early_stopping.mode must be either 'max' or 'min'")
        early = EarlyStoppingController(
            metric=str(monitor_metric), mode=mode,
            patience=int(monitor_cfg.get("patience", 3)), min_delta=min_delta,
        )

    checkpoint_cfg = dict(training_cfg.get("checkpointing", {}))
    checkpoint_enabled = bool(checkpoint_cfg.get("enabled", False))
    checkpoint_dir = Path(checkpoint_cfg.get("dir", "artifacts/checkpoints"))
    checkpoint_template = str(checkpoint_cfg.get(
        "filename_template", "{experiment}_{metric}_{value:.4f}_epoch{epoch}.pt"
    ))
    save_best_only = bool(checkpoint_cfg.get("save_best_only", True))
    keep_last = bool(checkpoint_cfg.get("keep_last", True))
    async_save = bool(checkpoint_cfg.get("async_save", True))

    dataset = dataset if dataset is not None else _prepare_data(config, mesh is not None)
    num_users = len(dataset.user_mapping)
    num_items = len(dataset.item_mapping)
    train_df, val_df, test_df = split_train_validation_test(
        dataset.interactions,
        train_fraction=data_cfg.get("train_fraction"),
        test_fraction=data_cfg.get("test_fraction"),
        seed=seed,
    )
    logger.info(
        "Dataset | users=%d items=%d train=%d validation=%d test=%d",
        num_users, num_items, len(train_df), len(val_df), len(test_df),
    )
    result = TrainingResult(
        num_users=num_users, num_items=num_items, steps=0, config=config, overrides=overrides,
    )
    if train_df.empty:
        logger.warning("No training interactions available; exiting early.")
        result.runtime_seconds = time.time() - start_time
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

    def on_device(matrix: np.ndarray, dtype: torch.dtype | None = None) -> torch.Tensor | None:
        if not matrix.size:
            return None
        return torch.from_numpy(np.ascontiguousarray(matrix)).to(dev).to(dtype)

    loss_type = str(training_cfg.get("loss", "bce")).lower()
    if loss_type not in LOSSES:
        raise ValueError(f"Unsupported training.loss: {loss_type}")
    if float(training_cfg.get("softmax_temperature", 1.0)) <= 0.0:
        raise ValueError("training.softmax_temperature must be > 0")
    logq = bool(training_cfg.get("logq_correction", True))
    item_log_q = None
    if loss_type == "in_batch_softmax" and logq:
        # log train-split item frequency, floored at one occurrence (an item
        # unseen in training can still be an eval-loss candidate)
        counts = np.bincount(train_df["item_idx"].to_numpy(), minlength=num_items).astype(np.float64)
        item_log_q = np.log(np.maximum(counts, 1.0) / max(counts.sum(), 1.0)).astype(np.float32)
    data = BatchData(
        user_features=on_device(dataset.user_feature_matrix.astype(np.float32), feat_dtype),
        item_features=on_device(dataset.item_feature_matrix.astype(np.float32), feat_dtype),
        positive_rows=on_device(positives.rows),
        category_ids=on_device(categories.category_ids) if categories is not None else None,
        item_log_q=None if item_log_q is None else on_device(item_log_q),
    )

    batch_size = int(training_cfg.get("batch_size", 512))
    num_epochs = int(training_cfg.get("num_epochs", 10))
    tscfg = train_step_config(
        config, num_items=num_items,
        num_categories=len(categories.category_names) if categories else 0,
        total_steps=max(1, -(-len(train_df) // batch_size)) * num_epochs,
    )
    state = create_train_state(
        model_cfg, num_users=num_users, num_items=num_items, seed=seed, device=dev,
        packed_moments=bool(training_cfg.get("packed_moments", False)),
    )
    train_step = make_train_step(model_cfg, tscfg, mesh=mesh)
    eval_step = make_eval_loss_step(model_cfg, tscfg, mesh=mesh)
    steps_per_call = _steps_per_call(training_cfg, len(train_df) // batch_size)
    multi_step = multi_eval_step = None
    if steps_per_call > 1 and mesh is None:
        multi_step = make_multi_train_step(model_cfg, tscfg)
        multi_eval_step = make_multi_eval_loss_step(model_cfg, tscfg)
    elif steps_per_call > 1:
        # JAX takes its sharded multi-step where the batch splits evenly over
        # data and a mesh-hinted one elsewhere; the port's sharded step takes
        # any split, so it serves both
        multi_step = make_sharded_multi_train_step(model_cfg, tscfg, mesh)
        multi_eval_step = make_sharded_multi_eval_loss_step(model_cfg, tscfg, mesh)
    logger.info("steps_per_call=%s -> %d%s", training_cfg.get("steps_per_call", "auto"),
                steps_per_call, "" if multi_step is None else " | full batches through "
                + ("make_multi_train_step" if mesh is None else "make_sharded_multi_train_step"))

    start_epoch = 1
    resume = Path(training_cfg["resume_from"]) if training_cfg.get("resume_from") else None
    if resume is not None and not (resume / MANIFEST).is_file():
        state, meta = load_checkpoint(resume, state)
    if mesh is not None:
        mp = mesh_cfg.model_parallel
        state = place_state(mesh, pad_state_rows(state, mp), tensor_parallel=tensor_parallel)
        data = place_data(mesh, pad_batch_data(data, mp))
        logger.info(
            "Mesh | data_parallel=%d model_parallel=%d processes=%d tp=%s routing=%s exchange=%s "
            "comm_dtype=%s", mesh_cfg.data_parallel, mp, mesh_cfg.num_devices, tensor_parallel,
            tscfg.update_routing, tscfg.embedding_exchange, tscfg.comm_dtype,
        )
    if resume is not None and (resume / MANIFEST).is_file():
        state, meta = load_sharded_checkpoint(resume, state, mesh)
    if resume is not None:
        start_epoch = int(meta.get("epoch", 0)) + 1
        logger.info("Resumed from %s at epoch %d", resume, start_epoch)
    sharded_raw = checkpoint_cfg.get("sharded", "auto")
    world = mesh_cfg.num_devices if mesh is not None else 1
    sharded_ckpt = world > 1 if sharded_raw == "auto" else bool(sharded_raw)
    # the flat format on a mesh is written by rank 0 alone
    writes_checkpoints = sharded_ckpt or is_primary_host()
    checkpointer = (
        AsyncCheckpointer(sharded=sharded_ckpt, mesh=mesh)
        if checkpoint_enabled and async_save else None
    )
    search_mesh = model_mesh(mesh)

    # The eval plans, built once from one packed train-positives matrix.
    train_positive_map = positives_from_frame(train_df)
    val_plan = test_plan = None
    if mips_enabled and (not val_df.empty or not test_df.empty):
        blocked = torch.from_numpy(
            pack_positives(train_positive_map, num_users=num_users, num_items=num_items).rows
        ).to(dev)
        val_plan, test_plan = (
            build_eval_plan(
                frame, train_positive_map, num_users=num_users, num_items=num_items,
                k_values=metrics_k, user_batch_size=eval_user_batch, blocked_rows=blocked,
            )
            for frame in (val_df, test_df)
        )

    def split_arrays(frame):
        if frame.empty:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        return interaction_arrays(frame)

    train_users, train_items = interaction_arrays(train_df)
    val_users, val_items = split_arrays(val_df)
    test_users, test_items = split_arrays(test_df)

    def retrieval_metrics(model, plan, frame, item_embeddings, rng_seed: int) -> RankingMetrics:
        if plan is not None:
            return evaluate_retrieval_metrics(
                model, data, plan=plan, k_values=metrics_k, item_embeddings=item_embeddings,
                mesh=search_mesh,
            )
        predictions, ground_truth = evaluate_retrieval(
            model, data, val_interactions=frame, train_positive_map=train_positive_map,
            num_items=num_items, k_values=metrics_k, use_mips=mips_enabled,
            candidate_samples=candidate_samples, rng=np.random.default_rng(rng_seed),
            user_batch_size=eval_user_batch, item_embeddings=item_embeddings, mesh=search_mesh,
        )
        return compute_ranking_metrics(predictions, ground_truth, metrics_k, include_per_user=False)

    # negatives: one stream, the same on every rank
    generator = torch.Generator(device=dev).manual_seed(seed)
    # the eval losses' streams, re-seeded each epoch (one object a split, so
    # the multi-step eval's captured graph is kept across epochs)
    val_gen, test_gen = torch.Generator(device=dev), torch.Generator(device=dev)
    step_kwargs = {}
    if mesh is not None:
        step_kwargs["dropout_generator"] = dropout_generator(seed, mesh, dev)
    examples = 0
    best_metric_value: float | None = None
    best_state: TrainState | None = None
    last_val_metrics = None
    for epoch in range(start_epoch, num_epochs + 1):
        if max_steps is not None and result.steps >= max_steps:
            break
        _sync(dev)
        epoch_start = time.perf_counter()
        perm = np.random.default_rng(seed * 1000003 + epoch).permutation(len(train_users))
        users = torch.from_numpy(train_users[perm]).to(dev)  # one upload per epoch
        items = torch.from_numpy(train_items[perm]).to(dev)
        losses, sizes = [], []
        profiler = None
        if profile_dir and epoch == start_epoch and is_primary_host():
            profiler = _train_loop_profiler(dev)
            profiler.start()
        start = 0
        if multi_step is not None:
            # the full batches in chunks of steps_per_call (the last one, or
            # one cut by max_steps, shorter), each one multi-step call
            full = len(perm) // batch_size
            if max_steps is not None:
                full = max(min(full, max_steps - result.steps), 0)
            for first in range(0, full, steps_per_call):
                steps = min(steps_per_call, full - first)
                rows = slice(first * batch_size, (first + steps) * batch_size)
                state, chunk = multi_step(
                    state, data, users[rows].view(steps, batch_size),
                    items[rows].view(steps, batch_size), generator=generator, **step_kwargs,
                )
                losses.append(chunk)
                sizes += [batch_size] * steps
                result.steps += steps
            start = full * batch_size
        for start in range(start, len(perm), batch_size):
            if max_steps is not None and result.steps >= max_steps:
                break
            state, metrics = train_step(
                state, data, users[start : start + batch_size],
                items[start : start + batch_size], generator=generator, **step_kwargs,
            )
            losses.append(metrics["loss"].reshape(1))
            sizes.append(min(batch_size, len(perm) - start))
            result.steps += 1
        values = torch.cat(losses).cpu().numpy()  # syncs the epoch's work
        epoch_seconds = time.perf_counter() - epoch_start
        if profiler is not None:
            _write_trace(profiler, dev, Path(profile_dir), experiment_name, epoch)
        if result.first_step_loss is None:
            result.first_step_loss = float(values[0])
        seen = int(sum(sizes))
        examples += seen
        result.train_seconds += epoch_seconds
        avg_loss = float(np.dot(values, sizes) / seen)
        result.train_loss.append(avg_loss)
        logger.info(
            "Epoch %03d/%03d | train_loss=%.4f | %d steps | %.1f examples/s",
            epoch, num_epochs, avg_loss, len(sizes), seen / max(epoch_seconds, 1e-9),
        )

        phase = {"train": epoch_seconds}
        tick = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal tick
            _sync(dev)
            now = time.perf_counter()
            phase[name] = now - tick
            tick = now

        # One encode of the item corpus serves both evals.
        eval_model = encode_model(state, mesh)
        item_embeddings = None
        if len(val_users) or len(test_users):
            item_embeddings = _encode_side(eval_model, data, "item", search_mesh)
        val_loss_value = float("nan")
        val_metrics = test_metrics = None
        monitor_value: float | None = None
        if len(val_users):
            val_gen.manual_seed(seed * 1000003 + 7_000_003 + epoch)
            val_loss_value = _dataset_loss(
                eval_step, multi_eval_step, state, data, val_users, val_items, batch_size,
                val_gen, dev,
            )
            lap("val_loss")
            val_metrics = retrieval_metrics(eval_model, val_plan, val_df, item_embeddings,
                                            seed * 997 + epoch)
            lap("val_eval")
            last_val_metrics = val_metrics
            for k in metrics_k:
                logger.info(
                    "Validation @%d | recall=%.4f precision=%.4f ndcg=%.4f hit_rate=%.4f map=%.4f",
                    k, val_metrics.recall[k], val_metrics.precision[k], val_metrics.ndcg[k],
                    val_metrics.hit_rate[k], val_metrics.map[k],
                )
            if monitor_metric:
                monitor_value = extract_metric_value(val_metrics, str(monitor_metric))
        result.val_loss.append(val_loss_value)
        result.val_metrics.append(val_metrics)
        test_loss_value = float("nan")
        if len(test_users):
            test_gen.manual_seed(seed * 1000003 + 9_000_001 + epoch)
            test_loss_value = _dataset_loss(
                eval_step, multi_eval_step, state, data, test_users, test_items, batch_size,
                test_gen, dev,
            )
            lap("test_loss")
            test_metrics = retrieval_metrics(eval_model, test_plan, test_df, item_embeddings,
                                             seed * 199 + epoch)
            lap("test_eval")
        result.test_loss.append(test_loss_value)
        result.test_metrics.append(test_metrics)
        logger.info("Epoch %03d | val_loss=%.4f | test_loss=%.4f", epoch, val_loss_value, test_loss_value)

        # Improvement bookkeeping (ref ``training.py:1589-1620``): the
        # monitored metric, else the val loss (the train loss without one).
        if early is not None and monitor_value is not None:
            should_stop = early.update(monitor_value, epoch)
            improved = early.best_epoch == epoch
            if improved:
                best_metric_value = early.best_value
        else:
            candidate = val_loss_value if not np.isnan(val_loss_value) else avg_loss
            should_stop = False
            improved = best_metric_value is None or candidate < best_metric_value - min_delta
            if improved:
                best_metric_value = float(candidate)
        if improved:
            result.best_epoch = epoch
            best_state = copy.deepcopy(state)  # on the device
            result.best_val_metrics = val_metrics or last_val_metrics

        if checkpoint_enabled:
            jobs: list[tuple[str, dict[str, Any]]] = []  # role, save_checkpoint's arguments

            def job(role: str, metric_name: str, value: float, template: str) -> None:
                jobs.append((role, dict(
                    directory=checkpoint_dir, experiment_name=experiment_name, epoch=epoch,
                    metric_name=metric_name, metric_value=value, template=template,
                )))

            if improved:
                value = monitor_value if monitor_value is not None else best_metric_value
                job("best", str(monitor_metric or "loss"), value, checkpoint_template)
            if not save_best_only:
                job("epoch", "epoch", float(epoch), checkpoint_template)
            if keep_last:
                job("last", "last", float(epoch), "{experiment}_last.pt")
            specs = [spec for _, spec in jobs]
            if not jobs:
                paths = []
            elif checkpointer is not None:
                if mesh is not None and not sharded_ckpt:
                    snapshot = gather_state_flat(state, mesh)  # collectives: the main thread
                else:  # a device clone nothing writes; an improved epoch's best copy is one
                    snapshot = best_state if improved else copy.deepcopy(state)
                if writes_checkpoints:
                    paths = checkpointer.submit(snapshot, specs)
                else:
                    paths = [checkpoint_path(**spec) for spec in specs]
            else:
                host = _checkpoint_host(state, mesh, sharded_ckpt)  # one pull
                if sharded_ckpt:
                    paths = [save_sharded_checkpoint(mesh=mesh, host_pieces=host, **spec)
                             for spec in specs]
                elif writes_checkpoints:
                    paths = [save_checkpoint(state=host, **spec) for spec in specs]
                else:
                    paths = [checkpoint_path(**spec) for spec in specs]
            for (role, _), path in zip(jobs, paths):
                if role == "best":
                    result.best_checkpoint_path = path
                elif role == "last":
                    result.checkpoint_path = path
        lap("ckpt")
        result.phase_seconds.append(phase)
        logger.info("Epoch timing | %s", " ".join(f"{k}={v:.2f}s" for k, v in phase.items()))
        if should_stop:
            logger.info(
                "Early stopping triggered after %d epochs without improvement.",
                early.epochs_without_improvement,
            )
            break

    if checkpointer is not None:  # every file on disk before anyone can load one
        tick = time.perf_counter()
        checkpointer.wait()
        result.checkpoint_wait_seconds = time.perf_counter() - tick
        logger.info("Checkpoint writer drained in %.3f s", result.checkpoint_wait_seconds)
    if best_state is not None:
        state = best_state
    elif result.checkpoint_path is not None and result.best_checkpoint_path is None:
        result.best_checkpoint_path = result.checkpoint_path
    if result.best_val_metrics is None:
        result.best_val_metrics = last_val_metrics
    result.examples_per_second = examples / max(result.train_seconds, 1e-9)
    result.state, result.data, result.step_config = state, data, tscfg
    result.val_plan = val_plan

    if best_metric_value is None and result.train_loss:  # as the JAX trainer
        best_metric_value = result.train_loss[-1]
    result.best_metric = best_metric_value

    final_model = encode_model(state, mesh)
    local_items = _encode_side(final_model, data, "item", search_mesh)  # the final corpus
    diagnostics = run_diagnostics(
        final_model, data, dataset, full_corpus(final_model, local_items, search_mesh),
        diagnostics=diag_cfg, recommendations=dict(config.get("recommendations", {}) or {}),
        seed=seed, mesh=search_mesh,
    )
    if mips_enabled:
        _write_retrieval_artifacts(
            result, final_model, dataset, metrics_k, requested_dtype, gate_eps, index_path, embedding_path,
            search_mesh, local_items,
        )
    if is_primary_host():
        _write_reports(
            result, diagnostics, metrics_k, str(monitor_metric) if monitor_metric else "val_loss",
            report_path=report_path, loss_plot_target=loss_plot_target,
            embedding_summary_path=embedding_summary_path,
        )
    result.runtime_seconds = time.time() - start_time
    return result


def run_experiment_grid(
    config: Mapping[str, Any],
    grid: Mapping[str, Sequence[Any]],
    *,
    device: torch.device | str | None = None,
    max_steps: int | None = None,
    dataset: TrainingDataset | None = None,
) -> list[TrainingResult]:
    """One run per point of the Cartesian ``grid`` (dotted path -> values;
    ``ttamm_tpu/pipelines/training.py run_experiment_grid``). A finished
    point drops its state, data and eval plan before the next one starts,
    so no two points hold a model on the device at once. ``dataset`` is
    ``config``'s prepared data; a point that overrides a ``data.`` key
    prepares its own."""
    if not grid:
        return [run_single_experiment(config, device=device, max_steps=max_steps, dataset=dataset)]
    results: list[TrainingResult] = []
    for run_config, overrides in expand_grid(config, grid):
        own_data = any(str(key).startswith("data.") for key in overrides)
        result = run_single_experiment(
            run_config, device=device, max_steps=max_steps,
            dataset=None if own_data else dataset, overrides=overrides,
        )
        result.state = result.data = result.val_plan = None
        results.append(result)
    return results


def run_training(
    config: Mapping[str, Any],
    *,
    device: torch.device | str | None = None,
    max_steps: int | None = None,
    dataset: TrainingDataset | None = None,
) -> list[TrainingResult] | TrainingResult:
    """Entry point: one run, or the sweep of ``experiment.grid``, then the
    ledger at ``experiment.benchmark_report`` (written by rank 0) when the
    config names one (``ttamm_tpu/pipelines/training.py run_training``).
    Returns the one result of a single run, else the list."""
    experiment_cfg = dict(config.get("experiment") or {})
    results = run_experiment_grid(
        config, experiment_cfg.get("grid") or {}, device=device, max_steps=max_steps,
        dataset=dataset,
    )
    benchmark_path = experiment_cfg.get("benchmark_report")
    if benchmark_path and is_primary_host():
        write_benchmark_report(Path(benchmark_path), results)
    return results[0] if len(results) == 1 else results


def _encode_side(model, data: BatchData, side: str, search_mesh) -> torch.Tensor:
    """Every user or item, encoded by ``model`` (``encode_model``'s; under a
    model-sharded mesh: this shard's rows)."""
    rows = None if search_mesh is None else model.tower(side).id_embedding.weight.shape[0]
    features = data.item_features if side == "item" else data.user_features
    return encode_corpus(model, side, features, num_rows=rows)


def _train_loop_profiler(device: torch.device) -> torch.profiler.profile:
    """The ``diagnostics.profile_dir`` profiler: host ops, and on a card
    its kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _write_trace(profiler: torch.profiler.profile, device: torch.device, out_dir: Path,
                 experiment_name: str, epoch: int) -> None:
    """Stop ``profiler`` once the card has finished and write its Chrome
    trace into ``out_dir``."""
    _sync(device)
    profiler.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{experiment_name}_epoch{epoch:03d}.pt.trace.json"
    profiler.export_chrome_trace(str(path))
    logger.info("Wrote the profiler trace of epoch %d's train loop to %s", epoch, path)


def _prepare_data(config: Mapping[str, Any], distributed: bool) -> TrainingDataset:
    """``prepare_data``, through the dataset cache under ``data.use_cache``
    (the JAX trainer's): a cached dataset is read, else prepared and cached.
    In a distributed run rank 0 reads or writes the cache and the others
    read it after a barrier."""
    data_cfg = dict(config.get("data", {}))
    key = None
    if data_cfg.get("use_cache"):
        key = dataset_cache_key(
            Path(data_cfg.get("root", "data")),
            books_file=data_cfg.get("books_file"),
            users_file=data_cfg.get("users_file"),
            books_limit=data_cfg.get("books_limit"),
            interactions_limit=data_cfg.get("interactions_limit"),
            min_user_interactions=int(data_cfg.get("min_user_interactions", 0)),
            min_item_interactions=int(data_cfg.get("min_item_interactions", 0)),
            feature_config=data_cfg.get("feature_params", {}),
        )
    if key is None:
        return prepare_data(config)
    path = cache_path(data_cfg.get("cache_dir", "artifacts/cache"), key)
    dataset = None
    if is_primary_host():
        dataset = load_training_dataset(path)
        if dataset is None:
            dataset = prepare_data(config)
            save_training_dataset(dataset, path)
    if distributed:
        torch.distributed.barrier()  # rank 0's cache file is complete
        if dataset is None:
            dataset = load_training_dataset(path) or prepare_data(config)
    return dataset


def _checkpoint_host(state: TrainState, mesh, sharded: bool):
    """The host arrays of one epoch's checkpoints, pulled once: this rank's
    pieces for a sharded checkpoint, else the whole flat state (gathered
    over the mesh)."""
    if sharded:
        return state_to_host_shards(state, mesh)
    return train_state_to_flat(state) if mesh is None else gather_state_flat(state, mesh)


def _write_retrieval_artifacts(
    result: TrainingResult,
    model,
    dataset: TrainingDataset,
    metrics_k: list[int],
    requested_dtype: str,
    gate_eps: float,
    index_path: Path,
    embedding_path: Path,
    search_mesh,
    item_embeddings: torch.Tensor,
) -> None:
    """The serving-precision gate, then the serving bundle of the (best)
    state, written by rank 0: the item index and embeddings, and beside the
    index ``user_embeddings.npy`` and ``vocab.json`` (the layout of
    ``export_bundle`` and of the JAX trainer). ``model`` is the state's
    (``encode_model``'s), ``item_embeddings`` its encoded corpus (under ``search_mesh`` this shard's rows). bf16
    serving ships under ``auto`` only when the final val eval re-scored in
    bf16 loses at most ``gate_eps`` of any recall@k."""
    data, val_plan = result.data, result.val_plan
    dtype = "float32"
    if requested_dtype != "auto":
        dtype = requested_dtype
    elif val_plan is None or result.best_val_metrics is None:
        logger.info("Serving precision gate skipped (no validation eval plan); exporting float32.")
    else:
        bf16 = evaluate_retrieval_metrics(
            model, data, plan=val_plan, k_values=metrics_k, item_embeddings=item_embeddings,
            score_dtype="bfloat16", mesh=search_mesh,
        )
        deltas = {
            k: result.best_val_metrics.recall.get(k, 0.0) - bf16.recall.get(k, 0.0)
            for k in metrics_k
        }
        worst = max(deltas.values()) if deltas else 0.0
        if worst <= gate_eps:
            dtype = "bfloat16"
        logger.info(
            "Serving precision gate | bf16 recall deltas %s | worst %.5f vs gate %.5f -> %s",
            {k: round(v, 5) for k, v in deltas.items()}, worst, gate_eps, dtype,
        )
    item_embeddings = full_corpus(model, item_embeddings, search_mesh)
    user_embeddings = full_corpus(
        model, _encode_side(model, data, "user", search_mesh), search_mesh, side="user"
    )
    result.serving_score_dtype = dtype
    if not is_primary_host():
        return
    index = build_flat_index(
        item_embeddings.cpu().numpy(), normalize=model.cfg.similarity == "cosine",
        score_dtype=dtype, device="cpu",  # only written out here
    )
    index.save(index_path)
    embedding_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(embedding_path, index.embeddings)
    serve_dir = index_path.parent
    np.save(serve_dir / "user_embeddings.npy", user_embeddings.cpu().numpy())
    (serve_dir / "vocab.json").write_text(
        json.dumps({
            "user_ids": dataset.user_mapping.index_to_id,
            "item_ids": dataset.item_mapping.index_to_id,
            "similarity": model.cfg.similarity,
        }),
        encoding="utf-8",
    )
    logger.info("Saved the serving bundle to %s (item embeddings %s)", serve_dir, embedding_path)


def _build_user_profile(
    items_lookup: pd.DataFrame, interactions: pd.DataFrame, user_idx: int
) -> dict[str, set[str]]:
    """The categories and authors of one user's interactions (the JAX
    ``_build_user_profile``)."""
    categories: set[str] = set()
    authors: set[str] = set()
    for item_idx in interactions.loc[interactions["user_idx"] == user_idx, "item_idx"]:
        if item_idx not in items_lookup.index:
            continue
        row = items_lookup.loc[item_idx]
        categories.update(parse_category_tokens(row.get("categories")))
        author = row.get("author")
        if isinstance(author, str) and author:
            authors.add(author.strip())
    return {"categories": categories, "authors": authors}


def _log_recommendations(
    model,
    data: BatchData,
    dataset: TrainingDataset,
    item_embeddings: torch.Tensor,
    *,
    sample_users: int,
    top_k: int,
    rng: random.Random,
    mesh=None,
) -> list[dict[str, Any]]:
    """Sample recommendations (the JAX ``_log_recommendations``): for
    ``sample_users`` users drawn by ``rng``, an exact float32 search of the
    whole corpus ``item_embeddings`` (``mips_topk`` at ``top_k`` plus the
    longest history deep), each user's history dropped, the first ``top_k``
    joined with the items' metadata and matched against the history's
    categories and authors. Under ``mesh`` every rank encodes the users
    (sharded row reads) and searches."""
    num_users, num_items = len(dataset.user_mapping), len(dataset.item_mapping)
    if sample_users <= 0 or num_users == 0 or num_items == 0:
        return []
    chosen_users = rng.sample(list(range(num_users)), k=min(sample_users, num_users))
    items_df = dataset.items.set_index("item_idx")
    users_df = dataset.users.set_index("user_idx")
    cosine = model.cfg.similarity == "cosine"
    if cosine:
        item_embeddings = F.normalize(item_embeddings, dim=-1)
    u_idx = torch.tensor(chosen_users, dtype=torch.int32, device=item_embeddings.device)
    queries = encode_user_batch(model, data, u_idx, mesh)
    if cosine:
        queries = F.normalize(queries, dim=-1)
    max_hist = max((len(dataset.user_positive_items.get(u, ())) for u in chosen_users), default=0)
    _, idx = mips_topk(queries, item_embeddings, k=min(top_k + max_hist, num_items))
    idx_np = idx.cpu().numpy()

    results: list[dict[str, Any]] = []
    for row, user_idx in enumerate(chosen_users):
        positives = dataset.user_positive_items.get(int(user_idx), set())
        recommended = [int(i) for i in idx_np[row] if int(i) not in positives][:top_k]
        display_user = users_df.loc[user_idx]["userId"]
        profile = _build_user_profile(items_df, dataset.interactions, int(user_idx))
        recommendations = []
        category_matches = author_matches = 0
        for item_idx in recommended:
            if item_idx not in items_df.index:
                continue
            item_row = items_df.loc[item_idx]
            categories = set(parse_category_tokens(item_row.get("categories")))
            author = item_row.get("author") if isinstance(item_row.get("author"), str) else ""
            category_matches += bool(categories & profile["categories"])
            author_matches += bool(author and author in profile["authors"])
            recommendations.append({
                "asin": item_row.get("parent_asin", ""),
                "title": item_row.get("title", "<unknown>"),
                "author": author,
                "categories": sorted(categories)[:5],
            })
        total = max(len(recommendations), 1)
        logger.info("User %s | Top %d recommendations", display_user, len(recommendations))
        results.append({
            "user_id": display_user,
            "user_idx": int(user_idx),
            "recommendations": recommendations,
            "category_match": category_matches / total,
            "author_match": author_matches / total,
            "history_categories": profile["categories"],
            "history_authors": profile["authors"],
        })
    return results


@dataclass
class RunDiagnostics:
    """What the end-of-run reports hold besides the metrics and losses."""

    embedding_stats: dict[str, Any]
    mimic_stats: dict[str, dict[str, float]]
    feature_correlations: list[dict[str, float]]
    recommendations: list[dict[str, Any]]


@torch.no_grad()
def run_diagnostics(
    model: TwoTower,
    data: BatchData,
    dataset: TrainingDataset,
    item_embeddings: torch.Tensor,
    *,
    diagnostics: Mapping[str, Any],
    recommendations: Mapping[str, Any],
    seed: int,
    mesh=None,
) -> RunDiagnostics:
    """The JAX trainer's end-of-run diagnostics and sample recommendations
    of ``model`` (a state's, through ``encode_model``): from one ``random.Random(seed)``, ``item_sample_size``
    items, ``user_sample_size`` users, then the recommended users (the JAX
    trainer's draws from its seeded global ``random``, in its order). The
    samples are encoded with the mimic augmentation, their ID, feature and
    mimic rows read once (:func:`side_rows`, the sharded reads under
    ``mesh``, where every rank takes part) and pulled to the host, then
    summarised by the numpy functions of ``ttamm_torch.evaluation``.
    ``item_embeddings`` is the whole final corpus, ``[num_items, D]``."""
    num_users, num_items = len(dataset.user_mapping), len(dataset.item_mapping)
    rng = random.Random(seed)
    item_size = int(diagnostics.get("item_sample_size", 500))
    user_size = int(diagnostics.get("user_sample_size", 5000))
    samples = {
        side: np.asarray(rng.sample(range(n), k=min(size, n)), np.int32)
        if n > 0 and size > 0 else np.empty(0, np.int32)
        for side, n, size in (("item", num_items, item_size), ("user", num_users, user_size))
    }
    dev = item_embeddings.device
    dim = model.cfg.embedding_dim
    emb, gates, aug = {}, {}, {}
    for side in ("user", "item"):
        idx = samples[side]
        emb[side], gates[side] = np.zeros((0, dim), np.float32), None
        aug[side] = np.zeros((0, dim), np.float32)
        if not idx.size:
            continue
        id_rows, feats, aug_rows = side_rows(model, data, side, torch.from_numpy(idx).to(dev), mesh)
        tower = model.tower(side)
        out = tower.forward_rows(id_rows, feats)
        emb[side] = (out if aug_rows is None else out + aug_rows).cpu().numpy()
        if aug_rows is not None:
            aug[side] = aug_rows.cpu().numpy()
        gate = tower_gate_values(tower, id_rows, feats)
        gates[side] = None if gate is None else gate.cpu().numpy()

    items_df = dataset.items.set_index("item_idx")
    item_frame = items_df.loc[samples["item"]].reset_index(drop=True)
    embedding_stats = {
        "user_norms": summarize_embedding_norms(emb["user"], label="user"),
        "item_norms": summarize_embedding_norms(emb["item"], label="item"),
        "item_neighbor_overlap": analyze_item_neighbors(
            emb["item"], item_frame, rng=rng, k=int(diagnostics.get("neighbor_k", 10)),
            sample_size=item_frame.shape[0],
        ),
        "user_alignment": summarize_user_alignment(
            emb["user"],
            dataset.user_feature_matrix[samples["user"]]
            if dataset.user_feature_matrix.size
            else np.zeros((len(samples["user"]), 0), np.float32),
        ),
        "fusion_gate": {side: summarize_gate_values(gates[side]) for side in ("user", "item")},
    }
    mimic_stats = compute_mimic_statistics(aug if model.mimic is not None else None)
    feature_correlations: list[dict[str, float]] = []
    item_features = dataset.item_feature_matrix[samples["item"]]
    if item_features.size > 0:
        names = dataset.feature_metadata.feature_names()
        feature_correlations = compute_feature_correlations(
            item_features, np.linalg.norm(emb["item"], axis=1), names[: item_features.shape[1]],
            top_k=int(diagnostics.get("feature_corr_top_k", 15)),
        )
    samples_out = _log_recommendations(
        model, data, dataset, item_embeddings,
        sample_users=int(recommendations.get("sample_users", 3)),
        top_k=int(recommendations.get("top_k", 5)), rng=rng, mesh=mesh,
    )
    return RunDiagnostics(embedding_stats, mimic_stats, feature_correlations, samples_out)


def _write_reports(
    result: TrainingResult,
    diagnostics: RunDiagnostics,
    metrics_k: list[int],
    monitor_metric: str,
    *,
    report_path: Path,
    loss_plot_target: Path,
    embedding_summary_path: Path,
) -> None:
    """The loss plot, the Markdown report and the JSON embedding summary of
    the JAX trainer (rank 0). Without matplotlib the plot is left out, with
    a warning, and the report is written without it."""
    series = {"Train": result.train_loss, "Validation": result.val_loss, "Test": result.test_loss}
    if any(len(v) for v in series.values()):
        try:
            result.loss_plot_path = save_loss_curves(series, output_path=loss_plot_target)
        except ValueError:
            result.loss_plot_path = None
        except ImportError as exc:
            logger.warning("Loss plot not written: %s is not installed", exc.name or exc)
    metrics = result.best_val_metrics or compute_ranking_metrics({}, {}, metrics_k)
    write_recommendation_report(
        report_path, metrics_summary=metrics, embedding_stats=diagnostics.embedding_stats,
        recommendations=diagnostics.recommendations, loss_plot_path=result.loss_plot_path,
        history=result, monitor_metric=monitor_metric, best_epoch=result.best_epoch,
        feature_correlations=diagnostics.feature_correlations,
    )
    write_embedding_summary(
        embedding_summary_path, embedding_stats=diagnostics.embedding_stats,
        mimic_stats=diagnostics.mimic_stats, feature_correlations=diagnostics.feature_correlations,
        monitor_metric=monitor_metric, best_epoch=result.best_epoch,
    )
    result.embedding_summary_path = embedding_summary_path
    logger.info("Wrote the report %s and the embedding summary %s", report_path, embedding_summary_path)
