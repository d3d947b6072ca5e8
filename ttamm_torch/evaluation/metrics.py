"""Ranking metrics: recall / precision / NDCG / hit-rate / MAP / MRR (the
port's own copy of ``ttamm_tpu/evaluation/metrics.py``, numpy only).

Definition parity with ``src/evaluation/metrics.py:11-116`` (macro-averaged
per-user metrics; DCG with log2(rank+1) discounts; AP normalised by
min(|GT|, k); MRR over the top-max(k) list; users with empty ground truth
skipped). The aggregate path is vectorised in numpy — hit matrices for all
users at once — since a full-corpus eval scores hundreds of thousands of
users per epoch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np


@dataclass(frozen=True)
class RankingMetrics:
    recall: dict[int, float]
    precision: dict[int, float]
    ndcg: dict[int, float]
    hit_rate: dict[int, float]
    map: dict[int, float]
    mrr: float
    per_user: list[dict[str, float]]


def _dcg(relevance: Sequence[int]) -> float:
    return sum(rel / np.log2(idx + 2) for idx, rel in enumerate(relevance))


def _ndcg_at_k(predicted: Sequence[int], ground_truth: set[int], k: int) -> float:
    relevance = [1 if item in ground_truth else 0 for item in predicted[:k]]
    ideal = _dcg([1] * min(k, len(ground_truth)))
    if ideal == 0:
        return 0.0
    return _dcg(relevance) / ideal


def _average_precision(
    predicted: Sequence[int], ground_truth: set[int], k: int
) -> float:
    hits = 0
    sum_precision = 0.0
    for idx, item in enumerate(predicted[:k], start=1):
        if item in ground_truth:
            hits += 1
            sum_precision += hits / idx
    if not ground_truth:
        return 0.0
    return sum_precision / min(len(ground_truth), k)


def per_user_metrics(
    predicted: Sequence[int],
    ground_truth: set[int],
    k_values: Iterable[int],
) -> dict[str, float]:
    """Single-user metrics dict (reference-identical scalar path)."""
    metrics: dict[str, float] = {}
    k_sorted = sorted(k_values)
    max_k = max(k_sorted) if k_sorted else len(predicted)
    for k in k_sorted:
        topk = predicted[:k]
        hits = len(set(topk) & ground_truth)
        metrics[f"recall@{k}"] = hits / max(len(ground_truth), 1)
        metrics[f"precision@{k}"] = hits / max(k, 1)
        metrics[f"hit_rate@{k}"] = 1.0 if hits > 0 else 0.0
        metrics[f"ndcg@{k}"] = _ndcg_at_k(predicted, ground_truth, k)
        metrics[f"map@{k}"] = _average_precision(predicted, ground_truth, k)
    reciprocal_rank = 0.0
    for idx, item in enumerate(predicted[:max_k], start=1):
        if item in ground_truth:
            reciprocal_rank = 1.0 / idx
            break
    metrics["mrr"] = reciprocal_rank
    return metrics


def _vectorized_tables(
    per_user_predictions: Mapping[int, Sequence[int]],
    per_user_ground_truth: Mapping[int, set[int]],
    k_values: Sequence[int],
) -> tuple[np.ndarray, dict[int, dict[str, np.ndarray]], np.ndarray, list[int]]:
    """Build per-user metric arrays for all users with non-empty GT at once.

    Returns (users, {k: {metric: values}}, mrr values, user order).
    """
    users = [
        u
        for u in per_user_predictions
        if per_user_ground_truth.get(u)  # skip empty GT (ref metrics.py:95-97)
    ]
    n = len(users)
    max_k = max(k_values)
    hit = np.zeros((n, max_k), dtype=np.float64)
    gt_sizes = np.zeros((n,), dtype=np.float64)
    for row, u in enumerate(users):
        gt = per_user_ground_truth[u]
        gt_sizes[row] = len(gt)
        preds = per_user_predictions[u][:max_k]
        for pos, item in enumerate(preds):
            if item in gt:
                hit[row, pos] = 1.0

    tables, mrr = _tables_from_hits(hit, gt_sizes, k_values)
    return hit, tables, mrr, users


def _tables_from_hits(
    hit: np.ndarray, gt_sizes: np.ndarray, k_values: Sequence[int]
) -> tuple[dict[int, dict[str, np.ndarray]], np.ndarray]:
    """Per-user metric tables from a [n, max_k] 0/1 hit matrix."""
    max_k = hit.shape[1]
    cum_hits = np.cumsum(hit, axis=1)  # [n, max_k]
    discounts = 1.0 / np.log2(np.arange(max_k) + 2.0)
    dcg = np.cumsum(hit * discounts, axis=1)
    positions = np.arange(1, max_k + 1, dtype=np.float64)
    prec_at_pos = cum_hits / positions
    ap_terms = np.cumsum(hit * prec_at_pos, axis=1)

    tables: dict[int, dict[str, np.ndarray]] = {}
    ideal_cum = np.cumsum(discounts)
    for k in k_values:
        col = k - 1
        hits_k = cum_hits[:, col] if k <= max_k else cum_hits[:, -1]
        ideal_sizes = np.minimum(k, gt_sizes).astype(np.int64)
        ideal = np.where(ideal_sizes > 0, ideal_cum[np.maximum(ideal_sizes - 1, 0)], 0.0)
        ndcg = np.where(ideal > 0, dcg[:, col] / np.where(ideal > 0, ideal, 1.0), 0.0)
        tables[k] = {
            "recall": hits_k / np.maximum(gt_sizes, 1.0),
            "precision": hits_k / max(k, 1),
            "hit_rate": (hits_k > 0).astype(np.float64),
            "ndcg": ndcg,
            "map": ap_terms[:, col] / np.minimum(gt_sizes, k),
        }

    first_hit = np.argmax(hit > 0, axis=1)
    any_hit = hit.max(axis=1) > 0
    mrr = np.where(any_hit, 1.0 / (first_hit + 1.0), 0.0)
    return tables, mrr


def metrics_from_hit_matrix(
    hit: np.ndarray,
    gt_sizes: np.ndarray,
    k_values: Iterable[int],
) -> RankingMetrics:
    """Macro-averaged :class:`RankingMetrics` straight from a hit matrix.

    ``hit[u, p] == 1`` iff position ``p`` of user ``u``'s prediction list
    holds a ground-truth item. Identical math to
    :func:`compute_ranking_metrics` with the dict-building skipped — the
    fast path for the scan-based retrieval eval, which produces hit
    matrices on the device (``ttamm_torch/evaluation/retrieval.py``).
    """
    k_list = list(k_values)
    empty = RankingMetrics(
        recall={k: 0.0 for k in k_list},
        precision={k: 0.0 for k in k_list},
        ndcg={k: 0.0 for k in k_list},
        hit_rate={k: 0.0 for k in k_list},
        map={k: 0.0 for k in k_list},
        mrr=0.0,
        per_user=[],
    )
    if not k_list or hit.shape[0] == 0:
        return empty
    keep = gt_sizes > 0  # skip empty-GT users (ref metrics.py:95-97)
    hit = np.asarray(hit[keep], dtype=np.float64)
    gt_sizes = np.asarray(gt_sizes[keep], dtype=np.float64)
    if hit.shape[0] == 0:
        return empty
    tables, mrr = _tables_from_hits(hit, gt_sizes, k_list)
    return RankingMetrics(
        recall={k: float(tables[k]["recall"].mean()) for k in k_list},
        precision={k: float(tables[k]["precision"].mean()) for k in k_list},
        ndcg={k: float(tables[k]["ndcg"].mean()) for k in k_list},
        hit_rate={k: float(tables[k]["hit_rate"].mean()) for k in k_list},
        map={k: float(tables[k]["map"].mean()) for k in k_list},
        mrr=float(mrr.mean()),
        per_user=[],
    )


def compute_ranking_metrics(
    per_user_predictions: Mapping[int, Sequence[int]],
    per_user_ground_truth: Mapping[int, set[int]],
    k_values: Iterable[int],
    *,
    include_per_user: bool = True,
) -> RankingMetrics:
    """Macro-average per-user metrics across all users with ground truth."""
    k_list = list(k_values)
    empty = RankingMetrics(
        recall={k: 0.0 for k in k_list},
        precision={k: 0.0 for k in k_list},
        ndcg={k: 0.0 for k in k_list},
        hit_rate={k: 0.0 for k in k_list},
        map={k: 0.0 for k in k_list},
        mrr=0.0,
        per_user=[],
    )
    if not per_user_predictions or not k_list:
        return empty

    _, tables, mrr, users = _vectorized_tables(
        per_user_predictions, per_user_ground_truth, k_list
    )
    if not users:
        return empty

    per_user: list[dict[str, float]] = []
    if include_per_user:
        for row in range(len(users)):
            entry: dict[str, float] = {}
            for k in k_list:
                for name in ("recall", "precision", "hit_rate", "ndcg", "map"):
                    entry[f"{name}@{k}"] = float(tables[k][name][row])
            entry["mrr"] = float(mrr[row])
            per_user.append(entry)

    return RankingMetrics(
        recall={k: float(tables[k]["recall"].mean()) for k in k_list},
        precision={k: float(tables[k]["precision"].mean()) for k in k_list},
        ndcg={k: float(tables[k]["ndcg"].mean()) for k in k_list},
        hit_rate={k: float(tables[k]["hit_rate"].mean()) for k in k_list},
        map={k: float(tables[k]["map"].mean()) for k in k_list},
        mrr=float(mrr.mean()),
        per_user=per_user,
    )
