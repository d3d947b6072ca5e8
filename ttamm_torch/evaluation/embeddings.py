"""Embedding diagnostics of the end of a training run: norm summaries, item
neighbour category overlap, user embedding / feature alignment, fusion-gate
and mimic-row statistics (the port's own copy of
``ttamm_tpu/evaluation/embeddings.py``).

Every function takes host numpy arrays of a small sample; the trainer pulls
the sample's embeddings, gate values and mimic rows from the device once.
"""

from __future__ import annotations

import random
from typing import Any, Mapping

import numpy as np

from ..data.features import parse_category_tokens
from ..utils import get_logger

logger = get_logger("evaluation")


def summarize_embedding_norms(embeddings: np.ndarray, *, label: str) -> dict[str, Any]:
    norms = np.linalg.norm(np.asarray(embeddings), axis=-1)
    return {
        "label": label,
        "count": int(len(norms)),
        "mean": float(np.mean(norms)) if norms.size else 0.0,
        "std": float(np.std(norms)) if norms.size else 0.0,
        "min": float(np.min(norms)) if norms.size else 0.0,
        "max": float(np.max(norms)) if norms.size else 0.0,
        "median": float(np.median(norms)) if norms.size else 0.0,
    }


def analyze_item_neighbors(
    item_embeddings: np.ndarray,
    items_frame,
    *,
    rng: random.Random,
    k: int = 10,
    sample_size: int = 200,
) -> dict[str, float]:
    """Mean fraction of an item's top-k cosine neighbours (within the given
    rows) that share a category token with it; items without categories are
    skipped. More than ``sample_size`` rows: ``rng`` draws which to score."""
    item_embeddings = np.asarray(item_embeddings)
    empty = {
        "sampled_items": 0,
        "category_overlap_mean": 0.0,
        "category_overlap_std": 0.0,
        "k": k,
    }
    if item_embeddings.shape[0] == 0:
        return empty
    indices = list(range(item_embeddings.shape[0]))
    if len(indices) > sample_size:
        indices = rng.sample(indices, sample_size)

    norms = np.linalg.norm(item_embeddings, axis=-1, keepdims=True)
    normalized = item_embeddings / np.maximum(norms, 1e-12)
    category_sets = [
        set(parse_category_tokens(items_frame.iloc[i].get("categories")))
        for i in range(len(items_frame))
    ]
    overlap_scores: list[float] = []
    for idx in indices:
        base_categories = category_sets[idx]
        if not base_categories:
            continue
        similarities = normalized @ normalized[idx]
        similarities[idx] = -np.inf
        k_eff = min(k, similarities.shape[0] - 1)
        neighbor_indices = np.argpartition(-similarities, k_eff - 1)[:k_eff]
        neighbor_indices = neighbor_indices[np.argsort(-similarities[neighbor_indices])]
        overlaps = sum(1 for nb in neighbor_indices if base_categories & category_sets[int(nb)])
        overlap_scores.append(overlaps / max(k, 1))
    if not overlap_scores:
        return empty
    return {
        "sampled_items": len(overlap_scores),
        "category_overlap_mean": float(np.mean(overlap_scores)),
        "category_overlap_std": float(np.std(overlap_scores)),
        "k": k,
    }


def summarize_user_alignment(
    user_embeddings: np.ndarray, user_feature_matrix: np.ndarray
) -> dict[str, float]:
    """Cosine alignment between user embeddings and their features, the
    features least-squares-projected (with an affine term) onto the
    embedding space when the widths differ."""
    user_embeddings = np.asarray(user_embeddings, dtype=np.float64)
    features = np.asarray(user_feature_matrix, dtype=np.float64)
    empty = {"aligned_users": 0, "cosine_mean": 0.0, "cosine_std": 0.0}
    if user_embeddings.shape[0] == 0 or features.size == 0:
        return empty
    if features.shape[1] != user_embeddings.shape[1]:
        try:
            padded = np.concatenate([features, np.zeros((features.shape[0], 1))], axis=1)
            coeffs, *_ = np.linalg.lstsq(padded, user_embeddings, rcond=None)
            projected = features @ coeffs[: features.shape[1], :]
        except np.linalg.LinAlgError as exc:
            logger.warning("Failed to align user features: %s", exc)
            return empty
    else:
        projected = features

    def _norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    cosines = np.sum(_norm(projected) * _norm(user_embeddings), axis=-1)
    if cosines.size == 0:
        return empty
    return {
        "aligned_users": int(len(cosines)),
        "cosine_mean": float(np.mean(cosines)),
        "cosine_std": float(np.std(cosines)),
    }


def summarize_gate_values(gate: np.ndarray | None) -> dict[str, float]:
    """Distribution of one tower's fusion-gate values; ``id_dominant_fraction``
    is the share of entries > 0.5 (the blend ``g * id + (1 - g) * feat``
    leaning on the ID embedding)."""
    if gate is None or np.asarray(gate).size == 0:
        return {}
    gate = np.asarray(gate, np.float32)
    return {
        "rows": int(gate.shape[0]),
        "mean": float(gate.mean()),
        "std": float(gate.std()),
        "min": float(gate.min()),
        "max": float(gate.max()),
        "id_dominant_fraction": float((gate > 0.5).mean()),
    }


def compute_mimic_statistics(
    aug_rows: Mapping[str, np.ndarray] | None,
) -> dict[str, dict[str, float]]:
    """Norm statistics of the sampled mimic rows: ``aug_rows`` maps ``user``
    / ``item`` to the rows of ``user_aug`` / ``item_aug`` at that side's
    sample (None without mimic tables; an empty side is skipped)."""
    stats: dict[str, dict[str, float]] = {"user": {}, "item": {}}
    if not aug_rows:
        return stats
    for side in ("user", "item"):
        rows = np.asarray(aug_rows[side])
        if rows.shape[0] == 0:
            continue
        norms = np.linalg.norm(rows, axis=1)
        stats[side] = {"mean_norm": float(norms.mean()), "std_norm": float(norms.std())}
    return stats
