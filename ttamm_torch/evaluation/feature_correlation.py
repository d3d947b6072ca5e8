"""Feature <-> score Pearson correlations of the item sample (the port's own
copy of ``ttamm_tpu/evaluation/feature_correlation.py``, numpy + scipy).

Variance-thresholded columns, Pearson r and its two-sided p-value against
the score vector, sorted by |r| and cut to ``top_k``; every column's r comes
from one centered matrix-vector product, and the p-values from the
symmetric-beta survival function ``scipy.stats.pearsonr`` uses.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import stats


def _pearson_r_all_columns(features: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Pearson r between every feature column and ``scores`` at once."""
    fc = features - features.mean(axis=0, keepdims=True)
    sc = scores - scores.mean()
    denom = np.sqrt((fc**2).sum(axis=0) * (sc**2).sum())
    with np.errstate(divide="ignore", invalid="ignore"):
        r = (fc.T @ sc) / denom
    return np.clip(r, -1.0, 1.0)


def _two_sided_p(r: np.ndarray, n: int) -> np.ndarray:
    """p-value of the two-sided test, as ``stats.pearsonr``: |r| under the
    null follows a symmetric Beta(n/2-1, n/2-1) on [-1, 1]."""
    ab = n / 2.0 - 1.0
    return 2.0 * stats.beta(ab, ab, loc=-1.0, scale=2.0).sf(np.abs(r))


def compute_feature_correlations(
    feature_matrix: np.ndarray,
    scores: np.ndarray,
    feature_names: Sequence[str],
    *,
    top_k: int | None = None,
    min_variance: float = 1e-8,
) -> list[dict[str, float]]:
    """Rank features by |Pearson r| against ``scores``.

    Returns ``[{"feature", "pearson_r", "p_value"}, ...]`` sorted by
    descending |r|, cut to ``top_k``; constant columns (variance below
    ``min_variance``) and numerically degenerate ones are skipped. Fewer
    than 3 samples give an empty list.
    """
    if feature_matrix.size == 0 or feature_matrix.shape[0] < 3:
        return []
    features = np.asarray(feature_matrix, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    r_all = _pearson_r_all_columns(features, scores)
    keep = (features.var(axis=0) >= min_variance) & np.isfinite(r_all)
    (cols,) = np.nonzero(keep)
    if cols.size == 0:
        return []
    p_all = _two_sided_p(r_all[cols], features.shape[0])
    order = np.argsort(-np.abs(r_all[cols]), kind="stable")
    if top_k is not None:
        order = order[:top_k]
    return [
        {
            "feature": feature_names[cols[j]],
            "pearson_r": float(r_all[cols[j]]),
            "p_value": float(p_all[j]),
        }
        for j in order
    ]
