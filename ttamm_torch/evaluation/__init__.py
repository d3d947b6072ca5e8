"""Retrieval evaluation: ranking metrics (numpy), the batched eval on the
card and the end-of-run embedding diagnostics (port of
``ttamm_tpu/evaluation``)."""

from .embeddings import (
    analyze_item_neighbors,
    compute_mimic_statistics,
    summarize_embedding_norms,
    summarize_gate_values,
    summarize_user_alignment,
)
from .feature_correlation import compute_feature_correlations
from .metrics import (
    RankingMetrics,
    compute_ranking_metrics,
    metrics_from_hit_matrix,
    per_user_metrics,
)
from .retrieval import (
    EvalPlan,
    build_eval_plan,
    encode_rows,
    encode_user_batch,
    evaluate_retrieval,
    evaluate_retrieval_metrics,
    side_rows,
)

__all__ = [
    "EvalPlan",
    "RankingMetrics",
    "analyze_item_neighbors",
    "build_eval_plan",
    "compute_feature_correlations",
    "compute_mimic_statistics",
    "compute_ranking_metrics",
    "encode_rows",
    "encode_user_batch",
    "evaluate_retrieval",
    "evaluate_retrieval_metrics",
    "metrics_from_hit_matrix",
    "per_user_metrics",
    "side_rows",
    "summarize_embedding_norms",
    "summarize_gate_values",
    "summarize_user_alignment",
]
