"""Retrieval evaluation: ranking metrics (numpy) and the batched eval on the
card (port of ``ttamm_tpu/evaluation``)."""

from .metrics import (
    RankingMetrics,
    compute_ranking_metrics,
    metrics_from_hit_matrix,
    per_user_metrics,
)
from .retrieval import (
    EvalPlan,
    build_eval_plan,
    encode_user_batch,
    evaluate_retrieval,
    evaluate_retrieval_metrics,
)

__all__ = [
    "EvalPlan",
    "RankingMetrics",
    "build_eval_plan",
    "compute_ranking_metrics",
    "encode_user_batch",
    "evaluate_retrieval",
    "evaluate_retrieval_metrics",
    "metrics_from_hit_matrix",
    "per_user_metrics",
]
