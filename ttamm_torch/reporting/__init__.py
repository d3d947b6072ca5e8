"""Report writers of the port (``ttamm_tpu/reporting/``): the sweep ledger,
the recommendation report, the embedding summary and the loss plot, in the
JAX package's formats."""

from .plots import save_loss_curves
from .reports import write_benchmark_report, write_embedding_summary, write_recommendation_report

__all__ = [
    "save_loss_curves",
    "write_benchmark_report",
    "write_embedding_summary",
    "write_recommendation_report",
]
