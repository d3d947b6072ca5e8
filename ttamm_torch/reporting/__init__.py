"""Report writers of the port (``ttamm_tpu/reporting/``): so far the sweep
ledger; the recommendation report, loss plot and embedding summary are
ROADMAP Queue 1 item 1."""

from .reports import write_benchmark_report

__all__ = ["write_benchmark_report"]
