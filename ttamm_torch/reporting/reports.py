"""The sweep ledger, in the format of ``ttamm_tpu/reporting/reports.py
write_benchmark_report``: one markdown row per run with the reference's
columns plus examples/s."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

from ..utils.config import get_by_dotted_path


def write_benchmark_report(report_path: Path | str, results: Sequence[Any]) -> None:
    """Write the ledger of ``results`` (each with ``config``, ``overrides``,
    ``best_metric``, ``best_epoch``, ``runtime_seconds`` and
    ``examples_per_second``); nothing for no results."""
    if not results:
        return
    report_path = Path(report_path)
    report_path.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        "# Training Benchmark Summary\n",
        "Run | Overrides | Best Metric | Best Epoch | Runtime (s) | "
        "Examples/s | Optimizer | Embedding Dim",
        "--- | --- | --- | --- | --- | --- | --- | ---",
    ]
    for idx, result in enumerate(results, start=1):
        overrides = ", ".join(f"{k}={v}" for k, v in (result.overrides or {}).items()) or "-"
        metric = result.best_metric if result.best_metric is not None else float("nan")
        optimizer = get_by_dotted_path(result.config, "training.optimizer", "adam")
        embed_dim = get_by_dotted_path(
            result.config, "model.user_encoder.id_embedding.params.embedding_dim", "?"
        )
        eps = result.examples_per_second
        eps_str = f"{eps:.0f}" if eps else "-"
        lines.append(
            f"{idx} | {overrides} | {metric:.4f} | {result.best_epoch or '-'} | "
            f"{result.runtime_seconds:.1f} | {eps_str} | {optimizer} | {embed_dim}"
        )
    report_path.write_text("\n".join(lines), encoding="utf-8")
