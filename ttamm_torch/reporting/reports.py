"""The run's Markdown report, its JSON embedding summary and the sweep
ledger, in the formats of ``ttamm_tpu/reporting/reports.py`` (byte for byte
on the same inputs): the report's ranking metrics, loss table, embedding
diagnostics, feature correlations and sample recommendations; the
summary's keys; the ledger's markdown row per run with the reference's
columns plus examples/s."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Sequence

from ..utils.config import get_by_dotted_path


def write_recommendation_report(
    report_path: Path | str,
    *,
    metrics_summary,
    embedding_stats: Mapping[str, Any],
    recommendations: Sequence[Mapping[str, Any]],
    loss_plot_path: Path | None = None,
    history=None,
    monitor_metric: str | None = None,
    best_epoch: int | None = None,
    feature_correlations: Sequence[Mapping[str, float]] | None = None,
) -> None:
    """The Markdown report: ``metrics_summary`` (a ``RankingMetrics``),
    the loss table of ``history`` (``train_loss`` / ``val_loss`` /
    ``test_loss``) beside the plot when there is one, the embedding
    diagnostics, the feature correlations and the sample
    recommendations."""
    report_path = Path(report_path)
    report_path.parent.mkdir(parents=True, exist_ok=True)
    lines: list[str] = ["# Recommendation Evaluation Report\n", "## Ranking Metrics\n"]
    for metric_name, values in [
        ("Recall", metrics_summary.recall),
        ("Precision", metrics_summary.precision),
        ("NDCG", metrics_summary.ndcg),
        ("Hit Rate", metrics_summary.hit_rate),
        ("MAP", metrics_summary.map),
    ]:
        lines.append(f"- **{metric_name}**: " + ", ".join(f"@{k}={v:.4f}" for k, v in values.items()))
    lines.append("")

    if loss_plot_path is not None:
        lines.append("## Loss Curves\n")
        lines.append("Training, validation, and test losses tracked across epochs. Monitoring metric:")
        if monitor_metric and best_epoch is not None:
            lines.append(f"- Best {monitor_metric} achieved at epoch {best_epoch}")
        lines.append(f"![Loss curves]({Path(loss_plot_path).as_posix()})\n")
        if history is not None:
            lines.append("Epoch | Train | Validation | Test")
            lines.append("--- | --- | --- | ---")
            for idx, train_loss in enumerate(history.train_loss):
                val_loss = history.val_loss[idx] if idx < len(history.val_loss) else float("nan")
                test_loss = history.test_loss[idx] if idx < len(history.test_loss) else float("nan")
                lines.append(f"{idx + 1} | {train_loss:.4f} | {val_loss:.4f} | {test_loss:.4f}")
            lines.append("")

    lines.append("## Embedding Diagnostics\n")
    for side in ("user", "item"):
        norms = embedding_stats[f"{side}_norms"]
        lines.append(
            f"- {side.capitalize()} embedding norms: mean={norms['mean']:.4f}, "
            f"std={norms['std']:.4f}, min={norms['min']:.4f}, max={norms['max']:.4f}"
        )
    neighbor_stats = embedding_stats["item_neighbor_overlap"]
    lines.append(
        f"- Item neighbor category overlap (k={neighbor_stats.get('k', 'NA')}): "
        f"mean={neighbor_stats['category_overlap_mean']:.4f}, "
        f"std={neighbor_stats['category_overlap_std']:.4f}"
    )
    alignment = embedding_stats["user_alignment"]
    lines.append(
        f"- User embedding vs. feature alignment (cosine): "
        f"mean={alignment['cosine_mean']:.4f}, std={alignment['cosine_std']:.4f}"
    )
    for side, stats in (embedding_stats.get("fusion_gate") or {}).items():
        if stats:
            lines.append(
                f"- {side.capitalize()} fusion gate: mean={stats['mean']:.4f}, "
                f"std={stats['std']:.4f}, ID-dominant fraction={stats['id_dominant_fraction']:.4f}"
            )
    lines.append("")

    if feature_correlations:
        lines += ["### Feature Correlations\n", "Feature | Pearson r | p-value", "--- | --- | ---"]
        for entry in feature_correlations:
            lines.append(f"{entry['feature']} | {entry['pearson_r']:.4f} | {entry['p_value']:.2e}")
        lines.append("")

    lines.append("## Sample User Recommendations\n")
    for entry in recommendations:
        lines.append(
            f"- **User** `{entry['user_id']}` | category match {entry['category_match']:.2%} | "
            f"author match {entry['author_match']:.2%}"
        )
        lines.append(
            "  - Historical categories: "
            f"{', '.join(sorted(entry['history_categories'])[:5]) or 'N/A'}"
        )
        for rank, rec in enumerate(entry["recommendations"], start=1):
            lines.append(
                f"  {rank}. {rec['title']} ({rec['asin']}) — author: {rec['author'] or 'Unknown'} | "
                f"categories: {', '.join(rec['categories']) or 'N/A'}"
            )
        lines.append("")
    report_path.write_text("\n".join(lines), encoding="utf-8")


def write_embedding_summary(
    summary_path: Path | str,
    *,
    embedding_stats: Mapping[str, Any],
    mimic_stats: Mapping[str, Any],
    feature_correlations: Sequence[Mapping[str, float]],
    monitor_metric: str | None,
    best_epoch: int | None,
) -> None:
    """The JSON summary of the embedding diagnostics, the mimic statistics
    and the feature correlations."""
    summary_path = Path(summary_path)
    summary_path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "embedding_stats": embedding_stats,
        "adaptive_mimic": mimic_stats,
        "feature_correlations": list(feature_correlations),
        "monitor_metric": monitor_metric,
        "best_epoch": best_epoch,
    }
    summary_path.write_text(json.dumps(payload, indent=2), encoding="utf-8")


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
