"""The port's sweep and sweep ledger on the CPU (``run_training``,
``ttamm_torch.reporting.write_benchmark_report``), against the JAX package's
ledger writer.

- ``configs/full_books_sweep.yaml``'s 2-point learning-rate grid, cut to one
  epoch of a small synthetic corpus, runs both points under the names
  ``full_books_sweep00`` / ``_sweep01``, drops each finished point's model,
  and writes a ledger whose text equals ``ttamm_tpu``'s
  ``write_benchmark_report`` applied to the same results;
- ``configs/default.yaml`` (an empty grid and a ``benchmark_report``)
  still runs through ``python -m ttamm_torch.train``: one JSON line, with
  its (empty) overrides, and a one-row ledger;
- the CLI prints one JSON line per run of a grid, each with its overrides.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml

from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.pipelines.training import TrainingResult, run_training
from ttamm_tpu.reporting.reports import write_benchmark_report as jax_write_benchmark_report

REPO = Path(__file__).resolve().parents[1]


def _small(name: str, root: Path) -> dict:
    """The repo config ``name`` cut to one epoch of a 300 x 200 corpus, every
    path under ``root``; its grid and ledger as they are."""
    config = yaml.safe_load((REPO / "configs" / name).read_text())
    write_synthetic_csvs(root / "data", num_users=300, num_items=200, num_interactions=4000, seed=3)
    config["data"].update(
        root=str(root / "data"), min_user_interactions=2, min_item_interactions=2,
        interactions_limit=None,
    )
    config["training"].update(num_epochs=1, batch_size=256)
    config["training"]["checkpointing"]["dir"] = str(root / "ckpt")
    config["evaluation"]["faiss"].update(
        index_path=str(root / "faiss" / "items.index"),
        embedding_path=str(root / "faiss" / "item_embeddings.npy"),
    )
    config["experiment"]["benchmark_report"] = str(root / "reports" / "benchmark_summary.md")
    config["diagnostics"].update(
        report_path=str(root / "reports" / "recommendation_report.md"),
        loss_plot_path=str(root / "reports" / "loss_curve.png"),
        embedding_summary_path=str(root / "reports" / "embedding_diagnostics.json"),
    )
    config["logging"] = {"level": "WARNING"}
    return config


def test_sweep_runs_every_point_and_writes_the_jax_ledger(tmp_path):
    config = _small("full_books_sweep.yaml", tmp_path)
    assert config["experiment"]["grid"] == {"training.learning_rate": [0.001, 0.0005]}
    results = run_training(config, device="cpu")
    assert [r.config["experiment"]["name"] for r in results] == [
        "full_books_sweep00", "full_books_sweep01",
    ]
    assert [r.overrides for r in results] == [
        {"training.learning_rate": 0.001}, {"training.learning_rate": 0.0005},
    ]
    assert [r.config["training"]["learning_rate"] for r in results] == [0.001, 0.0005]
    for r in results:
        assert r.steps > 0 and r.best_metric is not None and r.runtime_seconds > 0
        assert r.state is None and r.data is None and r.val_plan is None

    ledger = Path(config["experiment"]["benchmark_report"]).read_text()
    jax_path = tmp_path / "jax_ledger.md"
    jax_write_benchmark_report(jax_path, [
        SimpleNamespace(
            config=r.config, overrides=r.overrides, best_metric=r.best_metric,
            best_epoch=r.best_epoch, runtime_seconds=r.runtime_seconds,
            examples_per_second=r.examples_per_second,
        )
        for r in results
    ])
    assert ledger == jax_path.read_text()
    assert "training.learning_rate=0.0005" in ledger.splitlines()[-1]


def test_default_config_runs_through_the_cli(tmp_path):
    config = _small("default.yaml", tmp_path)
    assert not config["experiment"]["grid"] and config["experiment"]["benchmark_report"]
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    proc = subprocess.run(
        [sys.executable, "-m", "ttamm_torch.train", "--config", str(cfg_path), "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert summary["experiment"] == "baseline_two_tower" and summary["overrides"] == {}
    ledger = Path(config["experiment"]["benchmark_report"]).read_text().splitlines()
    assert ledger[-1].startswith("1 | - | ") and ledger[-2].startswith("--- |")


def test_cli_prints_one_line_per_run(monkeypatch, capsys, tmp_path):
    from ttamm_torch.train import __main__ as cli

    def fake_run_training(config, **_):
        return [
            TrainingResult(
                num_users=3, num_items=2, steps=1, config={"experiment": {"name": f"x_sweep0{i}"}},
                overrides={"training.learning_rate": lr},
            )
            for i, lr in enumerate((0.1, 0.2))
        ]

    monkeypatch.setattr(cli, "run_training", fake_run_training)
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text("experiment: {name: x}\n")
    cli.main(["--config", str(cfg_path), "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [(s["experiment"], s["overrides"]) for s in lines] == [
        ("x_sweep00", {"training.learning_rate": 0.1}), ("x_sweep01", {"training.learning_rate": 0.2}),
    ]
