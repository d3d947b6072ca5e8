"""The port's trainer end to end on the CPU, its isolation from JAX and the
JAX package, and its copy of the synthetic corpus generator.

- ``python -m ttamm_torch.train --device cpu`` trains 2 epochs of a small
  gated-tower config on a synthetic corpus, writes its last checkpoint and
  prints one JSON line; ``python -m ttamm_torch.pipelines.export
  --checkpoint`` builds the serving bundle from that checkpoint; the
  trainer's own index directory is a serving bundle too, equal to the
  export from its best checkpoint (stale files there overwritten); a
  resumed run starts after the checkpoint's epoch.
- Importing every ``ttamm_torch`` module loads neither ``jax`` nor
  ``ttamm_tpu``.
- The port's generator writes the JAX package's CSVs byte for byte.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import ttamm_torch
from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.pipelines.export import export_bundle
from ttamm_torch.pipelines.training import run_single_experiment
from ttamm_torch.serve import RetrievalService
from ttamm_tpu.data.synthetic import write_synthetic_csvs as jax_write_synthetic_csvs

REPO = Path(__file__).resolve().parents[1]


def _tower():
    return {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
        "feature_encoder": {
            "type": "mlp", "hidden_dims": [32], "output_dim": 16, "dropout": 0.15,
        },
        "fusion": "gated",
    }


def _config(root: Path) -> dict:
    return {
        "experiment": {"name": "tiny", "seed": 3},
        "data": {
            "root": str(root / "data"), "min_user_interactions": 2,
            "min_item_interactions": 2,
            "feature_params": {"category_top_k": 5, "author_top_k": 4},
        },
        "model": {
            "user_encoder": _tower(), "item_encoder": _tower(),
            "similarity": "cosine", "adaptive_mimic": {"enabled": True},
        },
        "training": {
            "batch_size": 256, "num_epochs": 2, "optimizer": "adamw",
            "weight_decay": 0.01, "learning_rate": 0.01,
            "loss_weights": {"mimic_user": 0.15, "mimic_item": 0.15, "category_alignment": 0.01},
            "category_alignment_max_categories": 16,
            "early_stopping": {"enabled": True},
            "checkpointing": {"enabled": True, "dir": str(root / "ckpt")},
        },
        "evaluation": {
            "metrics_k": [5, 10],
            "faiss": {
                "index_path": str(root / "faiss" / "items.index"),
                "embedding_path": str(root / "faiss" / "item_embeddings.npy"),
            },
        },
        "diagnostics": {
            "item_sample_size": 20, "user_sample_size": 50, "neighbor_k": 5,
            "report_path": str(root / "reports" / "recommendation_report.md"),
            "loss_plot_path": str(root / "reports" / "loss_curve.png"),
            "embedding_summary_path": str(root / "reports" / "embedding_diagnostics.json"),
        },
        "recommendations": {"sample_users": 2, "top_k": 5},
        "logging": {"level": "WARNING"},
    }


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    write_synthetic_csvs(root / "data", num_users=300, num_items=200, num_interactions=4000, seed=3)
    cfg_path = root / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(_config(root)))
    # an earlier export's files in the trainer's index directory
    (root / "faiss").mkdir()
    np.save(root / "faiss" / "user_embeddings.npy", np.zeros((3, 16), np.float32))
    (root / "faiss" / "vocab.json").write_text(json.dumps({"user_ids": ["stale"], "item_ids": []}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "ttamm_torch.train", "--config", str(cfg_path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root, cfg_path, env, json.loads(proc.stdout.strip().splitlines()[-1])


def test_trainer_cli_trains_and_checkpoints(trained):
    root, _, _, summary = trained
    assert summary["steps"] > 0 and len(summary["train_loss"]) == 2
    values = [summary["first_step_loss"], *summary["train_loss"], *summary["val_loss"]]
    assert all(np.isfinite(values))
    assert summary["train_loss"][-1] < summary["first_step_loss"]
    assert Path(summary["checkpoint"]) == root / "ckpt" / "tiny_last.pt"
    # no monitored metric: the val loss picks the best epoch
    assert summary["best_epoch"] == 1 + int(np.argmin(summary["val_loss"]))
    assert Path(summary["best_checkpoint"]).is_file()
    assert set(summary["best_val_recall"]) == {"5", "10"}
    assert (root / "faiss" / "items.index").is_file() and summary["serving_score_dtype"]
    with np.load(summary["checkpoint"]) as blob:
        assert int(blob["step"]) == summary["steps"]
        assert blob["tables/user_id"].shape[0] == summary["users"] + 1  # + scratch row


def test_export_from_the_trainers_checkpoint(trained):
    root, cfg_path, env, summary = trained
    out = root / "bundle"
    proc = subprocess.run(
        [sys.executable, "-m", "ttamm_torch.pipelines.export", "--config", str(cfg_path),
         "--out", str(out), "--device", "cpu", "--checkpoint", summary["checkpoint"]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    service = RetrievalService.from_artifacts(out, device="cpu")
    assert len(service.user_ids) == summary["users"] and len(service.index) == summary["items"]
    recs = service.recommend_for_user(service.user_ids[0], k=5)
    assert len(recs) == 5
    # the bundle's user rows are the trained tables' first rows (no scratch row)
    with np.load(summary["checkpoint"]) as blob:
        assert not np.allclose(blob["tables/user_id"][:3], 0)


def test_the_trainers_index_directory_serves(trained):
    """The trainer writes the serving bundle of its best state beside the
    index: vocab.json equal to export_bundle's from the best checkpoint, the
    user embeddings equal to export's within 1e-6 (the same encode of the
    same tables), and it answers userId -> top-K as the numpy search does."""
    root, cfg_path, _, summary = trained
    serve_dir = root / "faiss"
    export_bundle(
        yaml.safe_load(cfg_path.read_text()), root / "bundle_best", device="cpu",
        checkpoint=summary["best_checkpoint"],
    )
    assert (serve_dir / "vocab.json").read_text() == (root / "bundle_best" / "vocab.json").read_text()
    users = np.load(serve_dir / "user_embeddings.npy")
    assert users.shape == (summary["users"], 16)
    np.testing.assert_allclose(users, np.load(root / "bundle_best" / "user_embeddings.npy"), rtol=0, atol=1e-6)

    service = RetrievalService.from_artifacts(serve_dir, device="cpu")
    assert len(service.user_ids) == summary["users"] and len(service.index) == summary["items"]
    # the precision gate may pick a bf16 index: its scores move by up to
    # ~2^-8, so ids may differ from the float32 numpy search only where the
    # reference scores tie within 2^-6
    tol = 1e-5 if summary["serving_score_dtype"] == "float32" else 2.0**-6
    item_pos = {asin: i for i, asin in enumerate(service.item_ids)}
    for uid in service.user_ids[:3]:
        recs = service.recommend_for_user(uid, k=5)
        query = service.user_embeddings[service.user_to_idx[uid]][None, :]
        ref_scores, ref_ids = service.index.search(query, 5, backend="numpy")
        ids = np.array([item_pos[asin] for asin, _ in recs])
        scores = np.array([s for _, s in recs])
        np.testing.assert_allclose(scores, ref_scores[0], rtol=0, atol=tol)
        assert np.all(np.abs(scores - ref_scores[0])[ids != ref_ids[0]] <= tol)


def test_resume_starts_after_the_checkpoint(trained):
    root, _, _, summary = trained
    config = _config(root)
    config["training"].update(num_epochs=3, resume_from=summary["checkpoint"])
    config["training"]["checkpointing"]["dir"] = str(root / "ckpt_resumed")
    result = run_single_experiment(config, device="cpu")
    assert len(result.train_loss) == 1  # epoch 3 only
    assert result.state.step == summary["steps"] + result.steps


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = [
        m.name for m in pkgutil.walk_packages(ttamm_torch.__path__, "ttamm_torch.")
    ]
    assert {
        "ttamm_torch.train.__main__", "ttamm_torch.ops.kernels",
        "ttamm_torch.evaluation.metrics", "ttamm_torch.evaluation.retrieval",
        "ttamm_torch.parallel.launch", "ttamm_torch.parallel.mesh",
        "ttamm_torch.parallel.sharding", "ttamm_torch.parallel.embedding_lookup",
        "ttamm_torch.parallel.sparse_update", "ttamm_torch.parallel.step",
        "ttamm_torch.train.sharded_checkpoint", "ttamm_torch.reporting.reports",
    } <= set(modules)
    script = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ttamm_tpu')))\n"
        "assert not leaked, leaked\n"
        "print('ISOLATED', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout


def test_generator_writes_the_jax_packages_csvs(tmp_path):
    kwargs = dict(num_users=120, num_items=80, num_interactions=900, num_authors=7, seed=11)
    write_synthetic_csvs(tmp_path / "port", **kwargs)
    jax_write_synthetic_csvs(tmp_path / "jax", **kwargs)
    for name in ("books.csv", "users.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
