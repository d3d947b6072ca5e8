"""``python -m ttamm_torch.train --device cpu`` on a 2x2 mesh of four gloo
ranks (started as torchrun starts them) against the port's one-device run
of the same seed, on a tiny corpus, one epoch, dropout 0.

Both runs draw the same negatives (one generator seeded alike on every
rank) and sum every duplicate row in the single-device order; what differs
is the order of the float32 sums over the data shards (dense gradients, the
category statistics, the loss means). Tolerance: epoch train and val losses
rtol 1e-4; val recall@10 and ndcg@10 of the best epoch within 1e-3 (a
ranking flip between two near-tied items of one user would move recall by
>= 1/300 and fail it); the serving bundle's user embeddings within 1e-3.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from test_torch_port_trainer import _config
from torch_ranks import launch
from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.pipelines.training import run_single_experiment

WORLD = 4
WALL_SECONDS = 240


def _mesh_config(root: Path) -> dict:
    config = _config(root)
    for side in ("user_encoder", "item_encoder"):
        config["model"][side]["feature_encoder"]["dropout"] = 0.0
    config["training"]["num_epochs"] = 1
    config["mesh"] = {"data_parallel": 2, "model_parallel": 2}
    return config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_trainer")
    write_synthetic_csvs(root / "data", num_users=300, num_items=200, num_interactions=4000, seed=3)
    config = _mesh_config(root)
    cfg_path = root / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    outputs = launch(
        lambda r: [sys.executable, "-m", "ttamm_torch.train", "--config", str(cfg_path),
                   "--device", "cpu"],
        WORLD, root, WALL_SECONDS,
    )
    lines = [o.strip().splitlines()[-1] for o in outputs]
    summary = json.loads(lines[0])

    single = dict(config, mesh={"data_parallel": 1, "model_parallel": 1})
    single["training"] = dict(config["training"], checkpointing={
        "enabled": True, "dir": str(root / "ckpt_single")})
    single["evaluation"] = dict(config["evaluation"], faiss={
        "index_path": str(root / "single" / "items.index"),
        "embedding_path": str(root / "single" / "item_embeddings.npy"),
    })
    single["diagnostics"] = dict(config["diagnostics"], **{
        key: str(root / "single" / Path(config["diagnostics"][key]).name)
        for key in ("report_path", "loss_plot_path", "embedding_summary_path")
    })
    return root, outputs, summary, run_single_experiment(single, device="cpu")


def test_mesh_run_matches_the_one_device_run(runs):
    _, _, summary, single = runs
    assert summary["steps"] == single.steps > 0
    np.testing.assert_allclose(summary["train_loss"], single.train_loss, rtol=1e-4)
    np.testing.assert_allclose(summary["val_loss"], single.val_loss, rtol=1e-4)
    np.testing.assert_allclose(summary["first_step_loss"], single.first_step_loss, rtol=1e-5)
    assert abs(summary["best_val_recall"]["10"] - single.best_val_metrics.recall[10]) <= 1e-3
    assert abs(summary["best_val_ndcg"]["10"] - single.best_val_metrics.ndcg[10]) <= 1e-3


def test_only_rank_0_prints_and_every_rank_writes_its_shard(runs):
    root, outputs, summary, _ = runs
    assert outputs[0].strip().splitlines()[-1].startswith("{")
    assert not any(o.strip().startswith("{") for o in outputs[1:])
    ckpt = Path(summary["checkpoint"])
    assert ckpt == root / "ckpt" / "tiny_last.pt" and (ckpt / "manifest.json").is_file()
    assert sorted(p.name for p in ckpt.glob("shards_p*.npz")) == [
        f"shards_p{r:05d}.npz" for r in range(WORLD)
    ]
    assert (root / "faiss" / "items.index").is_file()
    assert np.load(root / "faiss" / "item_embeddings.npy").shape[0] == summary["items"]


def test_the_mesh_runs_bundle_matches_the_one_device_run(runs):
    """Rank 0 writes the whole serving bundle: the user rows of every model
    shard, gathered, beside the items, as the one-device run writes them."""
    root, _, summary, _ = runs
    mesh_dir, single_dir = root / "faiss", root / "single"
    assert (mesh_dir / "vocab.json").read_text() == (single_dir / "vocab.json").read_text()
    users = np.load(mesh_dir / "user_embeddings.npy")
    assert users.shape == (summary["users"], 16)
    # an epoch of float32 sums in another order moves the (cosine) item
    # rows by ~4e-4 and the user rows by ~5e-5; a row from the wrong shard
    # or place would move by O(1)
    np.testing.assert_allclose(users, np.load(single_dir / "user_embeddings.npy"), rtol=0, atol=1e-3)


def test_the_mesh_run_writes_the_reports_of_the_one_device_run(runs):
    """Rank 0 writes the report, the plot and the embedding summary; the
    samples (one seeded draw on every rank) and the recommended users are
    the one-device run's, their statistics within 1e-3 of it."""
    root, _, _, single = runs
    mesh_dir = root / "reports"
    for name in ("recommendation_report.md", "loss_curve.png", "embedding_diagnostics.json"):
        assert (mesh_dir / name).is_file() and (root / "single" / name).is_file()
    users = [
        [line.split("`")[1] for line in (d / "recommendation_report.md").read_text().splitlines()
         if line.startswith("- **User** `")]
        for d in (mesh_dir, root / "single")
    ]
    assert users[0] == users[1] and len(users[0]) == 2
    got, want = (json.loads((d / "embedding_diagnostics.json").read_text())
                 for d in (mesh_dir, root / "single"))
    assert got["best_epoch"] == want["best_epoch"] == single.best_epoch
    for group in ("user_norms", "item_norms", "user_alignment"):
        for key, value in want["embedding_stats"][group].items():
            if isinstance(value, float):
                assert abs(got["embedding_stats"][group][key] - value) <= 1e-3, (group, key)
            else:
                assert got["embedding_stats"][group][key] == value, (group, key)
    for side in ("user", "item"):
        gate = got["embedding_stats"]["fusion_gate"][side]
        assert gate["rows"] == want["embedding_stats"]["fusion_gate"][side]["rows"] > 0
        assert abs(gate["mean"] - want["embedding_stats"]["fusion_gate"][side]["mean"]) <= 1e-3
        for key, value in want["adaptive_mimic"][side].items():
            assert abs(got["adaptive_mimic"][side][key] - value) <= 1e-3
