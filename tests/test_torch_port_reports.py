"""The port's end-of-run reports against the JAX package, on the CPU.

- the feature correlations within 1e-6 (r and p) of the JAX function;
- the embedding statistics (norms, item-neighbour overlap with the same
  draw, user alignment both ways, gate values, mimic rows) equal to the JAX
  functions' on the same arrays, and within 1e-5 on one state converted
  into both packages and encoded by each; the gate values within 1e-5 of
  JAX ``tower_gate_values``;
- the Markdown report and the JSON summary byte-equal to the JAX writers';
  the loss plot a PNG, and an empty history raising as in JAX;
- the sample recommendations of the same users on the same state: the ids
  of JAX ``_log_recommendations`` (its search as it runs on the CPU), ties
  within 1e-5 excepted;
- a small CPU trainer run writing all four artifacts, byte-equal to the
  JAX writers given the same inputs, its report's recall that of the best
  epoch; the dataset cache written once, then read.
"""

import json
import random
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_port_trainer import _config
from torch_step_setup import NI, NU, setup
from ttamm_torch.data import cache as cache_module
from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.evaluation import embeddings as port_emb
from ttamm_torch.evaluation import encode_rows, side_rows
from ttamm_torch.evaluation.feature_correlation import compute_feature_correlations
from ttamm_torch.evaluation.metrics import compute_ranking_metrics
from ttamm_torch.models.encoders import tower_gate_values
from ttamm_torch.pipelines import training as port_training
from ttamm_torch.reporting import (
    save_loss_curves,
    write_embedding_summary,
    write_recommendation_report,
)
from ttamm_torch.train import encode_corpus
from ttamm_tpu.evaluation import embeddings as jax_emb
from ttamm_tpu.evaluation.feature_correlation import (
    compute_feature_correlations as jax_feature_correlations,
)
from ttamm_tpu.evaluation.retrieval import encode_user_batch as jax_encode_users
from ttamm_tpu.models.encoders import tower_gate_values as jax_gate_values
from ttamm_tpu.models.two_tower import encode_tower as jax_encode_tower
from ttamm_tpu.pipelines import training as jax_training
from ttamm_tpu.reporting import plots as jax_plots
from ttamm_tpu.reporting import reports as jax_reports
from ttamm_tpu.train.step import encode_corpus as jax_encode_corpus

ENCODE_ATOL = 1e-5
TIE_TOL = 1e-5


@pytest.mark.parametrize("n, top_k", [(40, None), (40, 5), (2, None)])
def test_feature_correlations_match_jax(n, top_k):
    rng = np.random.default_rng(n)
    features = rng.normal(0, 1, (n, 12))
    features[:, 3] = 1.5  # constant: skipped
    features[:, 7] = features[:, 2] * 2.0 + 0.1  # ties in |r|: stable order
    scores = features[:, 2] * 0.5 + rng.normal(0, 1, n)
    names = [f"f{i}" for i in range(12)]
    want = jax_feature_correlations(features, scores, names, top_k=top_k)
    got = compute_feature_correlations(features, scores, names, top_k=top_k)
    assert [g["feature"] for g in got] == [w["feature"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["pearson_r"] - w["pearson_r"]) <= 1e-6
        assert abs(g["p_value"] - w["p_value"]) <= 1e-6


def _items_frame(n: int, seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    tops = ["History", "Romance", "Science", "Poetry"]
    subs = ["Classic", "Modern", "Essays"]
    cats = []
    for i in range(n):
        path = ["Books", tops[rng.integers(4)], subs[rng.integers(3)]]
        cats.append([] if i % 9 == 4 else path)  # some items without categories
    return pd.DataFrame({
        "item_idx": np.arange(n),
        "parent_asin": [f"A{i:05d}" for i in range(n)],
        "title": [f"Title {i}" for i in range(n)],
        "author": [None if i % 7 == 3 else f"Author {i % 11}" for i in range(n)],
        "categories": cats,
    })


@pytest.mark.parametrize("emb_dim, feat_dim", [(16, 16), (16, 9)])
def test_embedding_statistics_match_jax_on_the_same_arrays(emb_dim, feat_dim):
    rng = np.random.default_rng(emb_dim + feat_dim)
    items = rng.normal(0, 1, (60, emb_dim)).astype(np.float32)
    users = rng.normal(0, 1, (50, emb_dim)).astype(np.float32)
    user_feats = rng.normal(0, 1, (50, feat_dim)).astype(np.float32)
    frame = _items_frame(60, 1)
    gate = 1.0 / (1.0 + np.exp(-rng.normal(0, 1, (50, emb_dim)))).astype(np.float32)
    assert port_emb.summarize_embedding_norms(items, label="item") == \
        jax_emb.summarize_embedding_norms(items, label="item")
    # the JAX function draws from the global random module, the port's from rng
    random.seed(7)
    want = jax_emb.analyze_item_neighbors(items, frame, k=5, sample_size=25)
    got = port_emb.analyze_item_neighbors(items, frame, rng=random.Random(7), k=5, sample_size=25)
    assert got == want and got["sampled_items"] > 0
    assert port_emb.analyze_item_neighbors(items, frame, rng=random.Random(0), k=5) == \
        jax_emb.analyze_item_neighbors(items, frame, k=5)
    assert port_emb.summarize_user_alignment(users, user_feats) == \
        jax_emb.summarize_user_alignment(users, user_feats)
    assert port_emb.summarize_gate_values(gate) == jax_emb.summarize_gate_values(gate)
    assert port_emb.summarize_gate_values(None) == jax_emb.summarize_gate_values(None) == {}
    tables = {"user_aug": users, "item_aug": items}
    uidx, iidx = np.array([3, 9, 9, 41]), np.array([], np.int64)
    assert port_emb.compute_mimic_statistics({"user": users[uidx], "item": items[iidx]}) == \
        jax_emb.compute_mimic_statistics(tables, user_indices=uidx, item_indices=iidx)
    assert port_emb.compute_mimic_statistics(None) == \
        jax_emb.compute_mimic_statistics(None, user_indices=uidx, item_indices=iidx)


@pytest.fixture(scope="module")
def sides():
    jx, pt, pos, _ = setup(mimic_sparse=False)
    return jx, pt, pos


def test_sample_encodes_and_gates_match_jax(sides):
    """One state in both packages: the sample encodes (mimic-augmented), the
    statistics on them within 1e-5, the σ-gate values within 1e-5."""
    jx, pt, _ = sides
    rng = np.random.default_rng(3)
    idx = {"user": rng.choice(NU, 40, replace=False).astype(np.int32),
           "item": rng.choice(NI, 30, replace=False).astype(np.int32)}
    feats = {"user": np.asarray(jx.data.user_features), "item": np.asarray(jx.data.item_features)}
    got, want = {}, {}
    for side in ("user", "item"):
        t = torch.from_numpy(idx[side])
        got[side] = encode_rows(pt.state.model, pt.data, side, t).numpy()
        if side == "user":
            want[side] = np.asarray(jax_encode_users(jx.state, jx.data, jx.cfg, jnp.asarray(idx[side])))
        else:
            want[side] = np.asarray(jax_encode_tower(
                jx.state.tables, jx.state.dense, jx.cfg, side, jnp.asarray(idx[side]),
                jnp.asarray(feats[side][idx[side]]), augment_with_mimic=True,
            ))
        np.testing.assert_allclose(got[side], want[side], rtol=0, atol=ENCODE_ATOL)
        id_rows, f_rows, _ = side_rows(pt.state.model, pt.data, side, t)
        gate = tower_gate_values(pt.state.model.tower(side), id_rows, f_rows).numpy()
        jgate = np.asarray(jax_gate_values(
            jx.state.dense[f"{side}_tower"], getattr(jx.cfg, f"{side}_tower"),
            jnp.asarray(np.asarray(jx.state.tables[f"{side}_id"])[idx[side]]),
            jnp.asarray(feats[side][idx[side]]),
        ))
        np.testing.assert_allclose(gate, jgate, rtol=0, atol=ENCODE_ATOL)
        for key, value in port_emb.summarize_gate_values(gate).items():
            assert abs(value - jax_emb.summarize_gate_values(jgate)[key]) <= ENCODE_ATOL, key
        norms = port_emb.summarize_embedding_norms(got[side], label=side)
        for key, value in jax_emb.summarize_embedding_norms(want[side], label=side).items():
            assert norms[key] == value if key in ("label", "count") else abs(norms[key] - value) <= ENCODE_ATOL
    align = port_emb.summarize_user_alignment(got["user"], feats["user"][idx["user"]])
    jalign = jax_emb.summarize_user_alignment(want["user"], feats["user"][idx["user"]])
    for key in ("cosine_mean", "cosine_std"):
        assert abs(align[key] - jalign[key]) <= ENCODE_ATOL
    assert tower_gate_values(pt.state.model.user_tower, id_rows, None) is None


def _report_inputs():
    metrics = compute_ranking_metrics({1: [3, 4, 5], 2: [9, 1]}, {1: {4}, 2: {7}}, [2, 5])
    stats = {
        "user_norms": jax_emb.summarize_embedding_norms(np.ones((3, 4)), label="user"),
        "item_norms": jax_emb.summarize_embedding_norms(np.arange(8.0).reshape(2, 4), label="item"),
        "item_neighbor_overlap": {"sampled_items": 2, "category_overlap_mean": 0.25,
                                  "category_overlap_std": 0.125, "k": 5},
        "user_alignment": {"aligned_users": 3, "cosine_mean": 0.5, "cosine_std": 0.1},
        "fusion_gate": {"user": jax_emb.summarize_gate_values(np.full((2, 3), 0.7)), "item": {}},
    }
    recs = [{
        "user_id": "U1", "user_idx": 1, "category_match": 0.5, "author_match": 0.0,
        "history_categories": {"History", "History > Classic", "Poetry"},
        "history_authors": {"Author 1"},
        "recommendations": [
            {"asin": "A1", "title": "T1", "author": "", "categories": ["History"]},
            {"asin": "A2", "title": "T2", "author": "Author 2", "categories": []},
        ],
    }]
    correlations = [{"feature": "numeric:price", "pearson_r": -0.25, "p_value": 3.2e-4}]
    history = SimpleNamespace(train_loss=[0.7, 0.6, 0.5], val_loss=[0.65, 0.6], test_loss=[])
    mimic = {"user": {"mean_norm": 0.1, "std_norm": 0.01}, "item": {}}
    return metrics, stats, recs, correlations, history, mimic


@pytest.mark.parametrize("with_plot", [True, False])
def test_report_files_are_byte_equal_to_the_jax_writers(tmp_path, with_plot):
    metrics, stats, recs, correlations, history, mimic = _report_inputs()
    plot = tmp_path / "loss.png" if with_plot else None
    for name, writer in (("port", write_recommendation_report),
                         ("jax", jax_reports.write_recommendation_report)):
        writer(tmp_path / name / "report.md", metrics_summary=metrics, embedding_stats=stats,
               recommendations=recs, loss_plot_path=plot, history=history,
               monitor_metric="recall@10", best_epoch=2, feature_correlations=correlations)
    for name, writer in (("port", write_embedding_summary),
                         ("jax", jax_reports.write_embedding_summary)):
        writer(tmp_path / name / "summary.json", embedding_stats=stats, mimic_stats=mimic,
               feature_correlations=correlations, monitor_metric="recall@10", best_epoch=2)
    for file in ("report.md", "summary.json"):
        assert (tmp_path / "port" / file).read_bytes() == (tmp_path / "jax" / file).read_bytes()


def test_loss_plot_is_a_png_and_an_empty_history_raises(tmp_path):
    out = save_loss_curves({"Train": [0.7, 0.5], "Validation": [], "Test": [0.6, 0.55]},
                           output_path=tmp_path / "sub" / "loss.png")
    assert out == tmp_path / "sub" / "loss.png"
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    for save in (save_loss_curves, jax_plots.save_loss_curves):
        with pytest.raises(ValueError, match="empty"):
            save({"Train": [], "Validation": []}, output_path=tmp_path / "never.png")
    assert not (tmp_path / "never.png").exists()


def _dataset(pos: np.ndarray) -> SimpleNamespace:
    """The fields ``_log_recommendations`` reads, for the setup's users,
    items and positives."""
    histories = {u: {int(i) for i in row if i < NI} for u, row in enumerate(pos)}
    pairs = [(u, i) for u, items in histories.items() for i in sorted(items)]
    return SimpleNamespace(
        user_mapping=list(range(NU)), item_mapping=list(range(NI)),
        items=_items_frame(NI, 2),
        users=pd.DataFrame({"user_idx": np.arange(NU), "userId": [f"U{u:04d}" for u in range(NU)]}),
        interactions=pd.DataFrame(pairs, columns=["user_idx", "item_idx"]),
        user_positive_items=histories,
    )


@pytest.mark.parametrize("seed, top_k", [(11, 5), (5, 12)])
def test_sample_recommendations_match_jax(sides, seed, top_k):
    """The same users (JAX draws from the seeded global ``random``, the port
    from ``random.Random(seed)``) and the same recommended ids, but where
    two scores tie within 1e-5."""
    jx, pt, pos = sides
    dataset = _dataset(pos)
    jitems = jax_encode_corpus(jx.state, jx.data, jx.cfg, "item", num_rows=NI)
    random.seed(seed)
    want = jax_training._log_recommendations(
        jx.state, jx.data, jx.cfg, dataset, jitems, sample_users=6, top_k=top_k,
    )
    items = encode_corpus(pt.state.model, "item", pt.data.item_features)
    got = port_training._log_recommendations(
        pt.state.model, pt.data, dataset, items, sample_users=6, top_k=top_k,
        rng=random.Random(seed),
    )
    assert [g["user_idx"] for g in got] == [w["user_idx"] for w in want]
    unit = torch.nn.functional.normalize(items, dim=-1).numpy()
    asin_to_idx = {a: i for i, a in enumerate(dataset.items["parent_asin"])}
    for g, w in zip(got, want):
        q = encode_rows(pt.state.model, pt.data, "user", torch.tensor([g["user_idx"]], dtype=torch.int32))
        scores = unit @ torch.nn.functional.normalize(q, dim=-1).numpy()[0]
        ids = [[asin_to_idx[r["asin"]] for r in e["recommendations"]] for e in (g, w)]
        assert len(ids[0]) == len(ids[1]) == top_k
        for a, b in zip(*ids):
            assert a == b or abs(scores[a] - scores[b]) <= TIE_TOL, (g["user_idx"], ids)
        if ids[0] == ids[1]:
            assert (g["category_match"], g["author_match"]) == (w["category_match"], w["author_match"])
        assert g["history_categories"] == w["history_categories"]
        assert g["user_id"] == w["user_id"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("reports")
    write_synthetic_csvs(root / "data", num_users=300, num_items=200, num_interactions=4000, seed=3)
    config = _config(root)
    config["data"].update(use_cache=True, cache_dir=str(root / "cache"))
    config["diagnostics"] = {
        "item_sample_size": 40, "user_sample_size": 60, "neighbor_k": 5,
        "report_path": str(root / "reports" / "report.md"),
        "loss_plot_path": str(root / "reports" / "loss.png"),
        "embedding_summary_path": str(root / "reports" / "diag.json"),
    }
    config["recommendations"] = {"sample_users": 3, "top_k": 4}
    config["training"]["early_stopping"] = {"enabled": True, "metric": "recall@10", "patience": 2}
    return root, config, port_training.run_single_experiment(config, device="cpu")


def test_trainer_writes_the_four_artifacts_in_the_jax_format(trained, tmp_path):
    root, config, result = trained
    report = root / "reports" / "report.md"
    assert result.loss_plot_path == root / "reports" / "loss.png"
    assert result.loss_plot_path.read_bytes()[:4] == b"\x89PNG"
    assert result.embedding_summary_path == root / "reports" / "diag.json"
    text = report.read_text(encoding="utf-8")
    recall = ", ".join(f"@{k}={v:.4f}" for k, v in result.best_val_metrics.recall.items())
    assert f"- **Recall**: {recall}" in text
    assert text.count("- **User** `") == 3 and f"![Loss curves]({result.loss_plot_path})" in text
    summary = json.loads(result.embedding_summary_path.read_text())
    assert summary["best_epoch"] == result.best_epoch and summary["monitor_metric"] == "recall@10"
    assert summary["embedding_stats"]["item_norms"]["count"] == 40
    assert summary["embedding_stats"]["user_norms"]["count"] == 60
    assert set(summary["adaptive_mimic"]) == {"user", "item"} and summary["adaptive_mimic"]["user"]
    assert summary["embedding_stats"]["fusion_gate"]["item"]["rows"] == 40
    # the same diagnostics again (one seeded draw) through the JAX writers
    state, data = result.state, result.data
    diag = port_training.run_diagnostics(
        state.model, data, port_training._prepare_data(config, False),
        encode_corpus(state.model, "item", data.item_features),
        diagnostics=config["diagnostics"], recommendations=config["recommendations"],
        seed=config["experiment"]["seed"],
    )
    jax_reports.write_recommendation_report(
        tmp_path / "report.md", metrics_summary=result.best_val_metrics,
        embedding_stats=diag.embedding_stats, recommendations=diag.recommendations,
        loss_plot_path=result.loss_plot_path, history=result, monitor_metric="recall@10",
        best_epoch=result.best_epoch, feature_correlations=diag.feature_correlations,
    )
    jax_reports.write_embedding_summary(
        tmp_path / "diag.json", embedding_stats=diag.embedding_stats, mimic_stats=diag.mimic_stats,
        feature_correlations=diag.feature_correlations, monitor_metric="recall@10",
        best_epoch=result.best_epoch,
    )
    assert (tmp_path / "report.md").read_bytes() == report.read_bytes()
    assert (tmp_path / "diag.json").read_bytes() == result.embedding_summary_path.read_bytes()


def _warnings(monkeypatch, *loggers) -> list[str]:
    """The messages of ``warning`` calls on the port's ``loggers`` (which
    do not propagate to the root logger)."""
    seen: list[str] = []
    for log in loggers:
        monkeypatch.setattr(log, "warning", lambda msg, *args: seen.append(msg % args))
    return seen


def test_the_report_is_written_without_matplotlib(trained, tmp_path, monkeypatch):
    """No matplotlib: a warning naming it, no image, the report without its
    loss section (as the JAX report without a plot)."""
    _, config, result = trained

    def no_matplotlib(*args, **kwargs):
        raise ModuleNotFoundError("No module named 'matplotlib'", name="matplotlib")

    monkeypatch.setattr(port_training, "save_loss_curves", no_matplotlib)
    result = SimpleNamespace(**vars(result))
    result.loss_plot_path = None
    diag = port_training.RunDiagnostics({
        "user_norms": port_emb.summarize_embedding_norms(np.ones((2, 3)), label="user"),
        "item_norms": port_emb.summarize_embedding_norms(np.ones((2, 3)), label="item"),
        "item_neighbor_overlap": {"category_overlap_mean": 0.0, "category_overlap_std": 0.0, "k": 5},
        "user_alignment": {"cosine_mean": 0.0, "cosine_std": 0.0},
    }, {"user": {}, "item": {}}, [], [])
    warned = _warnings(monkeypatch, port_training.logger)
    port_training._write_reports(
        result, diag, [5, 10], "recall@10", report_path=tmp_path / "r.md",
        loss_plot_target=tmp_path / "loss.png", embedding_summary_path=tmp_path / "d.json",
    )
    assert warned == ["Loss plot not written: matplotlib is not installed"]
    assert result.loss_plot_path is None and not (tmp_path / "loss.png").exists()
    text = (tmp_path / "r.md").read_text()
    assert "## Loss Curves" not in text and "## Embedding Diagnostics" in text


def test_the_dataset_cache_is_written_once_then_read(trained, monkeypatch):
    root, config, _ = trained
    assert len(list((root / "cache").glob("dataset_*.pkl"))) == 1  # the trainer's run wrote it
    rebuilt = port_training.prepare_data(config)
    calls = []
    monkeypatch.setattr(port_training, "prepare_data", lambda cfg: calls.append(cfg))
    warned = _warnings(monkeypatch, port_training.logger, cache_module.logger)
    dataset = port_training._prepare_data(config, False)
    assert calls == [] and warned == []  # read, with no warning
    pd.testing.assert_frame_equal(dataset.interactions, rebuilt.interactions)
    pd.testing.assert_frame_equal(dataset.items, rebuilt.items)
    np.testing.assert_array_equal(dataset.item_feature_matrix, rebuilt.item_feature_matrix)
    np.testing.assert_array_equal(dataset.user_feature_matrix, rebuilt.user_feature_matrix)
    assert dataset.user_mapping.index_to_id == rebuilt.user_mapping.index_to_id
    assert dataset.user_positive_items == rebuilt.user_positive_items
    monkeypatch.undo()
    # another data setting: another key, prepared afresh and cached beside it
    other = dict(config, data=dict(config["data"], min_item_interactions=3))
    port_training._prepare_data(other, False)
    assert len(list((root / "cache").glob("dataset_*.pkl"))) == 2
