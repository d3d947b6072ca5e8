"""The port's sparse mimic tables (``adaptive_mimic.sparse``: sparse-row Adam
on ``user_aug`` / ``item_aug``, each ending in a zero scratch row) against
the JAX package, on the CPU, in the recommended configuration
(``configs/in_batch_softmax.yaml``: the logQ-corrected in-batch softmax).

- the tables' layout and which optimizer takes each tensor;
- three train steps of the recommended configuration, with the clip off
  (the config as shipped, M = 0) and on (with mixed negatives and sparse
  weight decay), against JAX's ``train_step``: losses rtol 1e-5, every
  table, dense parameter and optimizer moment atol 2e-5 (the tolerance of
  tests/test_torch_port_train_step.py), the scratch rows still zero;
- a port checkpoint of that state read by ``ttamm_tpu.train.checkpoint``
  and a JAX one read by the port, bit for bit;
- ``encode_corpus`` of a sparse-mimic state against JAX's (atol 1e-5:
  float32 towers, sums in another order), over the first rows only;
- ``logical_rows`` and the mesh padding of a sparse mimic table;
- ``run_single_experiment`` of the recommended configuration at test
  widths on the CPU: it trains, evaluates, checkpoints and writes a serving
  bundle of the dense-mimic shapes.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import torch_step_setup as ts
from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.models import parse_model_config
from ttamm_torch.models.convert import train_state_to_flat
from ttamm_torch.parallel import logical_rows, pad_state_rows, padded_rows
from ttamm_torch.pipelines.export import export_bundle
from ttamm_torch.pipelines.training import run_single_experiment
from ttamm_torch.train import checkpoint as port_ckpt
from ttamm_torch.train import create_train_state, make_train_step
from ttamm_torch.train.state import dense_table_names, sparse_table_names
from ttamm_torch.train.step import encode_corpus
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import step as jax_step

REPO = Path(__file__).resolve().parents[1]
NU, NI, D = ts.NU, ts.NI, ts.D
MIMIC = ("user_aug", "item_aug")

VARIANTS = {
    "shipped": dict(clip=None, mixed=0),
    "clip_mixed_decay": dict(clip=0.5, mixed=32, sparse_wd=0.01, temperature=0.5),
}


def test_sparse_mimic_tables_take_sparse_row_adam():
    _, pt, _, _ = ts.setup()
    assert sparse_table_names(pt.cfg) == ("user_id", "item_id", "user_aug", "item_aug")
    assert dense_table_names(pt.cfg) == ()
    state = pt.state
    assert state.tables["user_aug"].shape == (NU + 1, D)
    assert state.tables["item_aug"].shape == (NI + 1, D)
    assert set(state.opt_sparse) == {"user_id", "item_id", "user_aug", "item_aug"}
    # AdamW (and its weight decay) takes the dense parameters only
    assert [k for k, _ in state.dense_targets()] == [
        f"dense/{k}" for k, _ in state.model.dense_parameters()
    ]
    # a seeded port state: N(0, std) rows, then the zero scratch row
    seeded = create_train_state(pt.cfg, num_users=NU, num_items=NI, seed=4, device="cpu")
    for name in MIMIC:
        table = seeded.tables[name]
        assert torch.all(table[-1] == 0) and float(table[:-1].std()) == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_recommended_train_step_matches_jax(variant):
    jx, pt, pos, rng = ts.setup(**VARIANTS[variant])
    losses, want, got = ts.run_steps(jx, pt, pos, rng)
    ts.assert_steps_match(losses, want, got)
    assert not any(k.startswith("opt_dense/m/tables/") for k in got)
    for name in MIMIC:
        assert f"opt_sparse/{name}/m" in got
        assert not got[f"tables/{name}"][-1].any()  # the scratch row stays zero
        assert got[f"tables/{name}"].shape[0] == (NU if name == "user_aug" else NI) + 1


def _one_port_step(pt, pos, rng):
    u, p = ts.batch(rng, pos, 16)
    make_train_step(pt.cfg, pt.tscfg)(
        pt.state, pt.data, torch.from_numpy(u), torch.from_numpy(p), generator=None,
        negatives=torch.zeros(0, dtype=torch.int32),
    )


def test_port_checkpoint_read_by_jax_and_back(tmp_path):
    jx, pt, pos, rng = ts.setup()
    _one_port_step(pt, pos, rng)
    path = port_ckpt.save_checkpoint(
        tmp_path, pt.state, experiment_name="port", epoch=1, metric_name="recall@10",
        metric_value=0.5,
    )
    restored, meta = jax_ckpt.load_checkpoint(path, jx.state)
    assert meta["epoch"] == 1 and int(restored.opt_sparse["item_aug"].step) == 1
    flat = train_state_to_flat(pt.state)
    assert "opt_sparse/user_aug/v" in flat and "opt_dense/v/tables/user_aug" not in flat
    for key, value in jax_ckpt.state_to_host(restored).items():
        np.testing.assert_array_equal(np.asarray(value), flat[key], err_msg=key)
    fresh = create_train_state(pt.cfg, num_users=NU, num_items=NI, seed=3, device="cpu")
    fresh, _ = port_ckpt.load_checkpoint(path, fresh)
    for key, value in train_state_to_flat(fresh).items():
        np.testing.assert_array_equal(value, flat[key], err_msg=key)


def test_jax_checkpoint_read_by_port(tmp_path):
    jx, pt, pos, rng = ts.setup()
    u, p = ts.batch(rng, pos, 16)
    jstate, _ = jax_step.make_train_step(jx.cfg, jx.tscfg)(
        jx.state, jx.data, jax.numpy.asarray(u), jax.numpy.asarray(p), jax.random.key(3)
    )
    path = jax_ckpt.save_checkpoint(
        tmp_path, jstate, experiment_name="jax", epoch=2, metric_name=None, metric_value=None,
    )
    state = create_train_state(pt.cfg, num_users=NU, num_items=NI, seed=0, device="cpu")
    state, meta = port_ckpt.load_checkpoint(path, state)
    assert meta["epoch"] == 2 and state.opt_sparse["user_aug"].step == 1
    flat = train_state_to_flat(state)
    for key, value in jax_ckpt.state_to_host(jstate).items():
        np.testing.assert_array_equal(flat[key], np.asarray(value), err_msg=key)


@pytest.mark.parametrize("side", ["user", "item"])
def test_encode_reads_the_first_rows_of_a_sparse_mimic_table(side):
    jx, pt, _, _ = ts.setup()
    rows = NU if side == "user" else NI
    want = jax_step.encode_corpus(jx.state, jx.data, jx.cfg, side, num_rows=rows, chunk_size=64)
    feats = pt.data.user_features if side == "user" else pt.data.item_features
    got = encode_corpus(pt.state.model, side, feats, chunk_size=64)
    assert got.shape == (rows, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mimic_sparse", [True, False])
def test_logical_rows_and_padding_of_the_mimic_tables(mimic_sparse):
    cfg = parse_model_config(ts.model_yaml(mimic_sparse), user_feature_dim=ts.FU,
                             item_feature_dim=ts.FI)
    state = create_train_state(cfg, num_users=NU, num_items=NI, seed=1, device="cpu")
    extra = int(mimic_sparse)
    want = {"user_id": NU + 1, "item_id": NI + 1, "user_aug": NU + extra, "item_aug": NI + extra}
    assert {n: logical_rows(state.model, n) for n in state.tables} == want
    assert {n: t.shape[0] for n, t in state.tables.items()} == want
    padded = pad_state_rows(state, 4)
    for name, table in padded.tables.items():
        side_rows = NU if name.startswith("user") else NI
        assert table.shape[0] == padded_rows(side_rows, 4)
        torch.testing.assert_close(table[: want[name]], state.tables[name], rtol=0, atol=0)
        assert not table[want[name]:].any()
    for name, sparse in padded.opt_sparse.items():
        assert sparse.m.shape == padded.tables[name].shape


def _recommended_config(root):
    """configs/in_batch_softmax.yaml at test widths on a small corpus."""
    config = yaml.safe_load((REPO / "configs" / "in_batch_softmax.yaml").read_text())
    for side in ("user_encoder", "item_encoder"):
        enc = config["model"][side]
        enc["id_embedding"]["params"]["embedding_dim"] = 16
        enc["feature_encoder"].update(hidden_dims=[32], output_dim=16)
        enc["output_dim"] = 16
    config["data"].update(root=str(root / "data"), min_user_interactions=2,
                          min_item_interactions=2)
    config["data"]["feature_params"].update(category_top_k=5, author_top_k=4)
    config["training"].update(batch_size=256, num_epochs=2, learning_rate=0.01,
                              category_alignment_max_categories=16)
    config["training"]["checkpointing"]["dir"] = str(root / "ckpt")
    config["experiment"]["benchmark_report"] = str(root / "reports" / "summary.md")
    config["evaluation"]["faiss"].update(index_path=str(root / "faiss" / "items.index"),
                                         embedding_path=str(root / "faiss" / "items.npy"))
    config["evaluation"]["user_batch_size"] = 128
    config["diagnostics"].update(
        report_path=str(root / "reports" / "recommendation_report.md"),
        loss_plot_path=str(root / "reports" / "loss_curve.png"),
        embedding_summary_path=str(root / "reports" / "embedding_diagnostics.json"),
    )
    config["logging"]["level"] = "WARNING"
    return config


def test_recommended_config_trains_on_the_cpu(tmp_path):
    write_synthetic_csvs(tmp_path / "data", num_users=300, num_items=200, num_interactions=4000,
                         seed=3)
    config = _recommended_config(tmp_path)
    result = run_single_experiment(config, device="cpu")
    assert result.step_config.loss_type == "in_batch_softmax"
    assert result.step_config.logq_correction and result.data.item_log_q is not None
    assert len(result.train_loss) == 2
    assert all(np.isfinite([result.first_step_loss, *result.train_loss, *result.val_loss]))
    assert result.train_loss[-1] < result.first_step_loss
    for m in result.val_metrics:
        assert m.recall[5] <= m.recall[10]
    assert result.best_checkpoint_path.is_file() and result.checkpoint_path.is_file()
    with np.load(result.checkpoint_path) as blob:
        assert blob["tables/user_aug"].shape == (result.num_users + 1, 16)
        assert "opt_sparse/item_aug/m" in blob.files
        assert not any(k.startswith("opt_dense/m/tables/") for k in blob.files)
    # the serving bundle has the dense-mimic shapes: no scratch row
    serve_dir = tmp_path / "faiss"
    users = np.load(serve_dir / "user_embeddings.npy")
    assert users.shape == (result.num_users, 16)
    assert np.load(serve_dir / "items.npy").shape == (result.num_items, 16)
    vocab = json.loads((serve_dir / "vocab.json").read_text())
    assert (len(vocab["user_ids"]), len(vocab["item_ids"])) == (result.num_users, result.num_items)
    # export from the best checkpoint gives the trainer's bundle
    export_bundle(config, tmp_path / "bundle", device="cpu",
                  checkpoint=result.best_checkpoint_path)
    np.testing.assert_allclose(np.load(tmp_path / "bundle" / "user_embeddings.npy"), users,
                               rtol=0, atol=1e-6)
