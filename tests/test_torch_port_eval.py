"""The port's retrieval eval, early stopping and trainer bookkeeping against
the JAX package, on the CPU.

- The metrics functions (``ttamm_torch/evaluation/metrics.py``, a copy) to
  1e-12.
- ``build_eval_plan``: buckets, padding, ground truth and ``deep_k``, with a
  heavy user over 32 positives and a capped blocked matrix.
- ``evaluate_retrieval_metrics`` (hit matrices per batch and metrics) and
  ``evaluate_retrieval`` (MIPS with and without a plan, and the sampled
  path) on a JAX state carried over by ``ttamm_torch/models/convert.py``,
  and the GT-append quirk on a 6-item corpus: hit matrices and predictions
  equal, metrics to 1e-12. (The JAX searches run their XLA paths on the CPU;
  the port's its plain versions, so the select kernel's plain version is on
  the float32 path here.)
- ``EarlyStoppingController`` over seeded sequences, both modes.
- The slice: three epochs of the trainer on the tiny corpus with the eval
  on; its best state, carried back with ``train_state_to_flat``, must give
  the JAX eval the val metrics the port logged, and the best checkpoint's
  name, ``_last.pt`` and the serving dtype must be what the JAX bookkeeping
  gives for the logged metrics.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ttamm_torch.data import split_train_validation_test, write_synthetic_csvs
from ttamm_torch.evaluation import metrics as port_metrics
from ttamm_torch.evaluation import retrieval as port_eval
from ttamm_torch.models import parse_model_config as port_parse
from ttamm_torch.models.convert import from_jax_params, train_state_to_flat
from ttamm_torch.pipelines import training as port_training
from ttamm_torch.pipelines.export import prepare_data
from ttamm_torch.serve import FlatIndex
from ttamm_torch.train import BatchData
from ttamm_tpu.data import pack_positives, positives_from_frame
from ttamm_tpu.evaluation import metrics as jax_metrics
from ttamm_tpu.evaluation import retrieval as jax_eval
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.pipelines import training as jax_training
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import state as jax_state
from ttamm_tpu.train.step import encode_corpus as jax_encode_corpus

K_VALUES = [5, 10]


def _assert_metrics_equal(got, want, k_values):
    for name in ("recall", "precision", "ndcg", "hit_rate", "map"):
        for k in k_values:
            assert getattr(got, name)[k] == pytest.approx(getattr(want, name)[k], abs=1e-12), (name, k)
    assert got.mrr == pytest.approx(want.mrr, abs=1e-12)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    hit = (rng.random((50, 20)) < 0.2).astype(np.float64)
    sizes = rng.integers(0, 4, 50)
    _assert_metrics_equal(
        port_metrics.metrics_from_hit_matrix(hit, sizes, [1, 5, 20]),
        jax_metrics.metrics_from_hit_matrix(hit, sizes, [1, 5, 20]), [1, 5, 20],
    )
    preds = {u: [int(x) for x in rng.permutation(30)[: rng.integers(0, 15)]] for u in range(40)}
    gts = {u: {int(x) for x in rng.integers(0, 30, rng.integers(0, 4))} for u in range(40)}
    got = port_metrics.compute_ranking_metrics(preds, gts, [3, 10])
    want = jax_metrics.compute_ranking_metrics(preds, gts, [3, 10])
    _assert_metrics_equal(got, want, [3, 10])
    assert len(got.per_user) == len(want.per_user)
    for a, b in zip(got.per_user, want.per_user):
        assert a.keys() == b.keys() and all(abs(a[key] - b[key]) <= 1e-12 for key in a)
    for u in range(5):
        a = port_metrics.per_user_metrics(preds[u], gts[u], [3, 10])
        b = jax_metrics.per_user_metrics(preds[u], gts[u], [3, 10])
        assert a.keys() == b.keys() and all(abs(a[key] - b[key]) <= 1e-12 for key in a)


# ---------------------------------------------------------------------------
# A JAX state and its port twin
# ---------------------------------------------------------------------------

NU, NI, FU, FI, D = 60, 700, 7, 5, 16  # 700 items: a ragged 60-item tail group


def _tower(sparse):
    return {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": D, "sparse": sparse}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [16], "output_dim": D},
        "fusion": "gated",
    }


@pytest.fixture(scope="module")
def twins():
    model_yaml = {
        "user_encoder": _tower(True), "item_encoder": _tower(False),
        "similarity": "cosine", "adaptive_mimic": {"enabled": True},
    }
    jcfg = jax_parse(model_yaml, user_feature_dim=FU, item_feature_dim=FI)
    pcfg = port_parse(model_yaml, user_feature_dim=FU, item_feature_dim=FI)
    jstate = jax_state.create_train_state(jax.random.key(4), jcfg, num_users=NU, num_items=NI)
    model = from_jax_params(
        pcfg, jax.device_get(jstate.tables), jax.device_get(jstate.dense), device="cpu"
    )
    rng = np.random.default_rng(0)
    uf = rng.normal(0, 1, (NU, FU)).astype(np.float32)
    itf = rng.normal(0, 1, (NI, FI)).astype(np.float32)
    jdata = jax_state.BatchData(jnp.asarray(uf), jnp.asarray(itf), jnp.zeros((NU, 1), jnp.int32), None)
    pdata = BatchData(torch.from_numpy(uf), torch.from_numpy(itf), torch.zeros((NU, 1), dtype=torch.int32), None)
    # 1-3 held-out items per user; train positives of 2-12 items, one user
    # with 45 (over the 32-wide bucket) and one with none
    rows = [(u, int(i)) for u in range(NU) for i in set(rng.integers(0, NI, rng.integers(1, 4)))]
    val = pd.DataFrame({"user_idx": [r[0] for r in rows], "item_idx": [r[1] for r in rows]})
    train = {u: {int(x) for x in rng.integers(0, NI, rng.integers(2, 13))} for u in range(NU)}
    train[7] = {int(x) for x in rng.permutation(NI)[:45]}
    train[8] = set()
    return jcfg, jstate, jdata, model, pdata, val, train


def _assert_plans_equal(got, want):
    assert got.batches == want.batches and got.gt_per_user == want.gt_per_user
    assert (got.deep_k, got.num_items) == (want.deep_k, want.num_items)
    np.testing.assert_array_equal(got.user_mat.numpy(), np.asarray(want.user_mat))
    np.testing.assert_array_equal(got.gt_mat.numpy(), np.asarray(want.gt_mat))
    np.testing.assert_array_equal(got.gt_sizes, want.gt_sizes)
    np.testing.assert_array_equal(got.blocked_rows.numpy(), np.asarray(want.blocked_rows))
    assert (got.wide is None) == (want.wide is None)
    if got.wide is not None:
        _assert_plans_equal(got.wide, want.wide)


def _plans(val, train, blocked=None, batch=16):
    kw = dict(num_users=NU, num_items=NI, k_values=K_VALUES, user_batch_size=batch)
    got = port_eval.build_eval_plan(
        val, train, device="cpu",
        blocked_rows=None if blocked is None else torch.from_numpy(blocked), **kw,
    )
    want = jax_eval.build_eval_plan(
        val, train, blocked_rows=None if blocked is None else jnp.asarray(blocked), **kw
    )
    return got, want


@pytest.mark.parametrize("case", ["bucketed", "narrow", "capped"])
def test_build_eval_plan_matches_jax(twins, case):
    *_, val, train = twins
    blocked = None
    if case == "narrow":
        train = {u: set(list(p)[:10]) for u, p in train.items()}
    if case == "capped":  # a positives_cap that cuts the heavy user: rebuilt uncapped
        blocked = pack_positives(train, num_users=NU, num_items=NI, cap=16).rows
    got, want = _plans(val, train, blocked)
    _assert_plans_equal(got, want)
    assert (got.wide is not None) == (case != "narrow")


def _jax_items(jcfg, jstate, jdata):
    items = jax_encode_corpus(jstate, jdata, jcfg, "item", num_rows=NI)
    return items / jnp.maximum(jnp.linalg.norm(items, axis=-1, keepdims=True), 1e-12)


def test_evaluate_retrieval_metrics_matches_jax(twins):
    jcfg, jstate, jdata, model, pdata, val, train = twins
    plan, jplan = _plans(val, train)
    items = port_eval._corpus(model, pdata, None)
    jitems = _jax_items(jcfg, jstate, jdata)
    for bucket, jbucket in zip(port_eval._plan_buckets(plan), jax_eval._plan_buckets(jplan)):
        want = jax_eval._scan_encode_search_hits(
            jstate, jdata, jcfg, jbucket.user_mat, jbucket.gt_mat, jitems, jbucket.blocked_rows,
            deep_k=jbucket.deep_k, chunk=8192, cosine=True, max_k=10,
        )
        for b in range(len(bucket.batches)):
            got = port_eval.batch_hits(model, pdata, items, bucket, b, max_k=10)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[b]))
    _assert_metrics_equal(
        port_eval.evaluate_retrieval_metrics(model, pdata, plan=plan, k_values=K_VALUES),
        jax_eval.evaluate_retrieval_metrics(jstate, jdata, jcfg, plan=jplan, k_values=K_VALUES),
        K_VALUES,
    )


@pytest.mark.parametrize("path", ["plan", "batched", "sampled"])
def test_evaluate_retrieval_matches_jax(twins, path):
    jcfg, jstate, jdata, model, pdata, val, train = twins
    kw = dict(
        val_interactions=val, train_positive_map=train, num_items=NI, k_values=K_VALUES,
        use_mips=path != "sampled", candidate_samples=30, user_batch_size=16,
    )
    plan, jplan = _plans(val, train) if path == "plan" else (None, None)
    got = port_eval.evaluate_retrieval(model, pdata, plan=plan, rng=np.random.default_rng(5), **kw)
    want = jax_eval.evaluate_retrieval(jstate, jdata, jcfg, plan=jplan, rng=np.random.default_rng(5), **kw)
    assert got == want


def test_gt_append_quirk_on_a_six_item_corpus():
    """Most of a 6-item corpus blocked: the missed GT items are appended,
    by both eval paths, as in the JAX package."""
    model_yaml = {
        "user_encoder": {"type": "embedding", "params": {"embedding_dim": 8}},
        "item_encoder": {"type": "embedding", "params": {"embedding_dim": 8}},
        "similarity": "dot", "adaptive_mimic": {"enabled": False},
    }
    jcfg = jax_parse(model_yaml, user_feature_dim=0, item_feature_dim=0)
    pcfg = port_parse(model_yaml, user_feature_dim=0, item_feature_dim=0)
    jstate = jax_state.create_train_state(jax.random.key(2), jcfg, num_users=3, num_items=6)
    model = from_jax_params(pcfg, jax.device_get(jstate.tables), jax.device_get(jstate.dense), device="cpu")
    jdata = jax_state.BatchData(None, None, jnp.zeros((3, 1), jnp.int32), None)
    pdata = BatchData(None, None, torch.zeros((3, 1), dtype=torch.int32), None)
    blocked = {0: {0, 1, 2, 3}, 1: {5}, 2: {0, 1, 2, 3, 4}}
    val = pd.DataFrame({"user_idx": [0, 1, 1, 2], "item_idx": [4, 2, 5, 1]})
    kw = dict(val_interactions=val, train_positive_map=blocked, num_items=6, k_values=[5])
    got = port_eval.evaluate_retrieval(model, pdata, **kw)
    want = jax_eval.evaluate_retrieval(jstate, jdata, jcfg, **kw)
    assert got == want
    # user 2 has one unblocked item; its blocked GT item is appended after it
    assert set(got[0][0]) == {4, 5} and got[0][2] == [5, 1]
    plan = port_eval.build_eval_plan(
        val, blocked, num_users=3, num_items=6, k_values=[5], device="cpu"
    )
    jplan = jax_eval.build_eval_plan(val, blocked, num_users=3, num_items=6, k_values=[5])
    _assert_metrics_equal(
        port_eval.evaluate_retrieval_metrics(model, pdata, plan=plan, k_values=[5]),
        jax_metrics.compute_ranking_metrics(*want, [5]), [5],
    )
    _assert_metrics_equal(
        port_eval.evaluate_retrieval_metrics(model, pdata, plan=plan, k_values=[5]),
        jax_eval.evaluate_retrieval_metrics(jstate, jdata, jcfg, plan=jplan, k_values=[5]), [5],
    )


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("min_delta", [0.0, 0.01])
@pytest.mark.parametrize("patience", [1, 3])
def test_early_stopping_matches_jax(mode, min_delta, patience):
    rng = np.random.default_rng(patience * 10 + int(min_delta * 100))
    values = np.cumsum(rng.normal(0, 0.02, 30)).tolist()
    values[4] = None  # an epoch without a metric
    got = port_training.EarlyStoppingController("recall@10", mode, patience, min_delta)
    want = jax_training.EarlyStoppingController("recall@10", mode, patience, min_delta)
    for epoch, v in enumerate(values, start=1):
        assert got.update(v, epoch) == want.update(v, epoch)
        assert (got.best_value, got.best_epoch, got.epochs_without_improvement) == (
            want.best_value, want.best_epoch, want.epochs_without_improvement
        )


# ---------------------------------------------------------------------------
# The slice: the trainer with the eval on, held to the JAX package
# ---------------------------------------------------------------------------


def _slice_config(root):
    tower = {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": 16, "dropout": 0.15},
        "fusion": "gated",
    }
    return {
        "experiment": {"name": "tiny", "seed": 3},
        "data": {
            "root": str(root / "data"), "min_user_interactions": 2, "min_item_interactions": 2,
            "train_fraction": 0.85, "test_fraction": 0.15,
            "feature_params": {"category_top_k": 5, "author_top_k": 4},
        },
        "model": {
            "user_encoder": tower, "item_encoder": tower,
            "similarity": "cosine", "adaptive_mimic": {"enabled": True},
        },
        "training": {
            "batch_size": 1024, "num_epochs": 3, "optimizer": "adamw",
            "weight_decay": 0.01, "learning_rate": 0.01,
            "loss_weights": {"mimic_user": 0.15, "mimic_item": 0.15, "category_alignment": 0.01},
            "category_alignment_max_categories": 16,
            "early_stopping": {
                "enabled": True, "metric": "recall@10", "mode": "max", "patience": 2,
                "min_delta": 0.0005,
            },
            "checkpointing": {"enabled": True, "dir": str(root / "ckpt"), "save_best_only": True},
        },
        "evaluation": {
            "metrics_k": [5, 10, 20], "user_batch_size": 512,
            "faiss": {
                "index_path": str(root / "faiss" / "items.index"),
                "embedding_path": str(root / "faiss" / "item_embeddings.npy"),
            },
        },
        "serving": {"score_dtype": "auto", "bf16_recall_gate": 0.002},
        "diagnostics": {
            "report_path": str(root / "reports" / "recommendation_report.md"),
            "loss_plot_path": str(root / "reports" / "loss_curve.png"),
            "embedding_summary_path": str(root / "reports" / "embedding_diagnostics.json"),
        },
        "logging": {"level": "WARNING"},
    }


def _jax_state_from_flat(flat, template):
    """A JAX TrainState whose leaves are the flat arrays (the checkpoint's
    key scheme)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path)

    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[key(p)]) for p, _ in leaves])


def test_trained_slice_matches_jax_bookkeeping(tmp_path):
    write_synthetic_csvs(tmp_path / "data", num_users=2000, num_items=1000, num_interactions=30000, seed=3)
    config = _slice_config(tmp_path)
    dataset = prepare_data(config)
    # The step is ~600 small ops: extra threads only contend (and the test
    # workers share the host's cores), so train on one.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = port_training.run_single_experiment(config, device="cpu", dataset=dataset)
    finally:
        torch.set_num_threads(threads)
    k_values = config["evaluation"]["metrics_k"]
    assert len(result.val_metrics) == len(result.train_loss) == len(result.test_loss)
    assert all(m is not None for m in result.val_metrics + result.test_metrics)

    # The JAX bookkeeping over the port's logged val metrics.
    es = config["training"]["early_stopping"]
    ctl = jax_training.EarlyStoppingController(es["metric"], es["mode"], es["patience"], es["min_delta"])
    template = config["training"]["checkpointing"].get(
        "filename_template", "{experiment}_{metric}_{value:.4f}_epoch{epoch}.pt"
    )
    stopped_after, best_files = None, {"tiny_last.pt"}
    for epoch, metrics in enumerate(result.val_metrics, start=1):
        stop = ctl.update(jax_training.extract_metric_value(metrics, es["metric"]), epoch)
        if ctl.best_epoch == epoch:  # an improvement writes a best checkpoint
            best_files.add(jax_ckpt.checkpoint_filename(
                template, experiment_name="tiny", metric_name=es["metric"],
                metric_value=ctl.best_value, epoch=epoch,
            ))
        if stop:
            stopped_after = epoch
            break
    assert len(result.val_metrics) == (stopped_after or 3)
    assert result.best_epoch == ctl.best_epoch
    want_name = jax_ckpt.checkpoint_filename(
        template, experiment_name="tiny", metric_name=es["metric"],
        metric_value=ctl.best_value, epoch=ctl.best_epoch,
    )
    assert result.best_checkpoint_path == tmp_path / "ckpt" / want_name
    assert result.checkpoint_path == tmp_path / "ckpt" / "tiny_last.pt"
    assert {p.name for p in (tmp_path / "ckpt").iterdir()} == best_files

    # The best state, carried back, gives the JAX eval the logged val metrics.
    jcfg = jax_parse(
        config["model"], user_feature_dim=dataset.user_feature_matrix.shape[1],
        item_feature_dim=dataset.item_feature_matrix.shape[1],
    )
    nu, ni = len(dataset.user_mapping), len(dataset.item_mapping)
    template = jax_state.create_train_state(jax.random.key(0), jcfg, num_users=nu, num_items=ni)
    jstate = _jax_state_from_flat(train_state_to_flat(result.state), template)
    jdata = jax_state.BatchData(
        jnp.asarray(dataset.user_feature_matrix), jnp.asarray(dataset.item_feature_matrix),
        jnp.zeros((nu, 1), jnp.int32), None,
    )
    train_df, val_df, _ = split_train_validation_test(
        dataset.interactions, train_fraction=0.85, test_fraction=0.15, seed=3
    )
    train_map = positives_from_frame(train_df)
    jplan = jax_eval.build_eval_plan(
        val_df, train_map, num_users=nu, num_items=ni, k_values=k_values, user_batch_size=512
    )
    want = jax_eval.evaluate_retrieval_metrics(jstate, jdata, jcfg, plan=jplan, k_values=k_values)
    _assert_metrics_equal(result.best_val_metrics, want, k_values)
    _assert_metrics_equal(result.val_metrics[result.best_epoch - 1], want, k_values)

    # The serving gate: the JAX bf16 re-run of the final val eval decides.
    bf16 = jax_eval.evaluate_retrieval_metrics(
        jstate, jdata, jcfg, plan=jplan, k_values=k_values, score_dtype="bfloat16"
    )
    worst = max(want.recall[k] - bf16.recall[k] for k in k_values)
    assert result.serving_score_dtype == ("bfloat16" if worst <= 0.002 else "float32")
    index = FlatIndex.load(tmp_path / "faiss" / "items.index", device="cpu")
    assert index.score_dtype == result.serving_score_dtype and len(index) == ni
    np.testing.assert_array_equal(
        np.load(tmp_path / "faiss" / "item_embeddings.npy"), index.embeddings
    )
    json.dumps(result.best_val_metrics.recall)  # the CLI's summary serialises
