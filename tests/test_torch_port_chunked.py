"""The ``chunked`` MIPS search of the port (``ttamm_torch/ops/topk.py``)
against the JAX package's, on the CPU.

``chunked`` scans the corpus in chunks with a running top-k, for corpora
past the slab ceiling (a float32 ``[64, N]`` slab over 2 GiB, N >
8,388,608). Tests run it at small sizes: explicitly, with a chunk given,
and through ``auto``, the eval, ``FlatIndex``, the sharded search and the
trainer with the slab ceiling lowered in the test process
(``SCORES_BYTES_CEILING`` in the port, ``_SCORES_BYTES_CEILING`` in the
JAX package, whose jit caches are cleared around the change). There the
port sizes its chunk from ``SCORES_BYTES_BUDGET`` (lowered too, so a scan
takes several chunks) and JAX takes its ``chunk_size``: the answers agree
whatever the two chunks are.

Tolerances: ids equal, ties included (both scans return ties by the lowest
item id); scores within 1e-6 (rtol and atol; the f32 sums of a chunk's
matmul run in another order). The bf16 and tie cases use dyadic inputs
(multiples of 1/4, exact in bf16 with exact sums), so both sides compute
identical scores and the many ties must break identically. The eval's hit
matrices and predictions are equal and its metrics within 1e-12.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from torch_ranks import launch
from ttamm_torch.evaluation import retrieval as port_eval
from ttamm_torch.models import from_jax_params
from ttamm_torch.models import parse_model_config as port_parse
from ttamm_torch.ops import topk
from ttamm_torch.ops.topk import mips_topk
from ttamm_torch.serve import FlatIndex
from ttamm_torch.train import BatchData
from ttamm_tpu.evaluation import retrieval as jax_eval
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.ops import topk as jax_topk
from ttamm_tpu.train import state as jax_state


def _inputs(kind, n, d, b, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        items = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((b, d)).astype(np.float32)
    else:  # dyadic: exact in bf16, exact sums, many ties
        items = (rng.integers(-4, 5, (n, d)) / 4).astype(np.float32)
        queries = (rng.integers(-4, 5, (b, d)) / 4).astype(np.float32)
    return queries, items


def _mask(queries, items, width, seed=1):
    """Each query's own best ids (half the width), random ids, and padding
    ids >= N; int32 [B, width]."""
    rng = np.random.default_rng(seed)
    n = items.shape[0]
    top = np.argsort(-(queries @ items.T), axis=1, kind="stable")[:, : width // 2]
    rand = rng.integers(0, n, (queries.shape[0], width - width // 2))
    mask = np.concatenate([top, rand], axis=1)
    mask[:, -1] = n + 3
    return mask.astype(np.int32)


def _check(got, want):
    gs, gi = (t.numpy() for t in got)
    ws, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi.astype(np.int64))
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-6)


@pytest.fixture
def lowered_ceiling(monkeypatch):
    """Lower both packages' slab ceilings to ``items`` items; the JAX jit
    caches are cleared before and after, so no trace holds either value."""

    def lower(items):
        jax.clear_caches()
        monkeypatch.setattr(topk, "SCORES_BYTES_CEILING", 64 * 4 * items)
        monkeypatch.setattr(jax_topk, "_SCORES_BYTES_CEILING", 64 * 4 * items)

    yield lower
    jax.clear_caches()


def _spy_chunked(monkeypatch):
    """Record the chunk of every chunk scan the port runs (``chunk_items``
    of its batch where no chunk is given)."""
    calls, scan = [], topk._chunked_topk

    def spy(*args, **kw):
        calls.append(kw.get("chunk_size") or topk.chunk_items(args[0].shape[0]))
        return scan(*args, **kw)

    monkeypatch.setattr(topk, "_chunked_topk", spy)
    return calls


# (n, chunk, k): a ragged last chunk, a corpus narrower than one chunk, and
# k wider than a chunk
SHAPES = {"ragged": (1000, 256, 20), "one_chunk": (300, 512, 20), "k_over_chunk": (200, 16, 40)}
CASES = [
    (score_dtype, kind, masked, shape)
    for score_dtype, kinds in (("float32", ("normal", "dyadic")), ("bfloat16", ("dyadic",)))
    for kind in kinds
    for masked in (False, True)
    for shape in SHAPES
]


@pytest.mark.parametrize("score_dtype,kind,masked,shape", CASES)
def test_chunked_matches_jax(score_dtype, kind, masked, shape):
    n, chunk, k = SHAPES[shape]
    q, items = _inputs(kind, n, 16, 12)
    mask = _mask(q, items, 8) if masked else None
    kw = dict(k=k, algorithm="chunked", chunk_size=chunk, score_dtype=score_dtype)
    want = jax_topk.mips_topk(jnp.asarray(q), jnp.asarray(items),
                              mask_rows=None if mask is None else jnp.asarray(mask), **kw)
    got = mips_topk(torch.from_numpy(q), torch.from_numpy(items),
                    mask_rows=None if mask is None else torch.from_numpy(mask), **kw)
    _check(got, want)
    if mask is not None:  # a blocked id comes back only at the float32 minimum
        ids, scores = got[1].numpy(), got[0].numpy()
        blocked = np.array([np.isin(row, m) for row, m in zip(ids, mask)])
        assert (scores[blocked] == np.finfo(np.float32).min).all()


def test_chunked_on_a_padded_corpus():
    """``num_valid_rows`` on a pre-padded corpus (``FlatIndex``'s): the same
    answer as the unpadded corpus, the pad rows never returned."""
    q, items = _inputs("normal", 300, 16, 7)
    padded = np.concatenate([items, np.zeros((84, 16), np.float32)])
    want = mips_topk(torch.from_numpy(q), torch.from_numpy(items), k=9, algorithm="chunked",
                     chunk_size=64)
    corpus = torch.from_numpy(padded)
    got = mips_topk(torch.from_numpy(q), corpus, k=9, num_valid_rows=300,
                    algorithm="chunked", chunk_size=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and int(got[1].max()) < 300
    with pytest.raises(ValueError, match="chunk_size"):
        mips_topk(torch.from_numpy(q), corpus, k=9, algorithm="chunked", chunk_size=0)


@pytest.mark.parametrize("case", ["float32", "bfloat16_d648"])
def test_auto_past_the_ceiling_matches_jax(monkeypatch, lowered_ceiling, case):
    """``auto`` past the lowered ceiling: both packages take ``chunked`` (a
    float32 search; a bf16 one whose shape groupmax_matmul refuses) and give
    the same ids; the port's chunk is the budget's (128 columns of 6
    queries), JAX's the one it is given."""
    score_dtype, dim = ("float32", 16) if case == "float32" else ("bfloat16", 648)
    kind = "normal" if case == "float32" else "dyadic"
    q, items = _inputs(kind, 700, dim, 6, seed=5)
    mask = _mask(q, items, 6)
    lowered_ceiling(699)
    monkeypatch.setattr(topk, "SCORES_BYTES_BUDGET", 4 * 6 * 128)
    calls = _spy_chunked(monkeypatch)
    kw = dict(k=12, score_dtype=score_dtype)
    got = mips_topk(torch.from_numpy(q), torch.from_numpy(items),
                    mask_rows=torch.from_numpy(mask), **kw)
    assert calls == [128]
    kw["chunk_size"] = 96
    want = jax_topk.mips_topk(jnp.asarray(q), jnp.asarray(items), mask_rows=jnp.asarray(mask), **kw)
    _check(got, want)
    want_chunked = jax_topk.mips_topk(jnp.asarray(q), jnp.asarray(items),
                                      mask_rows=jnp.asarray(mask), algorithm="chunked", **kw)
    _check(got, want_chunked)
    # within the ceiling, auto takes the slab again
    lowered_ceiling(700)
    mips_topk(torch.from_numpy(q), torch.from_numpy(items), mask_rows=torch.from_numpy(mask), **kw)
    assert calls == [128]


def test_flat_index_past_the_ceiling(monkeypatch, lowered_ceiling):
    """A float32 cosine index past the ceiling searches by ``chunked``
    (``auto``, or asked by name; chunks of 128 items under a lowered
    budget), as the JAX chunked search over its normalised rows."""
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((900, 16)).astype(np.float32)
    queries = rng.standard_normal((40, 16)).astype(np.float32)
    index = FlatIndex(emb / np.linalg.norm(emb, axis=1, keepdims=True), normalized=True,
                      device="cpu")
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    want = jax_topk.mips_topk(jnp.asarray(qn), jnp.asarray(index.embeddings), k=10,
                              algorithm="chunked")
    monkeypatch.setattr(topk, "SCORES_BYTES_BUDGET", 4 * 40 * 128)
    calls = _spy_chunked(monkeypatch)
    named = index.search(queries, 10, algorithm="chunked")
    lowered_ceiling(899)
    auto = index.search(queries, 10)
    assert calls == [128, 128]
    for got in (named, auto):
        np.testing.assert_array_equal(got[1], np.asarray(want[1]).astype(np.int64))
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    host = index.search(queries, 10, backend="numpy")
    np.testing.assert_array_equal(auto[1], host[1])


NU, NI, FU, FI, D = 60, 700, 7, 5, 16


def _tower(sparse):
    return {"type": "tower", "id_embedding": {"params": {"embedding_dim": D, "sparse": sparse}},
            "feature_encoder": {"type": "mlp", "hidden_dims": [16], "output_dim": D},
            "fusion": "gated"}


def test_eval_past_the_ceiling_matches_jax(monkeypatch, lowered_ceiling):
    """The eval at a ceiling below the corpus and a budget of 128 columns
    of a 16-user batch (JAX: ``topk_chunk_size`` = 128): the hit matrices
    and metrics of the plan path and the predictions of the batched path
    equal JAX's at its lowered ceiling."""
    model_yaml = {"user_encoder": _tower(True), "item_encoder": _tower(False),
                  "similarity": "cosine", "adaptive_mimic": {"enabled": True}}
    jcfg = jax_parse(model_yaml, user_feature_dim=FU, item_feature_dim=FI)
    pcfg = port_parse(model_yaml, user_feature_dim=FU, item_feature_dim=FI)
    jstate = jax_state.create_train_state(jax.random.key(4), jcfg, num_users=NU, num_items=NI)
    model = from_jax_params(pcfg, jax.device_get(jstate.tables), jax.device_get(jstate.dense),
                            device="cpu")
    rng = np.random.default_rng(0)
    uf = rng.normal(0, 1, (NU, FU)).astype(np.float32)
    itf = rng.normal(0, 1, (NI, FI)).astype(np.float32)
    jdata = jax_state.BatchData(jnp.asarray(uf), jnp.asarray(itf), jnp.zeros((NU, 1), jnp.int32),
                                None)
    pdata = BatchData(torch.from_numpy(uf), torch.from_numpy(itf),
                      torch.zeros((NU, 1), dtype=torch.int32), None)
    rows = [(u, int(i)) for u in range(NU) for i in set(rng.integers(0, NI, rng.integers(1, 4)))]
    val = pd.DataFrame({"user_idx": [r[0] for r in rows], "item_idx": [r[1] for r in rows]})
    train = {u: {int(x) for x in rng.integers(0, NI, rng.integers(2, 13))} for u in range(NU)}
    train[7] = {int(x) for x in rng.permutation(NI)[:45]}  # a user past the 32-wide bucket
    kw = dict(num_users=NU, num_items=NI, k_values=[5, 10], user_batch_size=16)
    plan = port_eval.build_eval_plan(val, train, device="cpu", **kw)
    jplan = jax_eval.build_eval_plan(val, train, **kw)

    lowered_ceiling(NI - 1)
    monkeypatch.setattr(topk, "SCORES_BYTES_BUDGET", 4 * 16 * 128)
    calls = _spy_chunked(monkeypatch)
    got = port_eval.evaluate_retrieval_metrics(model, pdata, plan=plan, k_values=[5, 10])
    assert 128 in calls  # a 16-user batch (a one-user bucket takes one chunk)
    want = jax_eval.evaluate_retrieval_metrics(jstate, jdata, jcfg, plan=jplan, k_values=[5, 10],
                                               topk_chunk_size=128)
    for name in ("recall", "precision", "ndcg", "hit_rate", "map"):
        for k in (5, 10):
            assert getattr(got, name)[k] == pytest.approx(getattr(want, name)[k], abs=1e-12)
    batched = dict(val_interactions=val, train_positive_map=train, num_items=NI,
                   k_values=[5, 10], user_batch_size=16)
    got_pred = port_eval.evaluate_retrieval(model, pdata, **batched)
    assert min(calls) < NI
    want_pred = jax_eval.evaluate_retrieval(jstate, jdata, jcfg, topk_chunk_size=128, **batched)
    assert got_pred == want_pred


# ---------------------------------------------------------------------------
# The sharded search on four gloo ranks, each shard past the ceiling
# ---------------------------------------------------------------------------

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
SN, SD, SB, SK, SM = 517, 16, 12, 10, 6


def test_sharded_search_past_the_ceiling_matches_jax(tmp_path):
    """1x4, float32: each shard holds 130 rows against a ceiling of 100
    items, so every shard scans its rows in chunks of 32 (the budget
    lowered to 32 columns of the batch); the merged ids
    equal the JAX chunked search over the whole corpus (ties by the lowest
    id on both sides: each shard's scan, then the merge over shard-major
    candidates). (A bf16 shard past the ceiling takes ``fused``, where
    groupmax_matmul takes the shape.)"""
    q, items = _inputs("dyadic", SN, SD, SB, seed=3)
    mask = _mask(q, items, SM)
    inputs = {"chunk/items": items, "chunk/queries": q, "chunk/mask": mask}
    tasks = [dict(kind="search", name=f"chunk_{dt}", inputs_prefix="chunk", mesh=[1, 4], k=SK,
                  masked=True, score_dtype=dt, ceiling_items=100, chunk_size=32)
             for dt in ("float32",)]
    np.savez(tmp_path / "inputs.npz", **inputs)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"inputs": str(tmp_path / "inputs.npz"), "out": str(tmp_path),
                                "tasks": tasks}))
    launch(lambda r: [sys.executable, str(WORKER), str(spec)], 4, tmp_path, 240)
    for task in tasks:
        got = dict(np.load(tmp_path / f"{task['name']}.npz"))
        assert got["chunked"].tolist() == [1, 1, 1, 1] and got["chunk_sizes"].tolist() == [32]
        want = jax_topk.mips_topk(jnp.asarray(q), jnp.asarray(items), k=SK,
                                  mask_rows=jnp.asarray(mask), algorithm="chunked",
                                  score_dtype=task["score_dtype"])
        np.testing.assert_array_equal(got["ids"], np.asarray(want[1]))
        np.testing.assert_allclose(got["scores"], np.asarray(want[0]), rtol=1e-6, atol=1e-6)


def test_trainer_searches_past_the_ceiling_by_chunks(tmp_path, monkeypatch):
    """One epoch of a tiny run with the slab ceiling below the corpus and
    the budget at 64 columns of 16 queries: the float32 searches of the run
    (the val and test evals, the sample recommendations) scan in chunks,
    the evals' narrower than the corpus. The same run sets ``model.precision:
    bfloat16`` and ``training.packed_moments: true``: it trains, writes a
    checkpoint with packed moments and a serving bundle, and exports from
    that checkpoint."""
    from ttamm_torch.data import write_synthetic_csvs
    from ttamm_torch.pipelines.export import export_bundle
    from ttamm_torch.pipelines.training import run_single_experiment

    write_synthetic_csvs(tmp_path / "data", num_users=300, num_items=200, num_interactions=4000,
                         seed=3)
    tower = {"type": "tower", "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
             "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": 16},
             "fusion": "gated"}
    config = {
        "experiment": {"name": "tiny", "seed": 3},
        "data": {"root": str(tmp_path / "data"), "min_user_interactions": 2,
                 "min_item_interactions": 2},
        "model": {"user_encoder": tower, "item_encoder": tower, "similarity": "cosine",
                  "adaptive_mimic": {"enabled": True}, "precision": "bfloat16"},
        "training": {"batch_size": 256, "num_epochs": 1, "learning_rate": 0.01,
                     "packed_moments": True,
                     "loss_weights": {"mimic_user": 0.15, "mimic_item": 0.15},
                     "checkpointing": {"enabled": True, "dir": str(tmp_path / "ckpt"),
                                       "save_best_only": False}},
        "evaluation": {"metrics_k": [5, 10], "faiss": {
            "index_path": str(tmp_path / "faiss" / "items.index"),
            "embedding_path": str(tmp_path / "faiss" / "item_embeddings.npy")}},
        "diagnostics": {"item_sample_size": 20, "user_sample_size": 50,
                        "report_path": str(tmp_path / "reports" / "report.md"),
                        "loss_plot_path": str(tmp_path / "reports" / "loss.png"),
                        "embedding_summary_path": str(tmp_path / "reports" / "summary.json")},
        "recommendations": {"sample_users": 2, "top_k": 5},
        "serving": {"score_dtype": "float32"},
        "logging": {"level": "WARNING"},
    }
    monkeypatch.setattr(topk, "SCORES_BYTES_CEILING", 64 * 4 * 10)
    monkeypatch.setattr(topk, "SCORES_BYTES_BUDGET", 4 * 16 * 64)
    calls = _spy_chunked(monkeypatch)
    result = run_single_experiment(config, device="cpu")
    assert calls and min(calls) < result.num_items
    assert result.steps > 0 and np.isfinite(result.train_loss).all()
    assert result.state.model.user_tower.cfg.compute_dtype == "bfloat16"
    assert result.state.packed_moments
    with np.load(result.checkpoint_path) as blob:
        assert "opt_sparse/user_id/mv" in blob.files and "opt_sparse/user_id/m" not in blob.files
    assert (tmp_path / "faiss" / "items.index").is_file()
    out = export_bundle(config, tmp_path / "bundle", device="cpu", checkpoint=result.checkpoint_path)
    assert out.num_items == result.num_items
