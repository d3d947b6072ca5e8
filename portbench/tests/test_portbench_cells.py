"""Runs of the harness on the CPU at tiny sizes: the result line, a cell made
of new files only, and runs whose timed path is broken underneath, which
must come out not correct."""

from __future__ import annotations

import io
import json

import numpy as np
import pytest
import torch

from portbench import harness

from .conftest import tiny_root

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checked"]


def _run(root, bench, cell, corpus_cache, *, trace=False, patch=None, seed=2**31 + 11):
    out, err = io.StringIO(), io.StringIO()
    cells = {w["name"]: w for w in bench["workloads"]}
    rc = harness.run_cell(root, bench, cells[cell], seed=seed, seconds=0.5, trace=trace,
                          device="cpu", cache=corpus_cache, out=out, err=err, patch=patch)
    assert rc == 0, err.getvalue()[-3000:]
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0]), err.getvalue().splitlines()


@pytest.mark.parametrize("cell", ["default.train", "in_batch_softmax.train", "default.search_10m_f32"])
def test_tiny_cell_is_correct_and_its_line_keeps_the_contract(tiny, corpus_cache, cell):
    root, bench = tiny
    result, err = _run(root, bench, cell, corpus_cache)
    assert list(result) == RESULT_KEYS
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    e2e = {m["name"]: m["unit"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == e2e
    assert all(v["value"] > 0 for v in result["metrics"].values())
    # the numbers compared are the last lines of standard error, each with its limit
    checked = result["checked"]
    assert err[-len(checked):] == [f"checked {k} {v['value']!r} limit {v['limit']!r}"
                                   for k, v in checked.items()]


def test_traced_run_reads_every_layer_metric_of_the_cell(tiny, corpus_cache):
    root, bench = tiny
    result, _ = _run(root, bench, "default.train", corpus_cache, trace=True)
    assert list(result) == RESULT_KEYS[:5] + ["breakdown", "checked"]
    names = {m["name"] for m in bench["per_layer"] if "default.train" in m["workloads"]}
    # on the CPU no kernel of the port runs: the kernels' readers find nothing
    assert {"train.device_ms_per_step", "train.idle_share", "train.mfu"} <= set(result["metrics"]) <= names
    assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert 0 < len(result["breakdown"]["device_ops"]) <= 10


def test_a_cell_of_new_files_only_is_found_and_run(tmp_path, corpus_cache):
    """A later change adds a configuration, a mix, a per-layer metric and
    limits as files, and entries in BENCHMARK.json; nothing else."""
    root, bench = tiny_root(tmp_path, base="pb")
    new = root / "pb_more"
    for sub in ("configs", "traffic", "layers", "checks"):
        (new / sub).mkdir(parents=True)
    cfg = json.loads((root / "pb/configs/default.json").read_text())
    cfg["config"]["model"]["item_encoder"]["feature_encoder"]["hidden_dims"] = [64]
    (new / "configs/narrow.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "pb/traffic/search_10m_f32.json").read_text())
    mix.update(items=3000, k=10)
    (new / "traffic/search_small.json").write_text(json.dumps(mix))
    (new / "layers/search.batches_traced.py").write_text(
        "def read(trace):\n    return trace.units if trace.info.get('kind') == 'search' else None\n")
    (new / "checks/narrow.search_small.json").write_text(
        (root / "pb/checks/default.search_10m_f32.json").read_text())
    bench["paths"].append("pb_more")
    bench["configs"].append({"name": "narrow", "source": "https://example.org/narrow",
                             "file": "pb_more/configs/narrow.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "narrow.search_small", "config": "narrow",
                               "traffic": "search_small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("search_"):
            m["workloads"].append("narrow.search_small")
    bench["per_layer"].append({"name": "search.batches_traced", "unit": "batches", "better": "higher",
                               "source": "device_trace", "layer": "search", "moves": "search_queries_per_s",
                               "workloads": ["narrow.search_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = _run(root, bench, "narrow.search_small", corpus_cache)
    assert result["correct"] and set(result["metrics"]) == {"search_queries_per_s", "search_p95_ms", "setup_s"}
    result, _ = _run(root, bench, "narrow.search_small", corpus_cache, trace=True)
    assert result["metrics"] == {"search.batches_traced": {"value": 3.0, "unit": "batches"}}


# -- the timed path broken underneath: correct must come out false -----------

def _unchanged(run):
    """A step that returns its state unchanged (and a loss of 0)."""
    setup = run.setup

    def patched():
        def multi(state, data, u, p, *, generator):
            return state, torch.zeros(u.shape[0])

        def single(state, data, u, p, *, generator):
            return state, {"loss": torch.zeros(())}

        import ttamm_torch.train.step as step

        make_multi, make_single = step.make_multi_train_step, step.make_train_step
        step.make_multi_train_step = lambda *a, **k: multi
        step.make_train_step = lambda *a, **k: single
        try:
            setup()
        finally:
            step.make_multi_train_step, step.make_train_step = make_multi, make_single
    run.setup = patched


def _half_batch(run):
    """Half of each batch left out, the mean taken over the rest."""
    setup = run.setup

    def patched():
        import ttamm_torch.train.step as step

        make_multi = step.make_multi_train_step

        def broken(*a, **k):
            multi = make_multi(*a, **k)
            return lambda state, data, u, p, **kw: multi(state, data, u[:, : u.shape[1] // 2],
                                                         p[:, : p.shape[1] // 2], **kw)
        step.make_multi_train_step = broken
        try:
            setup()
        finally:
            step.make_multi_train_step = make_multi
    run.setup = patched


def _altered_answer(run):
    """One id of every answer replaced where the search produces it."""
    search = run.search

    def patched(queries):
        scores, ids = search(queries)
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 1) % run.items
        return scores, ids
    run.search = patched


@pytest.mark.parametrize("cell, fault", [
    ("default.train", _unchanged), ("in_batch_softmax.train", _unchanged),
    ("default.train", _half_batch), ("in_batch_softmax.train", _half_batch),
    ("default.search_10m_f32", _altered_answer),
])
def test_broken_timed_path_is_not_correct(tiny, corpus_cache, cell, fault):
    root, bench = tiny
    result, _ = _run(root, bench, cell, corpus_cache, patch=fault)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checked"].values())


def test_reference_agrees_with_the_port_on_the_cpu(tiny, corpus_cache):
    """One training chunk and one search at tiny sizes: the port's plain
    paths and the reference sum alike, so the gaps are round-off."""
    root, bench = tiny
    train, _ = _run(root, bench, "default.train", corpus_cache)
    assert all(v["value"] < 1e-5 for v in train["checked"].values())
    search, _ = _run(root, bench, "default.search_10m_f32", corpus_cache)
    assert search["checked"]["score_err"]["value"] < 1e-6
    assert search["checked"]["rank_gap"]["value"] < 1e-6
    assert search["checked"]["bad_ids"]["value"] == 0
    assert np.isfinite([v["value"] for v in train["metrics"].values()]).all()
