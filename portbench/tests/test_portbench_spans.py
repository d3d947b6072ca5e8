"""The per-layer metrics read from the port's own spans, on tiny CPU cells
with ``--trace 1``: each is reported where it applies, the records hold
the traced part's body alone, and a port without the span module (an
older checkout) leaves the metrics out of a line that is still printed."""

from __future__ import annotations

import sys

import pytest

from .test_portbench_cells import _run

SPAN_METRICS = {"search.host_ms_per_batch", "train.host_ms_per_call", "train.replay_ms_per_step"}


@pytest.fixture(autouse=True)
def _empty_records():
    from ttamm_torch.utils import trace

    trace.clear()
    yield
    trace.clear()


@pytest.mark.parametrize("cell", ["default.search_10m_f32", "in_batch_softmax.search_2m_bf16"])
def test_search_cells_report_the_host_ms_of_a_search(tiny, corpus_cache, cell):
    from ttamm_torch.utils import trace

    root, bench = tiny
    result, _ = _run(root, bench, cell, corpus_cache, trace=True)
    assert result["metrics"]["search.host_ms_per_batch"]["value"] > 0
    assert not (SPAN_METRICS - {"search.host_ms_per_batch"}) & set(result["metrics"])
    # the traced part's 3 searches alone: not the warm search under the
    # profiler's warm-up, not set-up's or the window's
    searches = [r for r in trace.records() if r.name == "ttamm.search"]
    assert len(searches) == 3 and all(r.parent_id is None and r.n == 32 for r in searches)


@pytest.mark.parametrize("cell", ["default.train", "in_batch_softmax.train"])
def test_train_cells_report_the_host_ms_of_a_call_and_no_replays_on_the_cpu(tiny, corpus_cache, cell):
    from ttamm_torch.utils import trace

    root, bench = tiny
    result, _ = _run(root, bench, cell, corpus_cache, trace=True)
    assert result["metrics"]["train.host_ms_per_call"]["value"] > 0
    assert "train.replay_ms_per_step" not in result["metrics"]
    assert "search.host_ms_per_batch" not in result["metrics"]
    roots = {r.name for r in trace.records() if r.parent_id is None}
    assert roots <= {"ttamm.train.multi", "ttamm.train.step"} and "ttamm.train.multi" in roots


@pytest.mark.parametrize("cell", ["default.train", "in_batch_softmax.search_2m_bf16"])
def test_a_port_without_spans_gives_its_line_without_their_metrics(tiny, corpus_cache, monkeypatch, cell):
    import ttamm_torch.utils

    monkeypatch.delattr(ttamm_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "ttamm_torch.utils.trace", None)  # import raises ImportError
    root, bench = tiny
    result, _ = _run(root, bench, cell, corpus_cache, trace=True)
    assert result["metrics"] and not SPAN_METRICS & set(result["metrics"])
    assert result["device"]["busy_s"] > 0
