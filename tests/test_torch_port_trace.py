"""The port's spans (``ttamm_torch/utils/trace.py``) on the CPU.

- With no profiler recording a span is a shared no-op: no
  ``record_function``, no record; under a profiler's warm-up step likewise.
- Under ``torch.profiler.profile`` a ``FlatIndex.search`` is one root
  ``ttamm.search`` over ``prepare``, ``upload``, ``topk.<route>`` and
  ``readback``, all with the root's id; the route names the path
  ``mips_topk`` took, its fallbacks included, and ``chunked`` counts its
  chunks. Self time is the duration less the children's.
- Each record's start lies within 1 ms of the profiler's own
  ``ttamm.*`` event (one clock).
- Two threads searching at once keep their trees apart.
- The train and eval-loss calls give their spans; the cap counts what it
  drops; with no caller collecting, a profiled span keeps no record.
- ``chip_smoke.py``'s device sums leave out the ranges that kineto copies
  onto the card's timeline (a span's, ``ProfilerStep*``).
- On a card (marked ``cuda``): a replayed call's ``step.replay`` counts its
  replays, and a second call with the same key captures nothing.
"""

import importlib.util
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from ttamm_torch.models import parse_model_config
from ttamm_torch.ops import topk
from ttamm_torch.serve.flat_index import FlatIndex
from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
from ttamm_torch.train.optim import DenseOptConfig
from ttamm_torch.train.step import make_multi_eval_loss_step, make_multi_train_step
from ttamm_torch.utils import trace

N, D, B, K = 1000, 16, 8, 5
SEARCH_CHILDREN = ["ttamm.search.prepare", "ttamm.search.upload", None, "ttamm.search.readback"]


@pytest.fixture(autouse=True)
def _collect():
    trace.collect()
    yield
    trace.clear()


def _index(dim=D, dtype="float32", n=N):
    rows = np.random.default_rng(3).normal(size=(n, dim)).astype(np.float32)
    return FlatIndex(embeddings=rows, normalized=True, score_dtype=dtype, device="cpu")


def _queries(dim=D, b=B, seed=5):
    return np.random.default_rng(seed).normal(size=(b, dim)).astype(np.float32)


def _trees(recs):
    """Records by root id: (root, [children in start order])."""
    roots = {r.id: r for r in recs if r.parent_id is None}
    kids = {i: [] for i in roots}
    for r in recs:
        if r.parent_id is not None:
            kids[r.root_id].append(r)
    return {i: (roots[i], sorted(kids[i], key=lambda r: r.start_ns)) for i in roots}


def test_no_profiler_means_no_records_and_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("search") is trace.span("train.multi")  # the shared no-op
    with trace.span("search") as off:
        off.n = 7  # ignored
    _index().search(_queries(), K)
    cfg, tscfg, state, data, users, items = _train_setup()
    make_multi_train_step(cfg, tscfg)(state, data, users, items, generator=torch.Generator())
    assert trace.records() == [] and trace.dropped() == 0


def test_warm_up_step_records_nothing_and_the_active_step_one_search():
    index, q = _index(), _queries()
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        index.search(q, K)
        assert trace.records() == []
        prof.step()
        index.search(q, K)
        prof.step()
    roots = [r for r in trace.records() if r.parent_id is None]
    assert [(r.name, r.n) for r in roots] == [("ttamm.search", B)]


@pytest.mark.parametrize("algorithm, dim, dtype, route", [
    ("group_exact", D, "float32", "group_exact"),
    ("auto", D, "float32", "group_exact"),
    ("chunked", D, "float32", "chunked"),
    ("fused", D, "bfloat16", "fused"),
    ("fused", 648, "bfloat16", "group_exact"),  # past the fused kernels' width: rerouted
])
def test_search_is_one_tree_named_by_the_route_taken(monkeypatch, algorithm, dim, dtype, route):
    chunk = 128
    # chunk_items(B) = budget / (4 B): chunks of 128 items, 8 of them over 1,000
    monkeypatch.setattr(topk, "SCORES_BYTES_BUDGET", 4 * B * chunk)
    index, q = _index(dim, dtype), _queries(dim)
    with profile(activities=[ProfilerActivity.CPU]):
        want = index.search(q, K, algorithm=algorithm)
    got = index.search(q, K, algorithm=algorithm)  # the same answer with no profiler
    np.testing.assert_array_equal(got[1], want[1])
    trees = _trees(trace.records())
    assert len(trees) == 1
    (root, kids), = trees.values()
    assert (root.name, root.n, root.root_id) == ("ttamm.search", B, root.id)
    names = [k.name for k in kids]
    assert names == [n or f"ttamm.topk.{route}" for n in SEARCH_CHILDREN]
    assert all(k.parent_id == root.id and k.root_id == root.id for k in kids)
    assert all(root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns for k in kids)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))  # one after another
    (topk_span,) = [k for k in kids if k.name.startswith("ttamm.topk.")]
    assert topk_span.n == (-(-N // chunk) if route == "chunked" else 1)


def test_self_time_is_the_duration_less_the_childrens():
    with profile(activities=[ProfilerActivity.CPU]):
        _index().search(_queries(), K)
    recs = trace.records()
    own = {r.id: r.ns for r in recs}
    for r in recs:
        if r.parent_id is not None:
            own[r.parent_id] -= r.ns
    (root, kids), = _trees(recs).values()
    assert own[root.id] == root.ns - sum(k.ns for k in kids) >= 0
    assert all(own[k.id] == k.ns > 0 for k in kids)  # leaves


def test_records_share_the_profilers_clock():
    index, q = _index(), _queries()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            index.search(q, K)
    events = {}
    for e in prof.profiler.kineto_results.events():
        # the host's ranges (with CUDA activity each also has a device-side copy)
        if e.name().startswith("ttamm.") and e.device_type() == DeviceType.CPU:
            events.setdefault(e.name(), []).append(e.start_ns())
    recs = {}
    for r in trace.records():
        recs.setdefault(r.name, []).append(r.start_ns)
    assert set(recs) == set(events) and len(recs) == 5
    for name, starts in recs.items():
        assert len(starts) == len(events[name]) == 3
        for ours, theirs in zip(sorted(starts), sorted(events[name])):
            assert abs(ours - theirs) < 1_000_000, (name, ours - theirs)


def test_two_threads_keep_their_trees_apart(monkeypatch):
    """The profiler records the thread that started it; the guard is
    forced on here so that both threads record at once."""
    monkeypatch.setattr(trace, "_recording", lambda: True)
    index, per_thread = _index(), 40
    barrier = threading.Barrier(2)
    errors = []

    def client(seed):
        try:
            barrier.wait(timeout=30)
            for i in range(per_thread):
                index.search(_queries(b=1 + (seed + i) % 4, seed=seed), K)
        except Exception as exc:  # noqa: BLE001 - reported by the main thread
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(s,)) for s in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    trees = _trees(trace.records())
    assert len(trees) == 2 * per_thread
    for root, kids in trees.values():
        assert [k.name for k in kids] == [n or "ttamm.topk.group_exact" for n in SEARCH_CHILDREN]
        assert all(k.parent_id == root.id for k in kids)
        assert all(root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns for k in kids)
    roots = sorted((r for r, _ in trees.values()), key=lambda r: r.start_ns)
    assert any(a.end_ns > b.start_ns for a, b in zip(roots, roots[1:]))  # the threads overlapped


def _train_setup(device="cpu", steps=3, in_batch=False):
    """A small seeded gated-tower model with sparse tables and sparse
    mimic, its data and ``steps`` batches."""
    tower = {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [24], "output_dim": 16},
        "fusion": "gated",
    }
    model = {"user_encoder": tower, "item_encoder": tower,
             "adaptive_mimic": {"enabled": True, "sparse": True}}
    cfg = parse_model_config(model, user_feature_dim=6, item_feature_dim=5)
    gen = torch.Generator().manual_seed(1)
    nu, ni, b = 60, 50, 16
    data = BatchData(
        user_features=torch.randn((nu, 6), generator=gen).to(device),
        item_features=torch.randn((ni, 5), generator=gen).to(device),
        positive_rows=torch.randint(0, ni, (nu, 4), generator=gen, dtype=torch.int32).to(device),
        category_ids=torch.randint(0, 8, (ni,), generator=gen, dtype=torch.int32).to(device),
    )
    tscfg = TrainStepConfig(num_items=ni, lambda_mimic_user=0.1, lambda_mimic_item=0.1,
                            lambda_category_alignment=0.01, cal_max_categories=8,
                            opt=DenseOptConfig(name="adamw", lr=1e-3, weight_decay=0.01))
    if in_batch:
        tscfg = tscfg._replace(loss_type="in_batch_softmax")
    state = create_train_state(cfg, num_users=nu, num_items=ni, seed=2, device=device)
    users = torch.randint(0, nu, (steps, b), generator=gen, dtype=torch.int32).to(device)
    items = torch.randint(0, ni, (steps, b), generator=gen, dtype=torch.int32).to(device)
    return cfg, tscfg, state, data, users, items


@pytest.mark.parametrize("call, root, children", [
    ("multi", "ttamm.train.multi", ["ttamm.step.scalars", "ttamm.step.stage"]),
    ("single", "ttamm.train.step", []),
    ("eval_loss", "ttamm.eval_loss.multi", ["ttamm.step.stage"]),
])
def test_train_calls_give_their_spans(call, root, children):
    cfg, tscfg, state, data, users, items = _train_setup()
    gen = torch.Generator().manual_seed(4)
    with profile(activities=[ProfilerActivity.CPU]):
        if call == "multi":
            make_multi_train_step(cfg, tscfg)(state, data, users, items, generator=gen)
        elif call == "single":
            make_train_step(cfg, tscfg)(state, data, users[0], items[0], generator=gen)
        else:
            make_multi_eval_loss_step(cfg, tscfg)(state, data, users, items, generator=gen)
    (top, kids), = _trees(trace.records()).values()
    assert (top.name, top.n) == (root, 1 if call == "single" else len(users))
    assert [k.name for k in kids] == children  # no replay and no capture on the CPU
    assert all(k.parent_id == top.id for k in kids)


def test_the_cap_counts_what_it_drops():
    trace.collect(cap=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with trace.span(f"t{i}", n=i):
                pass
    assert [(r.name, r.n) for r in trace.records()] == [("ttamm.t0", 0), ("ttamm.t1", 1), ("ttamm.t2", 2)]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_with_no_caller_collecting_a_profiled_span_keeps_no_record():
    trace.clear()
    index, q = _index(), _queries()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.search(q, K)
        with trace.span("t", n=3) as late:
            late.n = 4
    assert trace.records() == [] and trace.dropped() == 0
    names = {e.name() for e in prof.profiler.kineto_results.events() if e.name().startswith("ttamm.")}
    assert {"ttamm.search", "ttamm.search.readback", "ttamm.t"} <= names  # on the timeline still
    trace.collect()
    with profile(activities=[ProfilerActivity.CPU]):
        index.search(q, K)
    assert [r.name for r in trace.records() if r.parent_id is None] == ["ttamm.search"]


def test_chip_smoke_counts_no_spans_range_as_device_work():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cuda = DeviceType.CUDA

    def evt(key, device, time, count, annotation=None):
        e = SimpleNamespace(key=key, device_type=device, self_device_time_total=time, count=count)
        if annotation is not None:  # a torch without the attribute: by name alone
            e.is_user_annotation = annotation
        return e

    # four steps under CPU and CUDA activity: a kernel, the aten op whose
    # device time repeats it, and three annotated ranges on the card
    events = [evt("gemm_kernel", cuda, 100.0, 4, False), evt("aten::mm", DeviceType.CPU, 100.0, 4, False),
              evt("ttamm.train.step", cuda, 5000.0, 4, True), evt("ProfilerStep*", cuda, 6000.0, 1, True),
              evt("ttamm.search", cuda, 700.0, 4), evt("user_range", cuda, 900.0, 4, True)]
    assert [e.key for e in events if smoke._on_card(e)] == ["gemm_kernel"]
    assert smoke._device_us(events) == 100.0 and smoke._per_call_us(events, 4) == 25.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _index().search(_queries(), K)
    averages = prof.key_averages()
    assert any(e.key == "ttamm.search" for e in averages)
    assert not any(smoke._on_card(e) for e in averages)  # host work alone on the CPU


@pytest.mark.cuda
def test_replayed_calls_count_their_replays_and_capture_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    cfg, tscfg, state, data, users, items = _train_setup(cuda, steps=4, in_batch=True)
    multi = make_multi_train_step(cfg, tscfg)
    gen = torch.Generator(device=cuda).manual_seed(4)
    multi(state, data, users, items, generator=gen)  # captures outside the profiler
    trace.collect()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        multi(state, data, users, items, generator=gen)
        torch.cuda.synchronize()
    (top, kids), = _trees(trace.records()).values()
    assert (top.name, top.n) == ("ttamm.train.multi", len(users))
    names = [k.name for k in kids]
    assert "ttamm.step.capture" not in names
    (replay,) = [k for k in kids if k.name == "ttamm.step.replay"]
    assert replay.n == len(users)
    # a new state: the first call captures, its eager first step is not a replay
    cfg, tscfg, state, data, users, items = _train_setup(cuda, steps=4, in_batch=True)
    trace.collect()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        make_multi_train_step(cfg, tscfg)(state, data, users, items, generator=gen)
        torch.cuda.synchronize()
    (top, kids), = _trees(trace.records()).values()
    names = [k.name for k in kids]
    assert names.count("ttamm.step.capture") == 1
    (replay,) = [k for k in kids if k.name == "ttamm.step.replay"]
    assert replay.n == len(users) - 1
