"""The masked row kernels and the pure functions of the port's multi-device
layer against the JAX package, on the CPU, and the sharded multi-step on a
one-rank mesh against the one-device step (the runs of several ranks are in
tests/test_torch_port_parallel_mesh.py).

On the CPU the masked wrappers take their plain versions; the CUDA kernels
are held bit-identical to them on the card (chip_smoke.py,
tests/test_torch_port_cuda.py). The JAX kernels run in interpret mode.

Tolerances: the row kernels move bits (exact on owned lanes for the
gather, on every row for the scatter); ``owner_capacity`` is integer
arithmetic (equal); ``_coalesce_sorted`` sums each run in lane order on
both sides (equal ids, heads and segments; totals within 1e-6). On a 1x1
mesh the sharded step sums in the one-device order but for the clip's
squared norm, so losses rtol 1e-6 and every state leaf atol 1e-6.
"""

from datetime import timedelta

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_ranks import free_port
from ttamm_torch.models import parse_model_config
from ttamm_torch.models.convert import train_state_to_flat
from ttamm_torch.ops import kernels
from ttamm_torch.ops.sparse_adam import SparseAdamState, init_sparse_adam, unfused_row_update
from ttamm_torch.parallel import MeshConfig, build_mesh, place_data, place_state
from ttamm_torch.parallel import sparse_update as port_su
from ttamm_torch.parallel.step import make_sharded_multi_train_step
from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
from ttamm_torch.train.optim import DenseOptConfig
from ttamm_tpu.ops.pallas.rows import gather_rows, scatter_set_rows
from ttamm_tpu.parallel import MODEL_AXIS as JAX_MODEL_AXIS
from ttamm_tpu.parallel import MeshConfig as JaxMeshConfig
from ttamm_tpu.parallel import build_mesh as jax_build_mesh
from ttamm_tpu.parallel import sparse_update as jax_su
from ttamm_tpu.parallel.embedding_lookup import make_sharded_lookup

BLOCK, D, ROWS = 16, 16, 96


def _lanes(layout: str, seed: int = 0) -> np.ndarray:
    """Sorted shard-local lanes of one layout, -1 where masked: 64 lanes in
    four 16-lane blocks."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.integers(0, ROWS, 64)).astype(np.int32)
    if layout == "head_and_tail":  # allgather routing: foreign lanes both sides
        live[:20], live[50:] = -1, -1
    elif layout == "tail":  # owner routing at one data shard: sentinel tail
        live[37:] = -1
    elif layout == "all_masked_block":
        live[16:32] = -1
        live[:3] = -1
    elif layout == "duplicates":  # runs of one row carry identical payloads
        live[:] = np.repeat(np.arange(0, ROWS, 6)[:16], 4)
        live[60:] = -1
    return live


LAYOUTS = ["head_and_tail", "tail", "all_masked_block", "duplicates"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_masked_gather_equals_jax_on_owned_lanes(layout):
    table = np.random.default_rng(1).standard_normal((ROWS, D)).astype(np.float32)
    idx = _lanes(layout)
    want = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx), block=BLOCK,
                                  masked=True, interpret=True))
    got = kernels.gather_rows(torch.from_numpy(table), torch.from_numpy(idx), masked=True)
    live = idx >= 0
    np.testing.assert_array_equal(got.numpy()[live], want[live])
    np.testing.assert_array_equal(got.numpy()[live], table[idx[live]])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_masked_gather_is_the_sharded_lookup(layout):
    """The masked gather at a shard's ``base`` is that shard's part of the
    JAX package's sharded lookup (``make_sharded_lookup`` on a 1x4 mesh):
    the lookup's rows on the lanes the shard owns, zeros on every other
    lane, and the four parts sum to the lookup bit for bit. The layout's
    lanes are global ids here (-1 lanes belong to no shard)."""
    shards = 4
    rows = ROWS // shards
    rng = np.random.default_rng(3)
    table = rng.standard_normal((ROWS, D)).astype(np.float32)
    idx = _lanes(layout)
    rng.shuffle(idx)  # lookups come in batch order
    mesh = jax_build_mesh(JaxMeshConfig(1, shards))
    placed = jax.device_put(jnp.asarray(table), NamedSharding(mesh, P(JAX_MODEL_AXIS, None)))
    want = np.asarray(make_sharded_lookup(mesh, num_rows=ROWS, dim=D)(placed, jnp.asarray(idx)))
    total = np.zeros_like(want)
    for s in range(shards):
        base = s * rows
        got = kernels.gather_rows(torch.from_numpy(table[base : base + rows]),
                                  torch.from_numpy(idx), masked=True, base=base).numpy()
        own = (idx >= base) & (idx < base + rows)
        np.testing.assert_array_equal(got[own], want[own])
        assert not got[~own].any()
        total += got
    np.testing.assert_array_equal(total, want)
    assert not want[idx < 0].any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_masked_scatter_equals_jax_on_every_row(layout):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((ROWS, D)).astype(np.float32)
    idx = _lanes(layout)
    rows = rng.standard_normal((idx.size, D)).astype(np.float32)
    # identical bytes on every lane of a run (what the sharded update writes)
    _, first = np.unique(idx, return_index=True)
    rows = rows[first[np.searchsorted(np.unique(idx), idx)]]
    want = np.asarray(scatter_set_rows(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(rows),
                                       block=BLOCK, masked=True, interpret=True))
    got = kernels.scatter_set_rows(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                                   torch.from_numpy(rows), masked=True)
    np.testing.assert_array_equal(got.numpy(), want)
    untouched = np.setdiff1d(np.arange(ROWS), idx)
    np.testing.assert_array_equal(got.numpy()[untouched], table[untouched])


def test_masked_kernels_count_only_on_the_card():
    kernels.reset_launch_counts()
    table = torch.zeros(8, 4)
    idx = torch.tensor([-1, 2, 3, -1], dtype=torch.int32)
    kernels.gather_rows(table, idx, masked=True)
    kernels.scatter_set_rows(table, idx, torch.ones(4, 4), masked=True)
    counts = kernels.launch_counts()
    assert counts["gather_rows_masked"] == counts["scatter_set_rows_masked"] == 0
    assert table[2].eq(1).all() and table[0].eq(0).all()


@pytest.mark.parametrize("n", [64, 96, 512, 2048, 12288])
@pytest.mark.parametrize("dp,mp", [(1, 1), (1, 4), (2, 2), (4, 1), (2, 4)])
@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_owner_capacity_equals_jax(n, dp, mp, factor):
    assert port_su.owner_capacity(n, dp, mp, factor) == jax_su.owner_capacity(n, dp, mp, factor)


@pytest.mark.parametrize("n,sentinels,head_init", [
    (16, 0, -1), (64, 0, -1), (64, 0, -2), (96, 12, -2), (96, 12, -1), (8, 8, -2),
])
def test_coalesce_sorted_equals_jax(n, sentinels, head_init):
    rng = np.random.default_rng(n + sentinels)
    idx = rng.integers(0, max(n // 4, 1), n).astype(np.int32)
    idx[rng.permutation(n)[:sentinels]] = -1
    grads = rng.standard_normal((n, D)).astype(np.float32)
    want = jax_su._coalesce_sorted(jnp.asarray(idx), jnp.asarray(grads), head_init=head_init)
    got = port_su._coalesce_sorted(
        torch.from_numpy(idx).long(), torch.from_numpy(grads), head_init=head_init
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # sorted ids
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # heads
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # segments
    # the lanes of a run (seg >= 0) carry its total
    ok = np.asarray(want[3]) >= 0
    np.testing.assert_allclose(got[1].numpy()[ok], np.asarray(want[1])[ok], rtol=0, atol=1e-6)


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
        timeout=timedelta(seconds=60),
    )
    try:
        yield build_mesh(MeshConfig(1, 1), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("routing", ["allgather", "owner"])
def test_multi_step_on_a_one_rank_mesh_equals_the_one_device_steps(one_rank_mesh, routing):
    """K sharded steps (negatives drawn inside, a dense item table, the
    global-norm clip) equal K one-device steps from one seed; at dp = 1 the
    owner routing's buffer ends in sentinel lanes."""
    nu, ni, fu, fi, dim, batch, steps = 60, 40, 6, 5, 16, 8, 3
    tower = {"type": "tower", "id_embedding": {"params": {"embedding_dim": dim, "sparse": True}},
             "feature_encoder": {"type": "mlp", "hidden_dims": [16], "output_dim": dim,
                                 "dropout": 0.0},
             "fusion": "gated"}
    item = dict(tower, id_embedding={"params": {"embedding_dim": dim, "sparse": False}})
    cfg = parse_model_config(
        {"user_encoder": tower, "item_encoder": item, "similarity": "cosine",
         "adaptive_mimic": {"enabled": True}}, user_feature_dim=fu, item_feature_dim=fi,
    )
    rng = np.random.default_rng(3)
    pos = np.full((nu, 4), ni, np.int32)
    for u in range(nu):
        k = rng.integers(1, 4)
        pos[u, :k] = rng.choice(ni, k, replace=False)
    data = BatchData(
        torch.from_numpy(rng.normal(0, 1, (nu, fu)).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 1, (ni, fi)).astype(np.float32)),
        torch.from_numpy(pos), torch.from_numpy(rng.integers(0, 8, ni).astype(np.int32)),
    )
    tscfg = TrainStepConfig(
        num_items=ni, negatives_per_positive=3, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
        lambda_category_alignment=0.01, cal_max_categories=8, gradient_clip_norm=0.1,
        update_routing=routing, opt=DenseOptConfig(name="adamw", lr=1e-3, weight_decay=0.01),
    )
    u_all = torch.from_numpy(rng.integers(0, nu, (steps, batch)).astype(np.int32))
    p_all = torch.from_numpy(pos[u_all.numpy(), 0])

    ref = create_train_state(cfg, num_users=nu, num_items=ni, seed=0, device="cpu")
    step, gen = make_train_step(cfg, tscfg), torch.Generator().manual_seed(4)
    want = [float(step(ref, data, u, p, generator=gen)[1]["loss"]) for u, p in zip(u_all, p_all)]

    mesh = one_rank_mesh
    state = place_state(mesh, create_train_state(cfg, num_users=nu, num_items=ni, seed=0,
                                                 device="cpu"))
    multi = make_sharded_multi_train_step(cfg, tscfg, mesh)
    state, losses = multi(state, place_data(mesh, data), u_all, p_all,
                          generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(losses.numpy(), want, rtol=1e-6)
    got, ref_flat = train_state_to_flat(state), train_state_to_flat(ref)
    assert set(got) == set(ref_flat)
    for key, value in ref_flat.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6, err_msg=key)


def _parent_update(table, m, v, lanes, grads, *, base, hyper):
    """The sharded update's row composition before it moved onto
    ``sparse_adam_rows``: every lane of a run carrying the run's total, no
    head masking, the masked plain gathers and scatters around
    ``adam_rows`` (duplicate lanes write identical bytes)."""
    sorted_idx, totals, _, _ = port_su._coalesce_sorted(lanes, grads, head_init=-2)
    unfused_row_update(
        table, m, v, port_su._localize(sorted_idx, base, table.shape[0]), totals,
        gather=functools.partial(kernels.gather_rows_plain, masked=True),
        scatter=functools.partial(kernels.scatter_set_rows_plain, masked=True), **hyper,
    )


def _update_case(seed, rows=60, n=96, dim=D):
    """Table, m, v and one step's lanes: a third of them on three rows,
    every shard owning some, and padding lanes (-1)."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((rows, dim)).astype(np.float32))
    m = torch.from_numpy((0.1 * rng.standard_normal((rows, dim))).astype(np.float32))
    v = torch.from_numpy((0.01 * rng.random((rows, dim))).astype(np.float32))
    idx = rng.integers(0, rows, n)
    idx[: n // 3] = rng.choice([3, 17, 41], n // 3)
    idx[-5:] = -1
    grads = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    return table, m, v, torch.from_numpy(idx), grads


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("step", [1, 1000])
def test_allgather_update_keeps_the_parent_composition_bits(one_rank_mesh, step, weight_decay):
    """The allgather routing's update equals the composition it replaced,
    bit for bit over every row of table, m and v: on the 1x1 mesh through
    ``sharded_sparse_adam_update``, and on each of 4 row shards (foreign
    lanes at the head and the tail) through its shard-local body."""
    table, m, v, idx, grads = _update_case(step)
    hyper = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)
    want = [t.clone() for t in (table, m, v)]
    _parent_update(*want, idx, grads, base=0, hyper=dict(hyper, step=step))
    state = SparseAdamState(m=m.clone(), v=v.clone(), step=step - 1)
    got = table.clone()
    port_su.sharded_sparse_adam_update(one_rank_mesh, got, state, idx, grads, **hyper)
    for a, b in zip((got, state.m, state.v), want):
        assert torch.equal(a, b)
    shards, rows = 4, table.shape[0] // 4
    lanes = port_su.sort_lanes(idx, grads, head_init=-2)
    for s in range(shards):
        part = slice(s * rows, (s + 1) * rows)
        local = [t[part].clone() for t in (table, m, v)]
        parent = [t[part].clone() for t in (table, m, v)]
        port_su._apply(local[0], SparseAdamState(m=local[1], v=local[2], step=step - 1),
                       port_su._localize(lanes.idx, s * rows, rows, lanes.is_head),
                       lanes.totals(),
                       scalars=torch.from_numpy(kernels.adam_scalars(step=step, **hyper)),
                       decay=bool(weight_decay))
        _parent_update(*parent, idx, grads, base=s * rows, hyper=dict(hyper, step=step))
        for a, b in zip(local, parent):
            assert torch.equal(a, b)


def _clip_step_case(routing, clip):
    """A two-sparse-table model and one batch for the sharded step."""
    nu, ni, dim, batch = 40, 30, 8, 6
    tower = {"type": "tower", "id_embedding": {"params": {"embedding_dim": dim, "sparse": True}},
             "feature_encoder": {"type": "mlp", "hidden_dims": [8], "output_dim": dim,
                                 "dropout": 0.0},
             "fusion": "gated"}
    cfg = parse_model_config({"user_encoder": tower, "item_encoder": tower},
                             user_feature_dim=3, item_feature_dim=2)
    rng = np.random.default_rng(9)
    data = BatchData(
        torch.from_numpy(rng.normal(0, 1, (nu, 3)).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 1, (ni, 2)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, ni, (nu, 3)).astype(np.int32)), None,
    )
    tscfg = TrainStepConfig(num_items=ni, negatives_per_positive=3, gradient_clip_norm=clip,
                            update_routing=routing,
                            opt=DenseOptConfig(name="adamw", lr=1e-2, weight_decay=0.01))
    u = torch.from_numpy(rng.integers(0, nu, batch).astype(np.int32))
    p = torch.from_numpy(rng.integers(0, ni, batch).astype(np.int32))
    neg = torch.from_numpy(rng.integers(0, ni, (batch, 3)).astype(np.int32))
    state = create_train_state(cfg, num_users=nu, num_items=ni, seed=2, device="cpu")
    return cfg, tscfg, data, state, u, p, neg


@pytest.mark.parametrize("clip", [None, 0.05])
def test_clip_and_update_gather_and_sort_a_table_once(one_rank_mesh, monkeypatch, clip):
    """Under the allgather routing each sparse table's lanes are
    all-gathered (ids and gradients) and sorted once a step, whether or not
    the clip runs; each sparse table is updated by one ``sparse_adam_rows``
    call, and each table (the sparse ID and the dense mimic ones) read by
    one masked ``gather_rows``."""
    calls = {"sort": 0, "gather": 0, "update": 0, "read": 0}

    def counted(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(port_su, "sort_lanes", counted("sort", port_su.sort_lanes))
    monkeypatch.setattr(port_su, "all_gather_rows", counted("gather", port_su.all_gather_rows))
    monkeypatch.setattr(kernels, "sparse_adam_rows", counted("update", kernels.sparse_adam_rows))
    real_gather = kernels.gather_rows

    def read(table, idx, *, masked=False, base=0):
        calls["read"] += masked
        return real_gather(table, idx, masked=masked, base=base)

    monkeypatch.setattr(kernels, "gather_rows", read)
    cfg, tscfg, data, state, u, p, neg = _clip_step_case("allgather", clip)
    mesh = one_rank_mesh
    step = make_train_step(cfg, tscfg, mesh=mesh)
    assert sorted(state.tables) == ["item_aug", "item_id", "user_aug", "user_id"]
    step(place_state(mesh, state), place_data(mesh, data), u, p, generator=None, negatives=neg)
    assert calls == {"sort": 2, "gather": 4, "update": 2, "read": 4}


def test_shared_gather_keeps_the_clip_and_update_bits(one_rank_mesh):
    """The clip's squared norm from the shared gathered lanes equals the
    parent's (its own gather, ``_coalesce_sorted``, the heads' totals
    squared and summed) bit for bit, and the update from those lanes
    scaled equals the update that gathers and sorts the scaled lanes
    itself, in the one-device lane order."""
    from ttamm_torch.train.step import _Lanes, _Mesh

    mesh = one_rank_mesh
    table, m, v, idx, grads = _update_case(5)
    order = torch.from_numpy(np.random.default_rng(1).permutation(idx.numel()))
    tscfg = TrainStepConfig(num_items=table.shape[0] - 1)
    layout = _Mesh(mesh, tscfg)
    lanes, sq = layout.sparse_sq(table, _Lanes(idx.to(torch.int32), grads, order))
    _, totals, heads, _ = port_su._coalesce_sorted(idx[order], grads[order], head_init=-2)
    assert torch.equal(sq, torch.sum(torch.square(torch.where(heads[:, None], totals, 0.0))))
    scale = torch.tensor(0.37)
    lanes = lanes.scaled(scale)
    got, want = [table.clone(), init_sparse_adam(table)], [table.clone(), init_sparse_adam(table)]
    port_su.sharded_sparse_adam_update(mesh, got[0], got[1], lanes.idx, lanes.grad, lr=1e-2,
                                       gather_order=order, gathered=lanes.gathered)
    port_su.sharded_sparse_adam_update(mesh, want[0], want[1], lanes.idx, lanes.grad, lr=1e-2,
                                       gather_order=order)
    for a, b in ((got[0], want[0]), (got[1].m, want[1].m), (got[1].v, want[1].v)):
        assert torch.equal(a, b)


def test_owner_buffer_at_one_data_shard_holds_sorted_rows_then_sentinels(one_rank_mesh, monkeypatch):
    """At dp = 1 the owner routing hands ``sparse_adam_rows`` its compacted
    buffer as it is: each owned row once, ascending, then -1 lanes."""
    seen = []
    fused = kernels.sparse_adam_rows

    def spy(table, m, v, idx, grads, **hyper):
        seen.append(idx.clone())
        fused(table, m, v, idx, grads, **hyper)

    monkeypatch.setattr(kernels, "sparse_adam_rows", spy)
    table, m, v, idx, grads = _update_case(7)
    state = SparseAdamState(m=m, v=v)
    port_su.sharded_sparse_adam_update(one_rank_mesh, table, state, idx, grads, lr=1e-2,
                                       routing="owner")
    (lanes,) = seen
    live = int((lanes >= 0).sum())
    want = torch.unique(idx[idx >= 0]).to(torch.int32)
    assert torch.equal(lanes[:live], want)
    assert live < lanes.numel() and (lanes[live:] == -1).all()
