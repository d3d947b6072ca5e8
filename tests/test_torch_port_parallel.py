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

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_ranks import free_port
from ttamm_torch.models import parse_model_config
from ttamm_torch.models.convert import train_state_to_flat
from ttamm_torch.ops import kernels
from ttamm_torch.parallel import MeshConfig, build_mesh, place_data, place_state
from ttamm_torch.parallel import sparse_update as port_su
from ttamm_torch.parallel.step import make_sharded_multi_train_step
from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
from ttamm_torch.train.optim import DenseOptConfig
from ttamm_tpu.ops.pallas.rows import gather_rows, scatter_set_rows
from ttamm_tpu.parallel import sparse_update as jax_su

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
