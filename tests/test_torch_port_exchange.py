"""The mesh's wire options on a CPU mesh of four gloo ranks: the all-to-all
embedding exchange (``mesh.embedding_exchange: alltoall``,
``ttamm_torch/parallel/exchange.py``), the bf16 gradient wire
(``training.comm_dtype``) through the sharded sparse update, and bf16
feature rows through the sharded lookup; against the JAX package (its
virtual 8-device CPU mesh, Pallas kernels in interpret mode) and against
the port's own default path.

The ranks (tests/torch_parallel_worker.py) start once for the module. The
scenarios and their tolerances:

- ``route_by_owner`` equal to JAX's plan (no mesh needed);
- the exchange's rows, both variants, at 2x2 and 1x4, random ids with
  duplicates and every id on one shard: equal to ``index_select`` of the
  whole table bit for bit; the table gradient of its backward against
  ``np.add.at`` in float64 at atol 1e-5 and, at one id set a mesh, against
  JAX ``make_exchange_lookup``'s at atol 1e-6 (float32 sums in another
  order);
- the sharded step with ``embedding_exchange: alltoall`` equal bit for bit
  to the default (masked-gather) step from the same state and batches:
  2x2 BCE with dense mimic tables (the exchange's backward) under the bf16
  wire, the owner routing and the clip; 1x4 in-batch softmax with sparse
  mimic tables, float32;
- the sharded sparse update fed identical bf16 lanes against JAX
  ``sharded_sparse_adam_update`` fed the same, at 2x2 and 1x4: allgather
  (and at 2x2 the owner overflow fallback, which re-exchanges the unsummed
  bf16 lanes) atol 1e-6,
  owner atol 1e-5 (its two-phase sums), the owner buffer's totals rounded
  to bf16 once more on both sides;
- the dtype of every floating tensor all-gathered over ``data``
  (``record_collectives``): the dense mimic tables' lane gradients in
  their backward, then the sparse update's, bf16 under ``comm_dtype:
  bfloat16``, float32 otherwise, and with the clip one float32 gather a
  sparse table for the norm between them (as the JAX package's
  partitioner moves the float32 lanes for it);
- bf16 feature rows through ``sharded_rows`` (a bf16 sum over ``model``)
  equal to ``index_select``, bit for bit but an owner's -0.0, which the
  sum returns as +0.0;
- with dropout on and the trainer's dropout streams (one a data shard),
  every rank's dense parameters equal bit for bit after two steps.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_parallel_mesh import (
    CLIP, IB_MODEL, IB_TSCFG, MODEL, OPT, TOWER, TSCFG, _in_batch_setup, _step_setup,
    _update_inputs,
)
from torch_ranks import launch
from ttamm_torch.parallel.exchange import route_by_owner
from ttamm_tpu.ops.sparse_adam import SparseAdamState
from ttamm_tpu.parallel import MeshConfig, build_mesh
from ttamm_tpu.parallel.exchange import make_exchange_lookup as jax_exchange_lookup
from ttamm_tpu.parallel.exchange import route_by_owner as jax_route_by_owner
from ttamm_tpu.parallel.sparse_update import sharded_sparse_adam_update
from ttamm_tpu.train import checkpoint as jax_ckpt

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD, WALL_SECONDS = 4, 240
R, LR = 96, 1e-2
BF16_UPDATES = {  # name: (mesh, routing, capacity factor, id range, skew)
    "bf16_ag_2x2": ((2, 2), "allgather", 2.0, R, False),
    "bf16_owner_2x2": ((2, 2), "owner", 2.0, R, False),
    "bf16_overflow_2x2": ((2, 2), "owner", 0.3, R, True),
    "bf16_ag_1x4": ((1, 4), "allgather", 2.0, R, False),
    "bf16_owner_1x4": ((1, 4), "owner", 2.0, R, False),
}
EX_ROWS, EX_D, EX_B = 64, 8, 32
EX_LOOKUPS = {"2x2_random": (2, 2), "2x2_one_shard": (2, 2), "1x4_random": (1, 4),
              "1x4_one_shard": (1, 4)}
EX_JAX_GRADS = ("2x2_random", "1x4_one_shard")  # the JAX gradient's compile costs ~11 s a mesh
SPIES = {  # name: (comm dtype, routing, clip)
    "spy_f32": ("float32", "allgather", None),
    "spy_bf16_allgather_clip": ("bfloat16", "allgather", 0.5),
    "spy_bf16_owner": ("bfloat16", "owner", None),
}
STEPS = 2
DROPOUT_TOWER = dict(TOWER, feature_encoder=dict(TOWER["feature_encoder"], dropout=0.15))
DROPOUT_MODEL = dict(MODEL, user_encoder=DROPOUT_TOWER, item_encoder=DROPOUT_TOWER)
EX_STEPS = {  # name: (mesh, in-batch?, tscfg changes)
    "bce_2x2_bf16_owner_clip": ([2, 2], False, dict(comm_dtype="bfloat16", update_routing="owner",
                                                     gradient_clip_norm=CLIP["owner"])),
    "in_batch_1x4": ([1, 4], True, {}),
}


def _ex_ids(name):
    rng = np.random.default_rng(len(name))
    if name.endswith("one_shard"):
        return np.full(EX_B, EX_ROWS - 3, np.int32)
    ids = rng.integers(0, EX_ROWS, EX_B).astype(np.int32)
    ids[3] = ids[11] = ids[20]  # duplicates, across data shards at dp = 2
    return ids


def _jax_bf16_update(mesh_shape, routing, factor, x):
    mesh = build_mesh(MeshConfig(*mesh_shape))
    st = SparseAdamState(m=jnp.asarray(x["m"]), v=jnp.asarray(x["v"]), step=jnp.asarray(2, jnp.int32))
    fn = jax.jit(lambda t, s, i, g: sharded_sparse_adam_update(
        mesh, t, s, i, g, lr=LR, routing=routing, capacity_factor=factor, interpret=True))
    grads = jnp.asarray(x["grads"]).astype(jnp.bfloat16)
    table, state = fn(jnp.asarray(x["table"]), st, jnp.asarray(x["idx"]), grads)
    return {"table": np.asarray(table), "m": np.asarray(state.m), "v": np.asarray(state.v)}


def _jax_exchange_grad(mesh_shape, table, ids, cot):
    lookup = jax_exchange_lookup(build_mesh(MeshConfig(*mesh_shape)), EX_ROWS, variant="dense")
    grad = jax.grad(lambda t: jnp.vdot(lookup(t, jnp.asarray(ids)), jnp.asarray(cot)))
    return np.asarray(grad(jnp.asarray(table)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_exchange")
    inputs, tasks, refs = {}, [], {}
    for name, (mesh, routing, factor, id_range, skew) in BF16_UPDATES.items():
        x = _update_inputs(name, id_range, skew)
        x["grads"] = np.asarray(jnp.asarray(x["grads"], jnp.bfloat16).astype(jnp.float32))
        inputs.update({f"{name}/{k}": a for k, a in x.items()})
        refs[name] = _jax_bf16_update(mesh, routing, factor, x)
        tasks.append(dict(kind="sparse_update", name=name, mesh=mesh, routing=routing,
                          capacity_factor=factor, step=2, lr=LR, wire="bfloat16"))

    rng = np.random.default_rng(12)
    table = rng.standard_normal((EX_ROWS, EX_D)).astype(np.float32)
    cot = rng.standard_normal((EX_B, EX_D)).astype(np.float32)
    inputs.update({"exchange/table": table, "exchange/cot": cot})
    for name, mesh in EX_LOOKUPS.items():
        ids = _ex_ids(name)
        inputs[f"exchange/ids_{name}"] = ids
        if name in EX_JAX_GRADS:
            refs[name] = _jax_exchange_grad(mesh, table, ids, cot)
        tasks.append(dict(kind="exchange_lookup", name=name, mesh=list(mesh),
                          ids=f"exchange/ids_{name}"))

    _, jstate, _, (feats, pos, cats), batches = _step_setup()
    inputs.update({f"state/{k}": a for k, a in jax_ckpt.state_to_host(jstate).items()})
    inputs.update({"data/user_features": feats[0], "data/item_features": feats[1],
                   "data/positive_rows": pos, "data/category_ids": cats,
                   "exchange/ids": _ex_ids("features")})
    for mesh in ([2, 2], [1, 4]):
        tasks.append(dict(kind="feature_rows", name=f"features_{mesh[0]}x{mesh[1]}", mesh=mesh))
    for s, (u, p, neg, _) in enumerate(batches):
        inputs.update({f"bce/u{s}": u, f"bce/p{s}": p, f"bce/neg{s}": neg})
    model_task = dict(model=MODEL, feature_dims=[feats[0].shape[1], feats[1].shape[1]],
                      num_users=feats[0].shape[0], num_items=feats[1].shape[0], state="state",
                      kind="train_step", opt=OPT, inputs_prefix="bce")
    for name, (comm, routing, clip) in SPIES.items():
        tasks.append(dict(model_task, name=name, mesh=[2, 2], steps=1, spy=True, tscfg=dict(
            TSCFG, comm_dtype=comm, update_routing=routing, gradient_clip_norm=clip)))

    tasks.append(dict(model_task, name="dropout_2x2", mesh=[2, 2], steps=STEPS, dropout=True,
                      model=DROPOUT_MODEL, tscfg=TSCFG))

    ib_flat, log_q, ib_batches = _in_batch_setup()
    inputs.update({f"ib_state/{k}": a for k, a in ib_flat.items()})
    inputs["data/item_log_q"] = log_q
    for s, (u, p, pool) in enumerate(ib_batches):
        inputs.update({f"in_batch/u{s}": u, f"in_batch/p{s}": p, f"in_batch/neg{s}": pool})
    for name, (mesh, in_batch, changes) in EX_STEPS.items():
        for exchange in ("gspmd", "alltoall"):
            task = dict(model_task, name=f"{name}_{exchange}", mesh=mesh, steps=STEPS,
                        tscfg=dict(TSCFG, embedding_exchange=exchange, **changes))
            if in_batch:
                task.update(model=IB_MODEL, state="ib_state", inputs_prefix="in_batch", log_q=True,
                            tscfg=dict(IB_TSCFG, embedding_exchange=exchange, **changes))
            tasks.append(task)

    np.savez(work / "inputs.npz", **inputs)
    spec = work / "spec.json"
    spec.write_text(json.dumps({"inputs": str(work / "inputs.npz"), "out": str(work),
                                "tasks": tasks}))
    launch(lambda r: [sys.executable, str(WORKER), str(spec)], WORLD, work, WALL_SECONDS)
    outs = {t["name"]: dict(np.load(work / f"{t['name']}.npz")) for t in tasks}
    return dict(refs=refs, outs=outs, table=table, cot=cot)


@pytest.mark.parametrize("ids", [
    np.array([13, 2, 13, 63, 0, 7], np.int32),
    np.full(9, 40, np.int32),
    np.array([-1, 70, 5, 30, 31, 32], np.int32),  # out of range: clipped owners
])
def test_route_by_owner_matches_jax(ids):
    want = jax_route_by_owner(jnp.asarray(ids), rows_per_shard=8, num_shards=8, capacity=ids.size)
    got = route_by_owner(torch.from_numpy(ids), rows_per_shard=8, num_shards=8, capacity=ids.size)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)


@pytest.mark.parametrize("name", sorted(EX_LOOKUPS))
def test_exchange_rows_equal_index_select(ranks, name):
    got, want = ranks["outs"][name], ranks["table"][_ex_ids(name)]
    for variant in ("dense", "ragged"):
        np.testing.assert_array_equal(got[variant], want, err_msg=variant)


@pytest.mark.parametrize("name", sorted(EX_LOOKUPS))
def test_exchange_gradient_matches_jax(ranks, name):
    got = ranks["outs"][name]["grad"]
    if name in EX_JAX_GRADS:
        np.testing.assert_allclose(got, ranks["refs"][name], rtol=0, atol=1e-6)
    exact = np.zeros((EX_ROWS, EX_D), np.float64)
    np.add.at(exact, _ex_ids(name), ranks["cot"].astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(EX_STEPS))
def test_alltoall_step_equals_the_default_step(ranks, name):
    """Every state leaf and loss of the exchange's steps equal to the
    default lookup's bit for bit."""
    got, want = ranks["outs"][f"{name}_alltoall"], ranks["outs"][f"{name}_gspmd"]
    assert set(got) == set(want)
    for key in want:
        if key != "gather_dtypes":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.isfinite(got["losses"]).all() and got["losses"].shape[0] == STEPS


@pytest.mark.parametrize("name", sorted(BF16_UPDATES))
def test_bf16_wire_sparse_update_matches_jax(ranks, name):
    routing, skew = BF16_UPDATES[name][1], BF16_UPDATES[name][4]
    got, want = ranks["outs"][name], ranks["refs"][name]
    atol = 1e-6 if routing == "allgather" or skew else 1e-5
    for key in ("table", "m", "v"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)
    assert bool(got["overflow"]) == skew


@pytest.mark.parametrize("name", sorted(SPIES))
def test_data_axis_gathers_carry_the_wire_dtype(ranks, name):
    """The port's counterpart of the JAX package's
    ``test_comm_bf16_emits_bf16_row_grad_allgathers``: two dense mimic
    tables and two sparse tables, one step; every floating all-gather over
    ``data`` of it."""
    comm, routing, clip = SPIES[name]
    dtypes = list(ranks["outs"][name]["gather_dtypes"])
    if clip is None:  # the mimic tables' lanes, then the update's
        assert dtypes == [comm] * 4, dtypes
    else:  # the mimic tables' lanes, the norm's float32 lanes, the update's
        assert dtypes == [comm] * 2 + ["float32"] * 2 + [comm] * 2, dtypes


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_bf16_feature_rows_through_the_sharded_lookup(ranks, mesh):
    out = ranks["outs"][f"features_{mesh}"]
    got, want = out["got"], out["want"]
    neg_zero = want == np.int16(-0x8000)
    assert neg_zero.any()
    np.testing.assert_array_equal(got[~neg_zero], want[~neg_zero])
    assert (got[neg_zero] == 0).all()  # +0.0 after the sum over model


def test_model_ranks_of_a_data_shard_draw_the_same_dropout(ranks):
    """The model ranks of a data shard compute the same batch rows, so they
    must draw the same masks: the dense parameters (replicated, their
    gradients summed over data only) then stay equal on every rank."""
    dense = ranks["outs"]["dropout_2x2"]["rank_dense"]
    assert np.isfinite(ranks["outs"]["dropout_2x2"]["losses"]).all()
    for r in range(1, WORLD):
        np.testing.assert_array_equal(dense[r], dense[0], err_msg=f"rank {r}")
