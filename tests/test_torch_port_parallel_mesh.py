"""The port's multi-device layer on a CPU mesh of four gloo ranks against
the JAX package on its virtual 8-device CPU mesh (same mesh shapes).

The ranks (tests/torch_parallel_worker.py) import torch and the port only;
they start once for the whole module and run every scenario, each launch
under a wall limit. The JAX side runs here, its Pallas kernels in interpret
mode. The scenarios:

- ``sharded_sparse_adam_update`` on 2x2 and 1x4 meshes under the allgather
  and owner routings, an owner run forced into overflow (skewed ids, small
  capacity), and a shard that owns no lane; n = 512 lanes, so JAX's
  ``_pick_block`` takes its Pallas path. Tolerances: allgather table, m and
  v atol 1e-6 (the same coalesce order; only the bias corrections' f32 vs
  f64 powers differ); owner atol 1e-5 (two-phase duplicate sums, the
  tolerance of ``ttamm_tpu/parallel/sparse_update.py``); both sides also
  held to a float64 numpy oracle of the update at the same tolerance, the
  message naming the array, its first rows and each side's distance from
  the oracle (the JAX side gets its own copies of the inputs, is waited
  for, and the inputs must be unchanged after it), and each side alone in
  ``test_sharded_sadam_vs_oracle[<side>-<name>]``; and each rank's
  one ``sparse_adam_rows`` call holding every row its shard owns once,
  -1 on every other lane;
- the sharded training step on a 2x2 mesh, two steps under both routings
  (the owner run with the global-norm clip), from one state (``convert.py``), with injected negatives and no dropout,
  against JAX ``make_sharded_train_step(use_pallas=True)``: losses rel 1e-4,
  tables, dense parameters and dense moments atol 1e-5, sparse moments atol
  1e-6 (the tolerances of tests/test_parallel.py);
- the in-batch softmax with sparse mimic tables (``configs/in_batch_softmax.yaml``'s
  structure) on 2x2 and 1x4 meshes under both routings (the owner run with
  the clip), two steps of a 7-row batch and a pool of 5 mixed negatives
  (both split unevenly over the data shards), against the port's
  one-device step on the whole batch from the same state, pools and no
  dropout: losses rtol 1e-5 (the category-alignment term among them, which
  would move if a shard counted the shared pool's rows again), tables,
  dense parameters and moments atol 1e-5, sparse moments atol 1e-6 (the
  dense gradients and the candidates' gradients are summed over data in
  another order), and the mimic tables' scratch rows still zero;
- the sharded search (1x4, float32 and bfloat16, masked) against JAX
  ``make_sharded_topk``: equal ids except where scores tie within 1e-5
  (float32) or 2^-7 (bf16 rounding in another order), and no pad row;
- the sharded checkpoint: the ranks write one that JAX
  ``load_sharded_checkpoint`` reads back bit for bit, and read one JAX
  wrote (from a 2x2 placement) bit for bit; so too for a sparse-mimic
  state.
"""

import json
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.ops.sampling import sample_negative_items as jax_sample
from ttamm_tpu.ops.sparse_adam import SparseAdamState
from ttamm_tpu.parallel import (
    MeshConfig,
    build_mesh,
    pad_batch_data,
    pad_state_rows,
    place_data,
    place_state,
)
from ttamm_tpu.parallel.sparse_update import sharded_sparse_adam_update
from ttamm_tpu.parallel.step import make_sharded_topk, make_sharded_train_step
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import optim as jax_optim
from ttamm_tpu.train import sharded_checkpoint as jax_sharded
from ttamm_tpu.train import state as jax_state
from ttamm_tpu.train import step as jax_step
from torch_ranks import launch

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD = 4
WALL_SECONDS = 240

# sparse updates
R, DU, N_LANES, LR = 96, 16, 104, 1e-2
UPDATES = {  # name: (mesh, routing, capacity factor, id range, skew)
    "ag_2x2": ((2, 2), "allgather", 2.0, R, False),
    "owner_2x2": ((2, 2), "owner", 2.0, R, False),
    "overflow_2x2": ((2, 2), "owner", 0.3, R, True),
    "ag_1x4_idle_shard": ((1, 4), "allgather", 2.0, 3 * R // 4, False),  # shard 3 owns no lane
    "owner_1x4": ((1, 4), "owner", 2.0, R, False),
    "overflow_1x4": ((1, 4), "owner", 0.25, R, True),
}
# training steps (D = 128 and C = 16 meet the JAX second-moment kernel's gate)
NU, NI, FU, FI, D, B, NEG, C, STEPS = 300, 200, 12, 9, 128, 8, 5, 16, 2
TOWER = {
    "type": "tower",
    "id_embedding": {"params": {"embedding_dim": D, "sparse": True}},
    "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": D, "dropout": 0.0},
    "fusion": "gated",
}
MODEL = {"user_encoder": TOWER, "item_encoder": TOWER, "similarity": "cosine",
         "adaptive_mimic": {"enabled": True}}
TSCFG = dict(num_items=NI, negatives_per_positive=NEG, lambda_mimic_user=0.15,
             lambda_mimic_item=0.15, lambda_category_alignment=0.01, cal_max_categories=C)
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01)
ROUTINGS = ("allgather", "owner")
CLIP = {"allgather": None, "owner": 0.5}  # the owner run also takes the clip, which binds
# the in-batch softmax with sparse mimic tables
IB_B, IB_M = 7, 5
IB_MODEL = dict(MODEL, adaptive_mimic={"enabled": True, "sparse": True})
IB_TSCFG = dict(TSCFG, loss_type="in_batch_softmax", mixed_negatives=IB_M)
IB_MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
# search
SN, SD, SB, SK, SM = 301, 16, 24, 10, 6


def launch_ranks(spec_path: Path) -> list[str]:
    return launch(lambda r: [sys.executable, str(WORKER), str(spec_path)], WORLD,
                  spec_path.parent, WALL_SECONDS)


def _update_inputs(name, id_range, skew):
    """The case's table, moments, lanes and gradients, drawn from a seed of
    its name that every process computes alike (``hash`` is salted per
    process)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    table = rng.standard_normal((R, DU)).astype(np.float32)
    m = (0.1 * rng.standard_normal((R, DU))).astype(np.float32)
    v = (0.01 * rng.random((R, DU))).astype(np.float32)
    if skew:  # most lanes on the first shard's rows
        idx = np.where(rng.random(N_LANES) < 0.8, rng.integers(0, R // 8, N_LANES),
                       rng.integers(0, id_range, N_LANES))
    else:
        idx = rng.integers(0, id_range, N_LANES)
    grads = rng.standard_normal((N_LANES, DU)).astype(np.float32)
    return dict(table=table, m=m, v=v, idx=idx.astype(np.int32), grads=grads)


def _jax_update(mesh_shape, routing, factor, x):
    """The JAX sharded update on its own copies of the inputs, waited for;
    the inputs must come back unchanged."""
    saved = {k: a.copy() for k, a in x.items()}
    mesh = build_mesh(MeshConfig(*mesh_shape))
    st = SparseAdamState(m=jnp.array(x["m"].copy()), v=jnp.array(x["v"].copy()),
                         step=jnp.asarray(2, jnp.int32))
    fn = jax.jit(lambda t, s, i, g: sharded_sparse_adam_update(
        mesh, t, s, i, g, lr=LR, routing=routing, capacity_factor=factor, interpret=True))
    table, state = jax.block_until_ready(fn(
        jnp.array(x["table"].copy()), st, jnp.array(x["idx"].copy()), jnp.array(x["grads"].copy())))
    for k, a in x.items():
        assert np.array_equal(a, saved[k]), f"the JAX update wrote its input {k}"
    return {"table": np.asarray(table), "m": np.asarray(state.m), "v": np.asarray(state.v)}


def _oracle_update(x, step=3, b1=0.9, b2=0.999, eps=1e-8):
    """The sharded update in float64 numpy: every lane of a row summed, Adam
    on the touched rows at ``step``'s bias corrections."""
    table, m, v = (x[k].astype(np.float64) for k in ("table", "m", "v"))
    rows = np.unique(x["idx"])
    summed = np.zeros(table.shape)
    np.add.at(summed, x["idx"], x["grads"].astype(np.float64))
    gr = summed[rows]
    m[rows] = b1 * m[rows] + (1.0 - b1) * gr
    v[rows] = b2 * v[rows] + (1.0 - b2) * gr * gr
    table[rows] -= LR * (m[rows] / (1.0 - b1**step)) / (np.sqrt(v[rows] / (1.0 - b2**step)) + eps)
    return {"table": table, "m": m, "v": v}


def _check_sides(name, port, jax_side, oracle, atol):
    """Port and JAX within ``atol`` of each other and of the float64 oracle;
    the message names the array, its first rows off and each side's
    distance from the oracle."""
    off = {"port-jax": np.abs(port - jax_side) > atol, "port-oracle": np.abs(port - oracle) > atol,
           "jax-oracle": np.abs(jax_side - oracle) > atol}
    if not any(o.any() for o in off.values()):
        return
    rows = np.unique(np.nonzero(np.logical_or.reduce(list(off.values())))[0])[:6]
    per_row = {int(r): (float(np.abs(port[r] - oracle[r]).max()),
                        float(np.abs(jax_side[r] - oracle[r]).max())) for r in rows}
    raise AssertionError(
        f"{name}: elements off {({k: int(o.sum()) for k, o in off.items()})}; first rows "
        f"{rows.tolist()}; max |port - oracle|, |jax - oracle| by row {per_row}; whole array: "
        f"port - oracle {np.abs(port - oracle).max():.4e}, jax - oracle "
        f"{np.abs(jax_side - oracle).max():.4e}, port - jax {np.abs(port - jax_side).max():.4e}")


def _step_setup():
    jcfg = jax_parse(MODEL, user_feature_dim=FU, item_feature_dim=FI)
    rng = np.random.default_rng(0)
    feats = (rng.normal(0, 1, (NU, FU)).astype(np.float32),
             rng.normal(0, 1, (NI, FI)).astype(np.float32))
    cats = np.minimum(rng.geometric(0.3, NI) - 1, 20).astype(np.int32)
    pos = np.full((NU, 6), NI, np.int32)
    for u in range(NU):
        k = rng.integers(1, 6)
        pos[u, :k] = rng.choice(NI, k, replace=False)
    jstate = jax_state.create_train_state(jax.random.key(1), jcfg, num_users=NU, num_items=NI)
    jdata = jax_state.BatchData(*(jnp.asarray(a) for a in (*feats, pos, cats)))
    batches = []
    for s in range(STEPS):
        key = jax.random.fold_in(jax.random.key(5), s)
        u = rng.integers(0, NU, B).astype(np.int32)
        neg = jax_sample(jax.random.split(key)[0], jnp.asarray(pos[u]), num_items=NI,
                         num_negatives=NEG, num_rounds=8)
        batches.append((u, pos[u, 0].copy(), np.array(neg), key))
    return jcfg, jstate, jdata, (feats, pos, cats), batches


def _jax_steps(jcfg, jstate, jdata, batches, routing):
    tscfg = jax_step.TrainStepConfig(
        **TSCFG, use_pallas=True, cal_use_pallas=True, update_routing=routing,
        gradient_clip_norm=CLIP[routing], opt=jax_optim.DenseOptConfig(**OPT),
    )
    mesh = build_mesh(MeshConfig(2, 2))
    host = jax.device_get(jstate)
    state = place_state(mesh, pad_state_rows(host, 2))
    data = place_data(mesh, pad_batch_data(jax.device_get(jdata), 2))
    step = make_sharded_train_step(jcfg, tscfg, mesh, state, data)
    losses = []
    for u, p, _, key in batches:
        state, metrics = step(state, data, jnp.asarray(u), jnp.asarray(p), key)
        losses.append([float(metrics[k]) for k in sorted(metrics)])
    return jax_ckpt.state_to_host(state), np.asarray(losses)


def _in_batch_setup():
    """A sparse-mimic state (JAX's init, as flat host arrays), the train
    split's log q, and IB_B-row batches with their pools of IB_M ids."""
    jcfg = jax_parse(IB_MODEL, user_feature_dim=FU, item_feature_dim=FI)
    jstate = jax_state.create_train_state(jax.random.key(2), jcfg, num_users=NU, num_items=NI)
    rng = np.random.default_rng(4)
    counts = np.maximum(np.floor(rng.pareto(1.2, NI) * 3), 1.0)
    log_q = np.log(counts / counts.sum()).astype(np.float32)
    batches = []
    for _ in range(STEPS):
        u = rng.integers(0, NU, IB_B).astype(np.int32)
        p = rng.integers(0, NI, IB_B).astype(np.int32)
        p[4] = p[1]  # an accidental hit across the two data shards
        pool = rng.integers(0, NI, IB_M).astype(np.int32)
        pool[3] = p[0]  # a pool draw equal to a positive
        batches.append((u, p, pool))
    return jax_ckpt.state_to_host(jstate), log_q, batches


def _one_device_in_batch(flat, data, batches, routing):
    """The port's one-device steps on the whole batches: per-step losses
    (sorted keys) and the final state as flat host arrays."""
    import torch

    from ttamm_torch.models import parse_model_config
    from ttamm_torch.models.convert import train_state_from_flat, train_state_to_flat
    from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
    from ttamm_torch.train.optim import DenseOptConfig

    cfg = parse_model_config(IB_MODEL, user_feature_dim=FU, item_feature_dim=FI)
    state = create_train_state(cfg, num_users=NU, num_items=NI, seed=0, device="cpu")
    train_state_from_flat(state, flat)
    tscfg = TrainStepConfig(**dict(IB_TSCFG, gradient_clip_norm=CLIP[routing]),
                            opt=DenseOptConfig(**OPT))
    step = make_train_step(cfg, tscfg)
    pdata = BatchData(*(torch.from_numpy(a) for a in data))
    losses = []
    for u, p, pool in batches:
        state, metrics = step(state, pdata, torch.from_numpy(u), torch.from_numpy(p),
                              generator=None, negatives=torch.from_numpy(pool))
        losses.append([float(metrics[k]) for k in sorted(metrics)])
    return train_state_to_flat(state), np.asarray(losses)


def _jax_sharded_checkpoint(directory, jcfg, state_flat):
    """``(template, trained, jax_dir)``: a JAX template state of ``jcfg``, the
    flat ``state_flat`` cut back to its shapes, and the directory of the JAX
    sharded checkpoint of that state saved from a 2x2 placement."""
    template = jax_state.create_train_state(jax.random.key(9), jcfg, num_users=NU, num_items=NI)
    shapes = {k: np.shape(a) for k, a in jax_ckpt.state_to_host(template).items()}
    trained = {  # the trained state cut back from JAX's padding
        k: np.asarray(a)[: shapes[k][0]] if np.ndim(a) else np.asarray(a)
        for k, a in state_flat.items()
    }
    restored = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(trained[k]) for k in jax_ckpt.state_to_host(template)],
    )
    placed = place_state(build_mesh(MeshConfig(2, 2)), pad_state_rows(jax.device_get(restored), 2))
    jax_dir = jax_sharded.save_sharded_checkpoint(
        directory, placed, experiment_name="jax", epoch=3, metric_name=None,
        metric_value=None, template="{experiment}_epoch{epoch}",
    )
    return template, trained, jax_dir


def _search_inputs():
    rng = np.random.default_rng(7)
    items = rng.standard_normal((SN, SD)).astype(np.float32)
    queries = rng.standard_normal((SB, SD)).astype(np.float32)
    top = np.argsort(-(queries @ items.T), axis=1, kind="stable")
    mask = np.concatenate([top[:, :SM // 2], rng.integers(0, SN, (SB, SM // 2))], axis=1)
    mask[:, -1] = SN  # padding id
    return items, queries, mask.astype(np.int32)


def _jax_search(items, queries, mask, score_dtype):
    mesh = build_mesh(MeshConfig(1, 4))
    padded = np.concatenate([items, np.zeros((-SN % 4, SD), np.float32)])
    fn = make_sharded_topk(mesh, k=SK, padded_rows=padded.shape[0], num_valid_rows=SN,
                           score_dtype=score_dtype, with_mask=True, mask_width=SM, dim=SD,
                           local_algorithm="slab", interpret=True)
    scores, ids = jax.jit(fn)(jnp.asarray(queries), jnp.asarray(padded), jnp.asarray(mask))
    return np.asarray(scores), np.asarray(ids)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """JAX references, then one launch of the four ranks for every scenario."""
    work = tmp_path_factory.mktemp("torch_mesh")
    inputs, tasks, refs = {}, [], {}
    for name, (mesh, routing, factor, id_range, skew) in UPDATES.items():
        x = _update_inputs(name, id_range, skew)
        inputs.update({f"{name}/{k}": a for k, a in x.items()})
        refs[name] = _jax_update(mesh, routing, factor, x)
        tasks.append(dict(kind="sparse_update", name=name, mesh=mesh, routing=routing,
                          capacity_factor=factor, step=2, lr=LR))

    jcfg, jstate, jdata, (feats, pos, cats), batches = _step_setup()
    inputs.update({f"state/{k}": a for k, a in jax_ckpt.state_to_host(jstate).items()})
    inputs.update({"data/user_features": feats[0], "data/item_features": feats[1],
                   "data/positive_rows": pos, "data/category_ids": cats})
    model_task = dict(model=MODEL, feature_dims=[FU, FI], num_users=NU, num_items=NI,
                      state="state")
    for routing in ROUTINGS:
        name = f"step_{routing}"
        refs[name] = _jax_steps(jcfg, jstate, jdata, batches, routing)
        for s, (u, p, neg, _) in enumerate(batches):
            inputs.update({f"{name}/u{s}": u, f"{name}/p{s}": p, f"{name}/neg{s}": neg})
        tasks.append(dict(model_task, kind="train_step", name=name, mesh=[2, 2], steps=STEPS,
                          tscfg=dict(TSCFG, update_routing=routing, gradient_clip_norm=CLIP[routing]),
                          opt=OPT))

    ib_flat, log_q, ib_batches = _in_batch_setup()
    inputs.update({f"ib_state/{k}": a for k, a in ib_flat.items()})
    inputs["data/item_log_q"] = log_q
    for s, (u, p, pool) in enumerate(ib_batches):
        inputs.update({f"in_batch/u{s}": u, f"in_batch/p{s}": p, f"in_batch/neg{s}": pool})
    for routing in ROUTINGS:
        refs[f"in_batch_{routing}"] = _one_device_in_batch(
            ib_flat, (*feats, pos, cats, log_q), ib_batches, routing)
        for label, mesh in IB_MESHES.items():
            tasks.append(dict(
                model_task, model=IB_MODEL, state="ib_state", kind="train_step",
                name=f"in_batch_{routing}_{label}", inputs_prefix="in_batch", mesh=mesh,
                steps=STEPS, log_q=True, opt=OPT,
                tscfg=dict(IB_TSCFG, update_routing=routing, gradient_clip_norm=CLIP[routing]),
            ))

    items, queries, mask = _search_inputs()
    inputs.update({"search/items": items, "search/queries": queries, "search/mask": mask})
    for score_dtype in ("float32", "bfloat16"):
        name = f"search_{score_dtype}"
        refs[name] = _jax_search(items, queries, mask, score_dtype)
        tasks.append(dict(kind="search", name=name, mesh=[1, 4], k=SK, masked=True,
                          score_dtype=score_dtype))

    # checkpoints: a trained JAX state saved from a 2x2 placement, for the
    # default structure and the sparse-mimic one
    template, trained, jax_dir = _jax_sharded_checkpoint(
        work / "jax_ckpt", jcfg, refs["step_allgather"][0])
    inputs.update({f"trained/{k}": a for k, a in trained.items()})
    tasks.append(dict(model_task, kind="checkpoint", name="checkpoint", mesh=[2, 2],
                      state="trained", save_dir=str(work / "port_ckpt"), jax_dir=str(jax_dir)))
    ib_template, ib_trained, ib_jax_dir = _jax_sharded_checkpoint(
        work / "jax_ib_ckpt", jax_parse(IB_MODEL, user_feature_dim=FU, item_feature_dim=FI),
        refs["in_batch_allgather"][0])
    inputs.update({f"ib_trained/{k}": a for k, a in ib_trained.items()})
    tasks.append(dict(model_task, model=IB_MODEL, kind="checkpoint", name="ib_checkpoint",
                      mesh=[2, 2], state="ib_trained", save_dir=str(work / "port_ib_ckpt"),
                      jax_dir=str(ib_jax_dir)))

    np.savez(work / "inputs.npz", **inputs)
    spec = work / "spec.json"
    spec.write_text(json.dumps({"inputs": str(work / "inputs.npz"), "out": str(work),
                                "tasks": tasks}))
    launch_ranks(spec)
    outs = {t["name"]: dict(np.load(work / f"{t['name']}.npz")) for t in tasks}
    return dict(work=work, refs=refs, outs=outs, jcfg=jcfg, template=template, trained=trained,
                ib_template=ib_template, ib_trained=ib_trained)


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_sharded_sparse_adam_update_matches_jax(mesh_run, name):
    routing, skew = UPDATES[name][1], UPDATES[name][4]
    got, want = mesh_run["outs"][name], mesh_run["refs"][name]
    atol = 1e-6 if routing == "allgather" or skew else 1e-5
    oracle = _oracle_update(_update_inputs(name, *UPDATES[name][3:]))
    for key in ("table", "m", "v"):
        _check_sides(f"{name} {key}", got[key], want[key], oracle[key], atol)
    for key in ("table", "m", "v"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)
    assert int(got["step"]) == 3
    assert bool(got["overflow"]) == skew  # the skewed owner runs fell back


@pytest.mark.parametrize("name", sorted(UPDATES))
@pytest.mark.parametrize("side", ["jax", "port"])
def test_sharded_sadam_vs_oracle(mesh_run, side, name):
    """One side's sharded update (table, m and v) against the float64
    oracle at the test above's tolerance: the id names the side that left
    the oracle."""
    routing, skew = UPDATES[name][1], UPDATES[name][4]
    got = (mesh_run["outs"] if side == "port" else mesh_run["refs"])[name]
    atol = 1e-6 if routing == "allgather" or skew else 1e-5
    oracle = _oracle_update(_update_inputs(name, *UPDATES[name][3:]))
    for key in ("table", "m", "v"):
        off = np.abs(got[key] - oracle[key]) > atol
        assert int(off.sum()) == 0, (
            f"{side}, {name} {key}: {int(off.sum())} elements off the oracle, rows "
            f"{np.unique(np.nonzero(off)[0]).tolist()}, max |{side} - oracle| "
            f"{np.abs(got[key] - oracle[key]).max():.4e}")


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_sharded_update_lanes_hold_each_owned_row_once(mesh_run, name):
    """Each rank's update is one ``sparse_adam_rows`` call whose lanes hold
    every row its shard owns among the step's ids exactly once (shard-local)
    and -1 on every other lane: a run's non-heads, the rows of other
    shards, the owner buffer's sentinel tail (at one data shard, 1x4)."""
    got = mesh_run["outs"][name]
    x = _update_inputs(name, *UPDATES[name][3:])
    mp = UPDATES[name][0][1]
    rows = R // mp
    assert (got["calls"] == 1).all()
    for lanes, base in zip(got["lanes"], got["bases"]):
        live = lanes[lanes >= 0]
        assert (lanes[lanes < 0] == -1).all()
        assert live.size == np.unique(live).size and (live < rows).all()
        ids = np.unique(x["idx"])
        owned = ids[(ids >= base) & (ids < base + rows)] - base
        np.testing.assert_array_equal(np.sort(live), owned)
    if UPDATES[name][1] == "owner" and UPDATES[name][0][0] == 1 and not UPDATES[name][4]:
        # one data shard: the buffer is the owned rows, sorted, then sentinels
        for lanes in got["lanes"]:
            live = (lanes >= 0).sum()
            assert (lanes[:live] >= 0).all() and (np.diff(lanes[:live]) > 0).all()
            assert live < lanes.size and (lanes[live:] == -1).all()


@pytest.mark.parametrize("routing", ROUTINGS)
def test_sharded_train_step_matches_jax(mesh_run, routing):
    want, want_losses = mesh_run["refs"][f"step_{routing}"]
    got = mesh_run["outs"][f"step_{routing}"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4, atol=1e-7)
    for key, value in want.items():
        value = np.asarray(value)
        if value.ndim:
            value = value[: got[key].shape[0]]  # JAX pads tables to its own multiple
        atol = 1e-6 if key.startswith("opt_sparse") else 1e-5
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("mesh", sorted(IB_MESHES))
@pytest.mark.parametrize("routing", ROUTINGS)
def test_in_batch_sparse_mimic_step_matches_one_device(mesh_run, routing, mesh):
    want, want_losses = mesh_run["refs"][f"in_batch_{routing}"]
    got = mesh_run["outs"][f"in_batch_{routing}_{mesh}"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5, atol=1e-7)
    assert set(want) <= set(got)
    for key, value in want.items():
        atol = 1e-6 if key.startswith("opt_sparse") else 1e-5
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol, err_msg=key)
    for name, rows in (("user_aug", NU), ("item_aug", NI)):
        assert got[f"tables/{name}"].shape[0] == rows + 1
        assert not got[f"tables/{name}"][rows].any()  # the scratch row


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_sharded_search_matches_jax(mesh_run, score_dtype):
    got = mesh_run["outs"][f"search_{score_dtype}"]
    want_scores, want_ids = mesh_run["refs"][f"search_{score_dtype}"]
    tol = 1e-5 if score_dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got["scores"], want_scores, rtol=0, atol=tol)
    assert (got["ids"] >= 0).all() and (got["ids"] < SN).all()  # no pad row
    items, queries, mask = _search_inputs()
    assert not any(np.isin(ids, m).any() for ids, m in zip(got["ids"], mask))  # none blocked
    # each returned id really has the score returned beside it (a wrong shard
    # offset gives right scores under wrong ids) ...
    cast = lambda x: np.asarray(jnp.asarray(x, score_dtype), np.float64)  # noqa: E731
    exact = cast(queries) @ cast(items).T
    rescored = np.take_along_axis(exact, got["ids"].astype(np.int64), axis=1)
    np.testing.assert_allclose(rescored, want_scores, rtol=tol, atol=tol)
    # ... and is JAX's id wherever JAX's score stands apart from its neighbours
    gap = np.diff(want_scores, axis=1) < -2 * tol * np.maximum(1.0, np.abs(want_scores[:, 1:]))
    apart = np.ones_like(want_ids, dtype=bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    assert apart.mean() > 0.25
    np.testing.assert_array_equal(got["ids"][apart], want_ids[apart])


def test_port_sharded_checkpoint_read_by_jax(mesh_run):
    ckpt = mesh_run["work"] / "port_ckpt" / "port_epoch3"
    assert sorted(p.name for p in ckpt.glob("shards_p*.npz")) == [
        f"shards_p{r:05d}.npz" for r in range(WORLD)
    ]
    restored, meta = jax_sharded.load_sharded_checkpoint(ckpt, mesh_run["template"])
    assert meta["epoch"] == 3 and meta["num_processes"] == WORLD
    for key, value in jax_ckpt.state_to_host(restored).items():
        np.testing.assert_array_equal(np.asarray(value), mesh_run["trained"][key], err_msg=key)


def test_port_reads_jax_sharded_checkpoint(mesh_run):
    got = mesh_run["outs"]["checkpoint"]
    assert int(got["epoch"]) == 3
    for key, value in mesh_run["trained"].items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_sparse_mimic_sharded_checkpoints_cross_over(mesh_run):
    """A sparse-mimic state (each mimic table with its scratch row, its
    moments under ``opt_sparse``): the ranks' sharded checkpoint read by JAX
    ``load_sharded_checkpoint`` and JAX's read by the ranks, bit for bit."""
    trained = mesh_run["ib_trained"]
    assert trained["tables/user_aug"].shape[0] == NU + 1 and "opt_sparse/item_aug/m" in trained
    ckpt = mesh_run["work"] / "port_ib_ckpt" / "port_epoch3"
    restored, meta = jax_sharded.load_sharded_checkpoint(ckpt, mesh_run["ib_template"])
    assert meta["epoch"] == 3 and meta["num_processes"] == WORLD
    for key, value in jax_ckpt.state_to_host(restored).items():
        np.testing.assert_array_equal(np.asarray(value), trained[key], err_msg=key)
    got = mesh_run["outs"]["ib_checkpoint"]
    for key, value in trained.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
