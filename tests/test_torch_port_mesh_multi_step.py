"""The mesh's multi-step on four gloo ranks (one launch of
``tests/torch_parallel_worker.py``): ``make_sharded_multi_train_step`` and
``make_sharded_multi_eval_loss_step``, the owner routing's overflow taken on
the device, and the trainer on a mesh with ``training.steps_per_call``.

- K = 3 steps of ``make_sharded_multi_train_step`` equal three
  ``make_sharded_train_step`` calls bit for bit at 2x2 and 1x4, under the
  allgather routing, the owner routing and tensor parallelism (owner):
  every state leaf, the losses, the host counts, the negatives' generator
  and every rank's dropout stream (dropout on, negatives drawn), and the
  multi-step eval loss equals its single steps. On the CPU the multi-step
  is the loop of K steps; on a card it replays a captured CUDA graph
  (``chip_smoke.py`` phase 4f holds that to the eager steps).
- The owner routing forced into overflow (capacity factor 0.01) gives the
  allgather routing's bits, its device flag set and its counters reading
  one check and one overflow; an owner update that does not overflow
  counts one check, no overflow. The same holds for three train steps of
  the mesh on batches whose ids sit on one model shard (every check an
  overflow, the states bit for bit).
- The port's K-step mesh call is held to JAX's scanned
  ``make_sharded_multi_train_step`` on its virtual CPU mesh (2x2, both
  routings, the Pallas row kernels interpreted) at a configuration that
  draws nothing (the in-batch softmax with M = 0, logQ on, dropout off),
  within ``test_sharded_train_step_matches_jax``'s tolerances: losses rtol
  1e-4, tables, dense parameters and dense moments atol 1e-5, sparse
  moments atol 1e-6.
- ``run_single_experiment`` on a 2x2 mesh with ``steps_per_call`` 1, 4 and
  ``auto`` gives the same losses, val and test losses and sharded
  checkpoints (arrays bit for bit, the meta but its timestamp).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_async_checkpoint import assert_same_sharded
from test_torch_port_trainer import _config
from torch_ranks import launch
from ttamm_torch.data import write_synthetic_csvs
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.parallel import MeshConfig, build_mesh, pad_batch_data, pad_state_rows, place_data
from ttamm_tpu.parallel import place_state as jax_place_state
from ttamm_tpu.parallel.step import make_sharded_multi_train_step as jax_multi_step
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import optim as jax_optim
from ttamm_tpu.train import state as jax_state
from ttamm_tpu.train import step as jax_step

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD, WALL_SECONDS = 4, 300

NU, NI, FU, FI, D, H, B, NEG, C, K = 120, 80, 12, 9, 128, 32, 8, 3, 16, 3


def tower(dropout: float) -> dict:
    return {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": D, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [H], "output_dim": D,
                            "dropout": dropout},
        "fusion": "gated",
    }


MODELS = {
    # configs/default.yaml's structure with dropout on (dense mimic tables)
    "bce": {"user_encoder": tower(0.2), "item_encoder": tower(0.2), "similarity": "cosine",
            "adaptive_mimic": {"enabled": True}},
    # configs/in_batch_softmax.yaml's (sparse mimic tables), dropout off
    "ib": {"user_encoder": tower(0.0), "item_encoder": tower(0.0), "similarity": "cosine",
           "adaptive_mimic": {"enabled": True, "sparse": True}},
}
COMMON = dict(num_items=NI, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
              lambda_category_alignment=0.01, cal_max_categories=C)
TSCFG = {"bce": dict(COMMON, negatives_per_positive=NEG),
         "ib": dict(COMMON, loss_type="in_batch_softmax", mixed_negatives=0)}
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01)
# (mesh, routing, capacity factor, tensor parallel, batches) of the
# bit-for-bit cases; "skew" batches put SKEW_B users and items on the first
# model shard's rows, so that at capacity factor 0.01 every table overflows
# at every step
BIT_CASES = {
    f"{variant}_{m}": (mesh, routing, factor, tp, batches)
    for m, mesh in (("2x2", [2, 2]), ("1x4", [1, 4]))
    for variant, routing, factor, tp, batches in (
        ("allgather", "allgather", 2.0, False, "batches"),
        ("owner", "owner", 2.0, False, "batches"),
        ("tp", "owner", 2.0, True, "batches"),
        ("allgather_skew", "allgather", 2.0, False, "skew"),
        ("overflow", "owner", 0.01, False, "skew"),
    )
}
SKEW_B, SKEW_IDS = 32, 10
JAX_ROUTINGS = ("allgather", "owner")
# the sparse update of one table (n = 104 lanes, 96 rows of 16)
R, DU, N_LANES, LR = 96, 16, 104, 1e-2
UPDATE_MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
UPDATE_RUNS = [["allgather", "allgather", 2.0], ["overflow", "owner", 0.01], ["owner", "owner", 2.0]]
SPC = (1, 4, "auto")


def _data(rng):
    feats = (rng.normal(0, 1, (NU, FU)).astype(np.float32),
             rng.normal(0, 1, (NI, FI)).astype(np.float32))
    cats = np.minimum(rng.geometric(0.3, NI) - 1, 20).astype(np.int32)
    pos = np.full((NU, 4), NI, np.int32)
    for u in range(NU):
        k = rng.integers(1, 4)
        pos[u, :k] = rng.choice(NI, k, replace=False)
    counts = np.maximum(np.floor(rng.pareto(1.2, NI) * 3), 1.0)
    log_q = np.log(counts / counts.sum()).astype(np.float32)
    return {"user_features": feats[0], "item_features": feats[1], "positive_rows": pos,
            "category_ids": cats, "item_log_q": log_q}


def _initial_flat(structure, seed):
    jcfg = jax_parse(MODELS[structure], user_feature_dim=FU, item_feature_dim=FI)
    return {k: np.asarray(v) for k, v in jax_ckpt.state_to_host(
        jax_state.create_train_state(jax.random.key(seed), jcfg, num_users=NU, num_items=NI)
    ).items()}


def _jax_restore(template, flat):
    keys = list(jax_ckpt.state_to_host(template))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), [np.asarray(flat[k]) for k in keys])


def _jax_multi(routing, flat, data, users, items):
    """JAX's scanned K-step call on its virtual 2x2 mesh: the final state
    (flat host arrays) and the K losses."""
    jcfg = jax_parse(MODELS["ib"], user_feature_dim=FU, item_feature_dim=FI)
    template = jax_state.create_train_state(jax.random.key(0), jcfg, num_users=NU, num_items=NI)
    jdata = jax_state.BatchData(data["user_features"], data["item_features"],
                                data["positive_rows"], data["category_ids"], data["item_log_q"])
    tscfg = jax_step.TrainStepConfig(**TSCFG["ib"], use_pallas=True, cal_use_pallas=True,
                                     update_routing=routing, opt=jax_optim.DenseOptConfig(**OPT))
    mesh = build_mesh(MeshConfig(2, 2))
    state = jax_place_state(mesh, pad_state_rows(_jax_restore(template, flat), 2))
    pdata = place_data(mesh, pad_batch_data(jdata, 2))
    multi = jax_multi_step(jcfg, tscfg, mesh, state, pdata)
    state, losses = multi(state, pdata, jnp.asarray(users), jnp.asarray(items), jax.random.key(7))
    return jax_ckpt.state_to_host(state), np.asarray(losses)


def _update_inputs(rng):
    idx = np.where(rng.random(N_LANES) < 0.8, rng.integers(0, R // 8, N_LANES),
                   rng.integers(0, R, N_LANES)).astype(np.int32)
    return {"table": rng.standard_normal((R, DU)).astype(np.float32),
            "m": (0.1 * rng.standard_normal((R, DU))).astype(np.float32),
            "v": (0.01 * rng.random((R, DU))).astype(np.float32),
            "idx": idx, "grads": rng.standard_normal((N_LANES, DU)).astype(np.float32)}


def _trainer_config(root: Path, spc) -> dict:
    """The trainer test's tiny config on a 2x2 mesh (sharded checkpoints, a
    cosine schedule, every epoch's checkpoint kept)."""
    config = _config(root)
    config["data"]["root"] = str(root.parent / "data")
    config["mesh"] = {"data_parallel": 2, "model_parallel": 2}
    config["training"].update(steps_per_call=spc, lr_schedule="cosine")
    config["training"]["checkpointing"].update(save_best_only=False)
    return config


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_multi_step")
    rng = np.random.default_rng(21)
    data = _data(rng)
    inputs = {f"data/{k}": a for k, a in data.items()}
    tasks, refs = [], {}
    for structure in MODELS:
        inputs.update({f"{structure}/{k}": a for k, a in _initial_flat(structure, 1).items()})
    users = rng.integers(0, NU, (K, B)).astype(np.int32)
    items = data["positive_rows"][users, 0].copy()
    skew = rng.integers(0, SKEW_IDS, (K, SKEW_B)).astype(np.int32)
    inputs.update({"batches/u": users, "batches/p": items, "skew/u": skew,
                   "skew/p": rng.integers(0, SKEW_IDS, (K, SKEW_B)).astype(np.int32)})
    base = dict(kind="multi_step", feature_dims=[FU, FI], num_users=NU, num_items=NI, opt=OPT,
                inputs_prefix="batches", log_q=True)
    for name, (mesh, routing, factor, tp, batches) in BIT_CASES.items():
        tasks.append(dict(base, name=name, mesh=mesh, model=MODELS["bce"], state="bce",
                          tscfg=dict(TSCFG["bce"], update_routing=routing,
                                     update_capacity_factor=factor),
                          tensor_parallel=tp, dropout=True, seed=13, inputs_prefix=batches))
    for routing in JAX_ROUTINGS:
        refs[f"jax_{routing}"] = _jax_multi(routing, _initial_flat("ib", 1), data, users, items)
        tasks.append(dict(base, name=f"jax_{routing}", mesh=[2, 2], model=MODELS["ib"], state="ib",
                          tscfg=dict(TSCFG["ib"], update_routing=routing), seed=13))
    inputs.update({f"upd/{k}": a for k, a in _update_inputs(rng).items()})
    for name, mesh in UPDATE_MESHES.items():
        tasks.append(dict(kind="owner_overflow", name=f"update_{name}", mesh=mesh,
                          inputs_prefix="upd", lr=LR, runs=UPDATE_RUNS))
    write_synthetic_csvs(work / "data", num_users=300, num_items=200, num_interactions=4000, seed=3)
    for spc in SPC:
        tasks.append(dict(kind="train_run", name=f"train_{spc}",
                          config=_trainer_config(work / f"run_{spc}", spc)))
    np.savez(work / "inputs.npz", **inputs)
    spec = work / "spec.json"
    spec.write_text(json.dumps({"inputs": str(work / "inputs.npz"), "out": str(work),
                                "tasks": tasks}))
    launch(lambda r: [sys.executable, str(WORKER), str(spec)], WORLD, work, WALL_SECONDS)
    outs = {t["name"]: dict(np.load(work / f"{t['name']}.npz")) for t in tasks}
    return dict(outs=outs, refs=refs)


def _way(out, way):
    prefix = f"{way}/"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", sorted(BIT_CASES))
def test_mesh_multi_step_equals_single_steps_bit_for_bit(mesh_run, case):
    out = mesh_run["outs"][case]
    single, multi = _way(out, "single"), _way(out, "multi")
    assert list(multi) == list(single)
    for key, want in single.items():
        assert multi[key].dtype == want.dtype and multi[key].tobytes() == want.tobytes(), key
    assert (single["counts"] == K).all()
    assert single["dropout_generators"].shape[0] == WORLD  # every rank's stream compared
    checks, overflows = out["owner_stats"]
    routing, factor = BIT_CASES[case][1:3]
    tables = 2  # the ID tables (the mimic tables are dense here)
    assert checks == (2 * K * tables if routing == "owner" else 0)  # single and multi
    assert overflows == (checks if factor < 1 else 0)


@pytest.mark.parametrize("mesh", sorted(UPDATE_MESHES))
def test_mesh_overflow_steps_equal_the_allgather_steps(mesh_run, mesh):
    """Three steps of the owner routing, every table overflowing at every
    step, = the allgather routing's steps bit for bit."""
    got, want = _way(mesh_run["outs"][f"overflow_{mesh}"], "multi"), \
        _way(mesh_run["outs"][f"allgather_skew_{mesh}"], "multi")
    assert list(got) == list(want)
    for key in want:
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("mesh", sorted(UPDATE_MESHES))
def test_forced_overflow_update_equals_the_allgather_routing(mesh_run, mesh):
    out = mesh_run["outs"][f"update_{mesh}"]
    for key in ("table", "m", "v"):
        assert out[f"overflow/{key}"].tobytes() == out[f"allgather/{key}"].tobytes(), key
    assert out["overflow/stats"].tolist() == [1, 1] and int(out["overflow/flag"]) == 1
    assert out["owner/stats"].tolist() == [1, 0] and int(out["owner/flag"]) == 0
    assert out["allgather/stats"].tolist() == [0, 0] and int(out["allgather/flag"]) == -1
    np.testing.assert_allclose(out["owner/table"], out["allgather/table"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("routing", JAX_ROUTINGS)
def test_mesh_multi_step_matches_the_jax_scan(mesh_run, routing):
    want, want_losses = mesh_run["refs"][f"jax_{routing}"]
    got = _way(mesh_run["outs"][f"jax_{routing}"], "multi")
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4, atol=1e-7)
    for key, value in want.items():
        value = np.asarray(value)
        if value.ndim:
            value = value[: got[key].shape[0]]  # JAX pads tables to its own multiple
        atol = 1e-6 if key.startswith("opt_sparse") else 1e-5
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol, err_msg=key)


def test_trainer_on_a_mesh_is_the_same_for_each_steps_per_call(mesh_run):
    want = mesh_run["outs"]["train_1"]
    last = Path(str(want["last_checkpoint"]))
    dirs = sorted(p.name for p in last.parent.iterdir())
    assert len(dirs) >= 3 and all((last.parent / d).is_dir() for d in dirs), dirs
    assert int(want["multi_steps"]) == 0  # steps_per_call 1: eager single steps
    for spc in SPC[1:]:
        got = mesh_run["outs"][f"train_{spc}"]
        assert int(got["steps"]) == int(want["steps"]) > 2 * 4
        # the full batches of both epochs through the sharded multi-step
        assert 2 * 4 <= int(got["multi_steps"]) < int(got["steps"])
        for key in ("train_loss", "val_loss", "test_loss"):
            assert np.array_equal(got[key], want[key], equal_nan=True), key
        got_dir = Path(str(got["last_checkpoint"])).parent
        assert sorted(p.name for p in got_dir.iterdir()) == dirs
        for name in dirs:
            assert_same_sharded(got_dir / name, last.parent / name)
