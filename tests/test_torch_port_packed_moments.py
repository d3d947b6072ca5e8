"""``training.packed_moments`` in the port against its separate layout and
against the JAX package, on the CPU.

The JAX package's packed layout holds a sparse table's Adam moments as one
``[rows, 2D]`` tensor ``mv`` with ``m = mv[:, :D]`` and ``v = mv[:, D:]``
(``SparseAdamStatePacked``). The port keeps the moments as two tensors in
memory and writes the packed layout's ``mv`` leaf to its checkpoints.

- The port's update against the JAX ``sparse_adam_update_packed`` at the
  sparse-Adam tolerances of tests/test_torch_port_sparse_adam_rows.py
  (rtol 1e-5, atol 1e-6 after three steps).
- The state: the ``mv`` leaf of each sparse table, its relayouts.
- Flat and sharded checkpoints across the layouts, each way, the port's
  files and JAX's, bit for bit (a relayout only; mirrors
  tests/test_checkpoint.py and tests/test_sharded_checkpoint.py).
- Three one-device train steps of the in-batch sparse-mimic config (four
  sparse tables): packed = separate bit for bit, and against the JAX packed
  step at tests/torch_step_setup.py's tolerances.
- The sharded step on four gloo ranks (tests/torch_parallel_worker.py) at
  2x2 and 1x4, both routings, and at 2x2 under the bf16 gradient wire:
  packed = separate bit for bit (mirrors tests/test_parallel.py's packed
  mesh step); and sharded checkpoints across the layouts on the mesh.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_step_setup as ts
from torch_ranks import launch
from ttamm_torch.models import parse_model_config as port_parse
from ttamm_torch.models.convert import (
    moment_layout_leaf,
    pack_moment_leaves,
    train_state_from_flat,
    train_state_to_flat,
)
from ttamm_torch.ops.sparse_adam import init_sparse_adam, sparse_adam_update
from ttamm_torch.parallel import pad_state_rows
from ttamm_torch.train import checkpoint as port_ckpt
from ttamm_torch.train import create_train_state
from ttamm_torch.train import sharded_checkpoint as port_sharded
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.ops import sparse_adam as jax_sparse
from ttamm_tpu.parallel import MeshConfig, build_mesh
from ttamm_tpu.parallel import pad_state_rows as jax_pad_state_rows
from ttamm_tpu.parallel import place_state as jax_place_state
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import sharded_checkpoint as jax_sharded
from ttamm_tpu.train import state as jax_state

ROWS, D, N = 40, 128, 64  # table rows before the scratch row


def _lanes(layout, rng):
    if layout == "duplicates":  # a third of the lanes on one row
        idx = rng.integers(0, ROWS, N).astype(np.int32)
        idx[: N // 3] = idx[0]
        return idx
    if layout == "one_row":
        return np.full(N, 7, np.int32)
    return np.array([rng.integers(0, ROWS)], np.int32)


def _table(rng):
    table = rng.standard_normal((ROWS + 1, D)).astype(np.float32)
    table[-1] = 0.0
    return table


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("layout", ["duplicates", "one_row", "one_lane"])
def test_packed_update_matches_jax_packed(layout, weight_decay):
    rng = np.random.default_rng(11)
    table = _table(rng)
    j_table = jnp.asarray(table)
    j_state = jax_sparse.init_sparse_adam(j_table, packed=True)
    t_table = torch.from_numpy(table.copy())
    t_state = init_sparse_adam(t_table)
    for _ in range(3):
        idx = _lanes(layout, rng)
        g = rng.standard_normal((idx.shape[0], D)).astype(np.float32)
        j_table, j_state = jax_sparse.sparse_adam_update_packed(
            j_table, j_state, jnp.asarray(idx), jnp.asarray(g), lr=0.01,
            weight_decay=weight_decay,
        )
        sparse_adam_update(t_table, t_state, torch.from_numpy(idx), torch.from_numpy(g), lr=0.01,
                           weight_decay=weight_decay)
    assert t_state.step == int(j_state.step) == 3
    mv = torch.cat([t_state.m, t_state.v], dim=1)
    for got, want in ((t_table, j_table), (mv, j_state.mv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("padded", [False, True])
def test_packed_state_writes_one_mv_leaf(padded):
    """A packed state's flat leaves: one ``mv`` = ``[m | v]`` a sparse
    table, no ``m`` or ``v``, the rest as the separate state's; kept by
    ``pad_state_rows``; ``moment_layout_leaf`` cuts ``m`` and ``v`` back
    out bit for bit."""
    cfg, st = _trained_flat(True, seed=3)
    if padded:
        st = pad_state_rows(st, 4)
    assert st.packed_moments
    flat = train_state_to_flat(st)
    sep = train_state_to_flat(dataclasses.replace(st, packed_moments=False))
    assert pack_moment_leaves(sep).keys() == flat.keys()
    for name, s in st.opt_sparse.items():
        key = f"opt_sparse/{name}/mv"
        assert flat[key].shape == (st.tables[name].shape[0], 2 * ts.D)
        assert f"opt_sparse/{name}/m" not in flat and f"opt_sparse/{name}/v" not in flat
        np.testing.assert_array_equal(flat[key], torch.cat([s.m, s.v], dim=1).numpy())
        for leaf in ("m", "v"):
            np.testing.assert_array_equal(
                moment_layout_leaf(f"opt_sparse/{name}/{leaf}", flat), sep[f"opt_sparse/{name}/{leaf}"])
    for key in sep:
        if key in flat:
            np.testing.assert_array_equal(flat[key], sep[key])


def _trained_flat(packed: bool, seed: int = 0):
    """A port state of the sparse-mimic config whose tables and moments are
    non-trivial, as flat arrays in the separate layout, and its config."""
    cfg = port_parse(ts.model_yaml(), user_feature_dim=ts.FU, item_feature_dim=ts.FI)
    st = create_train_state(cfg, num_users=ts.NU, num_items=ts.NI, seed=seed, device="cpu",
                            packed_moments=packed)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, s in st.opt_sparse.items():
            s.m.copy_(torch.from_numpy(rng.standard_normal(s.m.shape).astype(np.float32)))
            s.v.copy_(torch.from_numpy(np.abs(rng.standard_normal(s.v.shape)).astype(np.float32)))
            s.step = 5
    return cfg, st


def _separate(flat):
    """Flat arrays with every packed moment leaf split into m and v."""
    out = {}
    for key, value in flat.items():
        if key.endswith("/mv"):
            prefix = key[: -len("/mv")]
            for leaf in ("m", "v"):
                out[f"{prefix}/{leaf}"] = moment_layout_leaf(f"{prefix}/{leaf}", flat)
        else:
            out[key] = value
    return out


def _assert_same_state(got_flat, want_flat):
    got, want = _separate(got_flat), _separate(want_flat)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _jax_state(flat, packed, mesh=None):
    """A JAX training state (sparse-mimic config) holding ``flat``'s values
    (the separate layout) in the layout ``packed``; placed on ``mesh``
    (padded to its model axis) when given."""
    jcfg = jax_parse(ts.model_yaml(), user_feature_dim=ts.FU, item_feature_dim=ts.FI)
    template = jax_state.create_train_state(jax.random.key(9), jcfg, num_users=ts.NU,
                                            num_items=ts.NI, packed_moments=packed)
    keys = list(jax_ckpt.state_to_host(template))
    src = pack_moment_leaves(flat) if packed else flat
    values = [src[k] for k in keys]
    state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), [jnp.asarray(v) for v in values])
    if mesh is not None:
        state = jax_place_state(mesh, jax_pad_state_rows(state, mesh.shape["model"]))
    return template, state


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("save_packed", [False, True])
def test_flat_checkpoint_across_layouts(tmp_path, save_packed, writer):
    cfg, st = _trained_flat(save_packed)
    want = train_state_to_flat(st)
    names = dict(experiment_name="exp", epoch=1, metric_name="loss", metric_value=0.5)
    if writer == "port":
        path = port_ckpt.save_checkpoint(tmp_path, st, **names)
    else:
        path = jax_ckpt.save_checkpoint(tmp_path, _jax_state(_separate(want), save_packed)[1],
                                        **names)
    for load_packed in (False, True):
        fresh = create_train_state(cfg, num_users=ts.NU, num_items=ts.NI, seed=7, device="cpu",
                                   packed_moments=load_packed)
        fresh, _ = port_ckpt.load_checkpoint(path, fresh)
        assert fresh.packed_moments == load_packed
        _assert_same_state(train_state_to_flat(fresh), want)
        # and JAX reads the file into either layout
        template, _ = _jax_state(_separate(want), load_packed)
        restored, _ = jax_ckpt.load_checkpoint(path, template)
        _assert_same_state(
            {k: np.asarray(v) for k, v in jax_ckpt.state_to_host(restored).items()}, want)


@pytest.mark.parametrize("save_packed", [False, True])
def test_sharded_checkpoint_across_layouts(tmp_path, save_packed):
    """One process: the port's sharded directory into the other layout (the
    port and JAX), and JAX's directory, saved from a 2x2 placement, into
    either layout of the port."""
    cfg, st = _trained_flat(save_packed, seed=2)
    want = train_state_to_flat(st)
    names = dict(experiment_name="exp", epoch=1, metric_name=None, metric_value=None)
    port_dir = port_sharded.save_sharded_checkpoint(tmp_path / "port", st, **names)
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=2))
    jax_dir = jax_sharded.save_sharded_checkpoint(
        tmp_path / "jax", _jax_state(_separate(want), save_packed, mesh)[1], **names)
    for load_packed in (False, True):
        for path in (port_dir, jax_dir):
            fresh = create_train_state(cfg, num_users=ts.NU, num_items=ts.NI, seed=7,
                                       device="cpu", packed_moments=load_packed)
            fresh, _ = port_sharded.load_sharded_checkpoint(path, fresh)
            _assert_same_state(train_state_to_flat(fresh), want)
        template, _ = _jax_state(_separate(want), load_packed)
        restored, _ = jax_sharded.load_sharded_checkpoint(port_dir, template)
        _assert_same_state(
            {k: np.asarray(v) for k, v in jax_ckpt.state_to_host(restored).items()}, want)


def _packed_sides():
    """torch_step_setup's JAX and port sides with packed moments (one
    seeded state, as the separate sides)."""
    jx, pt, pos, rng = ts.setup()
    jstate = jax_state.create_train_state(jax.random.key(1), jx.cfg, num_users=ts.NU,
                                          num_items=ts.NI, packed_moments=True)
    pstate = create_train_state(pt.cfg, num_users=ts.NU, num_items=ts.NI, seed=0, device="cpu",
                                packed_moments=True)
    train_state_from_flat(pstate, jax_ckpt.state_to_host(jstate))
    return jx._replace(state=jstate), pt._replace(state=pstate), pos, rng


def test_one_device_packed_steps_equal_separate_and_match_jax():
    jx, pt, pos, rng = _packed_sides()
    losses, want, got = ts.run_steps(jx, pt, pos, rng)
    assert any(k.endswith("/mv") for k in got) and not any(k.endswith("/m") for k in got
                                                            if k.startswith("opt_sparse"))
    ts.assert_steps_match(losses, want, got)
    sep_jx, sep_pt, sep_pos, sep_rng = ts.setup()
    _, _, sep = ts.run_steps(sep_jx, sep_pt, sep_pos, sep_rng)
    _assert_same_state(got, sep)  # bit for bit


# ---------------------------------------------------------------------------
# The mesh: four gloo ranks
# ---------------------------------------------------------------------------

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD, WALL_SECONDS, STEPS, B, M = 4, 240, 2, 7, 5
TSCFG = dict(num_items=ts.NI, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
             lambda_category_alignment=0.01, cal_max_categories=ts.C,
             loss_type="in_batch_softmax", mixed_negatives=M)
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01)
CLIP = {"allgather": None, "owner": 0.5}
# (mesh, routing, wire)
MESH_CASES = {
    "2x2_allgather": ([2, 2], "allgather", "float32"),
    "2x2_owner": ([2, 2], "owner", "float32"),
    "1x4_allgather": ([1, 4], "allgather", "float32"),
    "1x4_owner": ([1, 4], "owner", "float32"),
    "2x2_allgather_bf16_wire": ([2, 2], "allgather", "bfloat16"),
    "2x2_owner_bf16_wire": ([2, 2], "owner", "bfloat16"),
}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_packed_mesh")
    _, pt, pos, rng = ts.setup()
    feats = (pt.data.user_features, pt.data.item_features, pt.data.positive_rows,
             pt.data.category_ids, pt.data.item_log_q)
    inputs = {f"data/{k}": t.numpy() for k, t in zip(
        ("user_features", "item_features", "positive_rows", "category_ids", "item_log_q"), feats)}
    inputs.update({f"state/{k}": a for k, a in train_state_to_flat(pt.state).items()})
    for s in range(STEPS):
        u, p = ts.batch(rng, pos, B)
        inputs.update({f"batches/u{s}": u, f"batches/p{s}": p,
                       f"batches/neg{s}": rng.integers(0, ts.NI, M).astype(np.int32)})
    model_task = dict(model=ts.model_yaml(), feature_dims=[ts.FU, ts.FI], num_users=ts.NU,
                      num_items=ts.NI, kind="train_step", steps=STEPS, log_q=True, opt=OPT,
                      inputs_prefix="batches", state="state")
    tasks = []
    for case, (mesh, routing, wire) in MESH_CASES.items():
        for packed in (False, True):
            tasks.append(dict(
                model_task, name=f"{'packed' if packed else 'separate'}_{case}", mesh=mesh,
                packed_moments=packed,
                tscfg=dict(TSCFG, update_routing=routing, gradient_clip_norm=CLIP[routing],
                           comm_dtype=wire),
            ))

    # sharded checkpoints across the layouts: the ranks save a packed state
    # and read JAX's separate directory into a packed one, and the reverse
    _, st = _trained_flat(False, seed=4)
    trained = train_state_to_flat(st)
    inputs.update({f"trained/{k}": a for k, a in trained.items()})
    jmesh = build_mesh(MeshConfig(2, 2))
    names = dict(experiment_name="jax", epoch=3, metric_name=None, metric_value=None,
                 template="{experiment}_epoch{epoch}")
    for packed in (False, True):
        layout = "packed" if packed else "separate"
        jax_dir = jax_sharded.save_sharded_checkpoint(
            work / f"jax_{layout}", _jax_state(trained, packed, jmesh)[1], **names)
        tasks.append(dict(
            model_task, kind="checkpoint", name=f"checkpoint_save_{'separate' if packed else 'packed'}",
            mesh=[2, 2], state="trained", packed_moments=not packed, load_packed=not packed,
            save_dir=str(work / f"port_{'separate' if packed else 'packed'}"), jax_dir=str(jax_dir),
        ))

    np.savez(work / "inputs.npz", **inputs)
    spec = work / "spec.json"
    spec.write_text(json.dumps({"inputs": str(work / "inputs.npz"), "out": str(work),
                                "tasks": tasks}))
    launch(lambda r: [sys.executable, str(WORKER), str(spec)], WORLD, work, WALL_SECONDS)
    outs = {t["name"]: dict(np.load(work / f"{t['name']}.npz")) for t in tasks}
    return dict(work=work, outs=outs, trained=trained)


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_packed_mesh_step_equals_separate(mesh_run, case):
    sep, packed = (mesh_run["outs"][f"{layout}_{case}"] for layout in ("separate", "packed"))
    np.testing.assert_array_equal(packed.pop("losses"), sep.pop("losses"))
    for extra in ("gather_dtypes", "rank_dense"):
        np.testing.assert_array_equal(packed.pop(extra), sep.pop(extra))
    assert "opt_sparse/user_aug/mv" in packed and "opt_sparse/user_aug/m" in sep
    _assert_same_state(packed, sep)


@pytest.mark.parametrize("saved", ["packed", "separate"])
def test_sharded_checkpoints_cross_layouts_on_the_mesh(mesh_run, saved):
    """The ranks' directory of one layout, read by JAX and by one port
    process into the other; and JAX's directory of the other layout, read
    by the ranks into the saved one: each bit for bit."""
    trained = mesh_run["trained"]
    got = mesh_run["outs"][f"checkpoint_save_{saved}"]
    assert int(got.pop("epoch")) == 3
    _assert_same_state(got, trained)  # JAX's directory, read by the ranks
    port_dir = mesh_run["work"] / f"port_{saved}" / "port_epoch3"
    other = saved == "separate"  # load into the other layout
    template, _ = _jax_state(trained, other)
    restored, meta = jax_sharded.load_sharded_checkpoint(port_dir, template)
    assert meta["num_processes"] == WORLD
    _assert_same_state({k: np.asarray(v) for k, v in jax_ckpt.state_to_host(restored).items()},
                       trained)
    cfg = port_parse(ts.model_yaml(), user_feature_dim=ts.FU, item_feature_dim=ts.FI)
    fresh = create_train_state(cfg, num_users=ts.NU, num_items=ts.NI, seed=1, device="cpu",
                               packed_moments=other)
    fresh, _ = port_sharded.load_sharded_checkpoint(port_dir, fresh)
    _assert_same_state(train_state_to_flat(fresh), trained)
