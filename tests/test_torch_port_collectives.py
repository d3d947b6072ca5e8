"""The port's wire inspection (``ttamm_torch/parallel/collective_inspect.py``)
held to the JAX package's communication-pattern properties
(``tests/test_hlo_collectives.py``), at that file's shapes: ``B, NEG, F, D =
64, 3, 16, 64``, hidden ``[32]``, gated towers, cosine, mimic on (dense
mimic tables), a 2x4 mesh. Eight gloo ranks (tests/torch_parallel_worker.py,
``collectives`` tasks) start once for the module; each task records one
sharded step (or the eval's encode and search) of a seeded state on every
rank, and rank 0 writes its record. Byte counts are integers, so every
comparison is exact:

(a) no collective moves >= 10% of a table at 8,192 rows: allgather, owner,
    tensor-parallel and all-to-all steps;
(b) ``collective_summary`` is the same at 4,096 and 16,384 rows (allgather,
    all-to-all, owner): the traffic is batch-shaped and the table-shaped
    moments never leave their shard;
(c) tensor parallelism adds only batch-sized all-reduces over ``model``
    and no more bytes than it adds to the JAX package's compiled step at
    these shapes (74,176 B: JAX 750,620 -> 824,796 B, 1.099x; the port
    448,284 -> 522,460 B, 1.166x, its base being leaner, so the JAX test's
    1.10x ratio is not the port's bound);
(d) the sharded eval (the item corpus encode, two masked user-batch
    searches) moves nothing >= a tenth of the [N, D] corpus slab;
(e) ``comm_dtype: bfloat16`` puts bf16 on the row-gradient all-gathers
    over ``data``: none at float32, at least two at bf16;
(f) the owner routing's hot branch gathers the item gradients at the width
    of JAX's ``owner_capacity`` (``[64, 64]`` in, ``[128, 64]`` out): the
    allgather routing's full-width sparse-update gathers are gone from it,
    the overflow flag's all-reduces over the whole mesh are added;
    ``owner_unchecked`` has neither the flag nor an overflow branch; a
    forced overflow (capacity factor 1e-4) issues the full-width gathers,
    tagged ``branch="overflow"``;
(g) a step under ``record_collectives`` equals the step without it bit for
    bit, and the mesh's primitives are the plain ones after the record;
(h) ``wire_bytes_per_device`` equals the JAX script's ``wire_bytes_per_chip``
    (``scripts/predict_scaling.py``, loaded with importlib);
and every rank records the same ops, axes, dtypes, shapes and branches;
the record holds every ``torch.distributed`` collective the step called,
and no module of the port but ``parallel/mesh.py`` names one.
"""

import collections
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_ranks import launch
from ttamm_torch.parallel.collective_inspect import (
    CollectiveOp,
    assert_no_table_sized_collectives,
    collective_summary,
    oversized_collectives,
    wire_bytes_per_device,
)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD, WALL_SECONDS = 8, 300
B, NEG, F, D = 64, 3, 16, 64
DP, MP = 2, 4
TOWER = {
    "type": "tower",
    "id_embedding": {"params": {"embedding_dim": D, "sparse": True}},
    "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": D},
    "fusion": "gated",
}
MODEL = {"user_encoder": TOWER, "item_encoder": TOWER, "similarity": "cosine",
         "adaptive_mimic": {"enabled": True}}
TSCFG = dict(negatives_per_positive=NEG, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
             lambda_category_alignment=0.01, cal_max_categories=4)
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.01)
TABLES = ("user_id", "item_id", "user_aug", "item_aug")
CASES = {  # name: (rows, step config changes, task changes)
    "allgather_8192": (8192, {}, {}),
    "owner_8192": (8192, {"update_routing": "owner"}, {}),
    "tp_8192": (8192, {}, {"tensor_parallel": True}),
    "alltoall_8192": (8192, {"embedding_exchange": "alltoall"}, {}),
    "bf16_8192": (8192, {"comm_dtype": "bfloat16"}, {}),
    "allgather_4096": (4096, {}, {"unrecorded": True}),
    "allgather_16384": (16384, {}, {}),
    "alltoall_4096": (4096, {"embedding_exchange": "alltoall"}, {}),
    "alltoall_16384": (16384, {"embedding_exchange": "alltoall"}, {}),
    "owner_4096": (4096, {"update_routing": "owner"}, {"unrecorded": True}),
    "owner_16384": (16384, {"update_routing": "owner"}, {}),
    "unchecked_4096": (4096, {"update_routing": "owner_unchecked"}, {}),
    "overflow_4096": (4096, {"update_routing": "owner", "update_capacity_factor": 1e-4}, {}),
    "eval_4096": (4096, {}, {"eval": True}),
}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Every case's record: ``{name: [CollectiveOp, ...]}`` rank 0's, and
    the worker's arrays (``ranks_agree``, the (g) state leaves)."""
    work = tmp_path_factory.mktemp("torch_collectives")
    tasks = [dict(kind="collectives", name=name, mesh=[DP, MP], model=MODEL, features=F, batch=B,
                  rows=rows, opt=OPT, tscfg=dict(TSCFG, **changes), **extra)
             for name, (rows, changes, extra) in CASES.items()]
    np.savez(work / "inputs.npz", unused=np.zeros(1))
    spec = work / "spec.json"
    spec.write_text(json.dumps({"inputs": str(work / "inputs.npz"), "out": str(work),
                                "tasks": tasks}))
    launch(lambda r: [sys.executable, str(WORKER), str(spec)], WORLD, work, WALL_SECONDS)
    outs = {t["name"]: dict(np.load(work / f"{t['name']}.npz")) for t in tasks}
    records = {name: [_op(row) for row in out["records"]] for name, out in outs.items()}
    return {"records": records, "outs": outs}


def _op(row) -> CollectiveOp:
    op, axis, dtype, shape, branch, nbytes, group = (str(x) for x in row)
    return CollectiveOp(op=op, shape=tuple(int(d) for d in shape.split("x") if d),
                        bytes=int(nbytes), group_size=int(group), axis=axis, dtype=dtype,
                        branch=branch or None)


def _tables(rows):
    return {name: (rows, D) for name in TABLES}


def _key(c: CollectiveOp):
    return (c.op, c.axis, c.dtype, c.shape, c.branch)


def _total(records) -> int:
    return sum(v["bytes"] for v in collective_summary(records).values())


def test_every_rank_records_the_same_collectives(recorded):
    for name, out in recorded["outs"].items():
        assert bool(out["ranks_agree"]), name
        assert recorded["records"][name], name


def test_record_holds_every_torch_distributed_collective(recorded):
    """The worker counts the ``torch.distributed`` collectives each recorded
    block called, whoever called them: one a recorded entry, so no
    collective of the step or the eval bypasses ``parallel/mesh.py``."""
    for name, out in recorded["outs"].items():
        assert int(out["dist_calls"]) == len(recorded["records"][name]), name


_COLLECTIVE_CALL = re.compile(
    r"\b(?:dist|torch\.distributed)\.(?:all_reduce\w*|all_gather\w*|all_to_all\w*|broadcast\w*|"
    r"reduce\w*|gather\w*|scatter\w*|send|recv|isend|irecv|batch_isend_irecv)\s*\(|"
    r"_functional_collectives|torch\.distributed\.tensor|"
    r"from\s+torch\.distributed\s+import\s+[^\n]*\b(?:all_\w+|reduce\w*|broadcast\w*|gather|scatter)\b")


def test_no_collective_outside_mesh_module():
    """Every collective of the port is issued by ``parallel/mesh.py`` (the
    record's one place); the source names none elsewhere, functional
    collectives and DTensor included."""
    package = REPO / "ttamm_torch"
    found = [f"{path.relative_to(REPO)}:{n}: {line.strip()}"
             for path in sorted(package.rglob("*.py")) if path != package / "parallel" / "mesh.py"
             for n, line in enumerate(path.read_text().splitlines(), 1)
             if _COLLECTIVE_CALL.search(line)]
    assert not found, found
    assert _COLLECTIVE_CALL.search((package / "parallel" / "mesh.py").read_text())


@pytest.mark.parametrize("name", ["allgather_8192", "owner_8192", "tp_8192", "alltoall_8192"])
def test_no_table_sized_collectives(recorded, name):
    """(a): the step's largest collective is batch-sized, far below a
    tenth of a table (a table, or a shard of one, on the wire fails here)."""
    records = recorded["records"][name]
    assert_no_table_sized_collectives(records, _tables(8192), fraction=0.1)
    assert max(c.bytes for c in records) < 0.1 * 8192 * D * 4


@pytest.mark.parametrize("kind", ["allgather", "alltoall", "owner"])
def test_collective_bytes_independent_of_table_rows(recorded, kind):
    """(b): tables 4x larger at the same batch: the same collectives, the
    same bytes, op for op."""
    small, large = (recorded["records"][f"{kind}_{rows}"] for rows in (4096, 16384))
    assert collective_summary(small) == collective_summary(large)
    assert [_key(c) for c in small] == [_key(c) for c in large]


def _jax_tp_increment() -> int:
    """The bytes tensor parallelism adds to the JAX package's compiled
    sharded step at these shapes (its ``test_hlo_collectives`` helper)."""
    from test_hlo_collectives import _compiled_step_hlo
    from ttamm_tpu.parallel.hlo_inspect import collective_summary as jax_summary

    totals = [sum(v["bytes"] for v in jax_summary(_compiled_step_hlo(8192, tensor_parallel=tp))
                  .values()) for tp in (False, True)]
    return totals[1] - totals[0]


def test_tensor_parallel_collectives_stay_batch_sized(recorded):
    """(c): what TP adds over ``model`` is batch-sized all-reduces (Megatron
    g on the row layers' ``[n, D]`` outputs, f's backward on the gate's
    ``[n, 2D]`` input), and its byte increment is no more than the JAX
    package's TP adds; the sum over ``data`` of the dense gradients shrinks."""
    tp, base = recorded["records"]["tp_8192"], recorded["records"]["allgather_8192"]
    added = collections.Counter(map(_key, tp)) - collections.Counter(map(_key, base))
    users, items = B // DP, B // DP * (1 + NEG)
    for op, axis, dtype, shape, branch in added.elements():
        if axis == "model":
            assert (op, dtype, branch) == ("all-reduce", "float32", None), shape
            assert shape in {(users, D), (items, D), (users, 2 * D), (items, 2 * D)}, shape
        else:  # the split leaves' 1/s of the dense gradients' sum
            assert (op, axis, len(shape)) == ("all-reduce", "data", 1), (op, axis, shape)
    dense = [c.bytes for c in base if c.op == "all-reduce" and c.axis == "data" and len(c.shape) == 1]
    tp_dense = [c.bytes for c in tp if c.op == "all-reduce" and c.axis == "data" and len(c.shape) == 1]
    assert sum(tp_dense) < sum(dense)
    assert _total(tp) - _total(base) <= _jax_tp_increment(), (_total(tp), _total(base))


def test_mesh_eval_moves_no_corpus_sized_tensor(recorded):
    """(d): the eval's collectives are ``[B, *]``-sized (the feature and
    table rows summed over ``model``, the shards' top-k gathered)."""
    records = recorded["records"]["eval_4096"]
    slab = 4096 * D * 4
    assert not oversized_collectives(records, slab // 10), [str(c) for c in records]
    assert {c.op for c in records} == {"all-reduce", "all-gather"}


def _bf16_gathers(records) -> int:
    return sum(1 for c in records if c.op == "all-gather" and c.axis == "data" and c.dtype == "bfloat16")


def test_comm_bf16_puts_bf16_on_row_gradient_gathers(recorded):
    """(e): the sparse update's and the dense mimic tables' row-gradient
    gathers over ``data`` cross in bf16 (none at float32)."""
    assert _bf16_gathers(recorded["records"]["allgather_8192"]) == 0
    bf16 = recorded["records"]["bf16_8192"]
    assert _bf16_gathers(bf16) >= 2
    assert not [c for c in bf16 if c.op == "all-gather" and c.axis == "data" and c.dtype == "float32"]


def test_owner_routing_gathers_at_capacity_width(recorded):
    """(f), at 4,096 rows."""
    from ttamm_tpu.parallel.sparse_update import owner_capacity as jax_owner_capacity

    rec = recorded["records"]
    item_lanes, user_lanes = B * (1 + NEG), B
    cap_items = jax_owner_capacity(item_lanes, DP, MP, 2.0)
    cap_users = jax_owner_capacity(user_lanes, DP, MP, 2.0)
    assert cap_items == 64  # [64, 64] in, as the JAX test reads it

    def pair(n, branch=None):
        return [("all-gather", "data", "int64", (n,), branch),
                ("all-gather", "data", "float32", (n, D), branch)]

    full = pair(item_lanes) + pair(user_lanes)
    hot = pair(DP * cap_items) + pair(DP * cap_users)
    flags = [("all-reduce", "world", "int32", (1,), None)] * 2
    allgather, owner = (collections.Counter(map(_key, rec[n])) for n in ("allgather_4096", "owner_4096"))
    assert owner - allgather == collections.Counter(hot + flags)
    assert allgather - owner == collections.Counter(full)
    assert not any(c.branch for c in rec["owner_4096"])  # no overflow on the CPU at factor 2
    # owner_unchecked: the hot gathers, no flag, no overflow branch
    unchecked = collections.Counter(map(_key, rec["unchecked_4096"]))
    assert unchecked == owner - collections.Counter(flags)
    # a forced overflow: both tables take the full-width gathers, tagged
    overflow = rec["overflow_4096"]
    tagged = collections.Counter(_key(c) for c in overflow if c.branch == "overflow")
    assert tagged == collections.Counter(pair(item_lanes, "overflow") + pair(user_lanes, "overflow"))
    untagged = collections.Counter(_key(c) for c in overflow if c.branch is None)
    assert untagged == allgather - collections.Counter(full) + collections.Counter(flags)


@pytest.mark.parametrize("name", ["allgather_4096", "owner_4096"])
def test_record_leaves_the_step_unchanged(recorded, name):
    """(g)."""
    out = recorded["outs"][name]
    assert bool(out["restored"])
    keys = sorted(k.removeprefix("recorded/") for k in out if k.startswith("recorded/"))
    assert keys and keys == sorted(k.removeprefix("unrecorded/") for k in out
                                   if k.startswith("unrecorded/"))
    for k in keys:
        np.testing.assert_array_equal(out[f"recorded/{k}"], out[f"unrecorded/{k}"], err_msg=k)


def test_wire_bytes_match_the_jax_ring_model():
    """(h)."""
    spec = importlib.util.spec_from_file_location("jax_predict_scaling",
                                                  REPO / "scripts" / "predict_scaling.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    ops = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "ragged-all-to-all",
           "collective-permute", "send")
    for op in ops:
        for nbytes in (0, 4, 65536, 12_582_912, 10**9 + 7):
            for n in (None, 0, 1, 2, 3, 4, 8):
                assert wire_bytes_per_device(op, nbytes, n) == jax_script.wire_bytes_per_chip(
                    op, nbytes, n), (op, nbytes, n)

