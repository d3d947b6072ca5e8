"""One rank of the port's CPU mesh (gloo) for the parallel parity tests.

    python tests/torch_parallel_worker.py SPEC

with torchrun's variables set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``; tests/torch_ranks.py sets them).

``SPEC`` is a JSON file: ``{"inputs": <npz>, "out": <dir>, "tasks": [...]}``.
Each task runs collectively on every rank and rank 0 writes its arrays to
``<out>/<task name>.npz``. The worker imports torch and the port only: no
JAX, nothing of the test modules.
"""

from __future__ import annotations

import contextlib
import copy
import json
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ttamm_torch.models import parse_model_config  # noqa: E402
from ttamm_torch.models.convert import train_state_from_flat  # noqa: E402
from ttamm_torch.ops import kernels, topk  # noqa: E402
from ttamm_torch.ops.sparse_adam import SparseAdamState  # noqa: E402
from ttamm_torch.parallel import (  # noqa: E402
    DATA_AXIS,
    MODEL_AXIS,
    MeshConfig,
    build_mesh,
    gather_state_flat,
    pad_batch_data,
    pad_state_rows,
    padded_rows,
    place_data,
    place_state,
)
from ttamm_torch.parallel import exchange  # noqa: E402
from ttamm_torch.parallel.collective_inspect import record_collectives  # noqa: E402
from ttamm_torch.parallel import sparse_update as sparse_update_module  # noqa: E402
from ttamm_torch.parallel.embedding_lookup import sharded_rows  # noqa: E402
from ttamm_torch.parallel.mesh import all_gather_rows, axis_index  # noqa: E402
from ttamm_torch.parallel.sparse_update import sharded_sparse_adam_update  # noqa: E402
from ttamm_torch.parallel.step import (  # noqa: E402
    make_sharded_multi_eval_loss_step,
    make_sharded_multi_train_step,
    make_sharded_topk,
    make_sharded_train_step,
)
from ttamm_torch.pipelines import training as training_module  # noqa: E402
from ttamm_torch.pipelines.training import dropout_generator, run_single_experiment  # noqa: E402
from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state  # noqa: E402
from ttamm_torch.train.optim import DenseOptConfig  # noqa: E402
from ttamm_torch.train.checkpoint import AsyncCheckpointer, save_checkpoint  # noqa: E402
from ttamm_torch.train.step import make_eval_loss_step  # noqa: E402
from ttamm_torch.train.sharded_checkpoint import (  # noqa: E402
    load_sharded_checkpoint,
    save_sharded_checkpoint,
)

TIMEOUT_SECONDS = 120


def _mesh(task):
    return build_mesh(MeshConfig(*task["mesh"]), "cpu")


def _t(inputs, key):
    return torch.from_numpy(np.array(inputs[key]))


def _slice(mesh, t):
    rows = t.shape[0] // mesh[MODEL_AXIS].size()
    start = axis_index(mesh, MODEL_AXIS) * rows
    return t[start : start + rows].clone()


def sparse_update(task, inputs):
    """The update of one table shard; besides the shards, every rank's
    ``sparse_adam_rows`` lanes (``lanes`` [world, L] shard-local, ``bases``
    [world] the shards' first global rows, ``calls`` the launches a rank).
    ``task["wire"]``: the dtype the row gradients arrive in (bfloat16 under
    ``comm_dtype``; the inputs hold values it represents exactly)."""
    mesh = _mesh(task)
    name = task["name"]
    table, m, v = (_slice(mesh, _t(inputs, f"{name}/{k}")) for k in ("table", "m", "v"))
    state = SparseAdamState(m=m, v=v, step=task["step"])
    idx, grads = _t(inputs, f"{name}/idx"), _t(inputs, f"{name}/grads")
    grads = grads.to(getattr(torch, task.get("wire", "float32")))
    dp = mesh[DATA_AXIS].size()
    chunk = idx.shape[0] // dp
    lo = axis_index(mesh, DATA_AXIS) * chunk
    lanes, fused = [], kernels.sparse_adam_rows

    def spy(table, m, v, lane_idx, grads, **hyper):
        lanes.append(lane_idx.clone())
        fused(table, m, v, lane_idx, grads, **hyper)

    kernels.sparse_adam_rows = spy
    try:
        overflow = sharded_sparse_adam_update(
            mesh, table, state, idx[lo : lo + chunk], grads[lo : lo + chunk], lr=task["lr"],
            routing=task["routing"], capacity_factor=task["capacity_factor"],
        )
    finally:
        kernels.sparse_adam_rows = fused
    out = {k: all_gather_rows(t, mesh, MODEL_AXIS).numpy() for k, t in
           (("table", table), ("m", state.m), ("v", state.v))}
    world = dist.get_world_size()
    mine = torch.cat(lanes) if lanes else torch.zeros(0, dtype=torch.int32)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    own = torch.tensor([axis_index(mesh, MODEL_AXIS) * table.shape[0], len(lanes)])
    meta = [torch.empty_like(own) for _ in range(world)]
    dist.all_gather(meta, own)
    meta = torch.stack(meta).numpy()
    # the owner routing's device flag (None under the others), read here
    overflow = overflow is not None and bool(overflow.reshape(-1)[0])
    return dict(out, overflow=np.asarray(overflow), step=np.asarray(state.step),
                lanes=torch.stack(every).numpy(), bases=meta[:, 0], calls=meta[:, 1])


def _model(task, inputs):
    """The config and the state ``task["state"]`` of the inputs, its sparse
    moments in the layout ``task["packed_moments"]`` asks for."""
    cfg = parse_model_config(
        task["model"], user_feature_dim=task["feature_dims"][0],
        item_feature_dim=task["feature_dims"][1],
    )
    state = create_train_state(
        cfg, num_users=task["num_users"], num_items=task["num_items"], seed=0, device="cpu",
        packed_moments=task.get("packed_moments", False),
    )
    prefix = task["state"] + "/"
    flat = {k[len(prefix):]: inputs[k] for k in inputs.files if k.startswith(prefix)}
    return cfg, train_state_from_flat(state, flat)


@contextlib.contextmanager
def _draw_spy(draws: list):
    """Record every ``torch.rand`` tensor drawn while it is active (the
    dropout masks' uniforms: the steps are given their negatives)."""
    rand = torch.rand

    def spy(*args, **kwargs):
        out = rand(*args, **kwargs)
        draws.append(out.clone())
        return out

    torch.rand = spy
    try:
        yield
    finally:
        torch.rand = rand


# every collective torch.distributed offers (barrier and the object
# collectives aside: they carry no step data)
_DIST_COLLECTIVES = ("all_reduce", "all_reduce_coalesced", "all_gather", "all_gather_into_tensor",
                     "all_gather_coalesced", "all_to_all", "all_to_all_single", "broadcast",
                     "reduce", "reduce_scatter", "reduce_scatter_tensor", "gather", "scatter",
                     "send", "recv", "isend", "irecv", "batch_isend_irecv")


@contextlib.contextmanager
def _dist_calls(calls: list):
    """Append the name of every ``torch.distributed`` collective called
    while it is active, whoever calls it: what a record of
    ``parallel/mesh.py``'s primitives must match, call for call."""
    originals = {n: getattr(dist, n) for n in _DIST_COLLECTIVES if hasattr(dist, n)}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return counted

    for n, fn in originals.items():
        setattr(dist, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in originals.items():
            setattr(dist, n, fn)


def _input_shape(c) -> str:
    """The shape a rank passed to a recorded collective, as ``AxB`` (an
    all-gather's result holds the group's inputs along dim 0)."""
    shape = list(c.shape)
    if c.op == "all-gather":
        shape[0] //= c.group_size
    return "x".join(map(str, shape))


def train_step(task, inputs):
    """``task["steps"]`` sharded steps, with ``task["tensor_parallel"]`` on a
    tensor-parallel placement; with ``task["spy"]``, also the dtype of every
    floating tensor all-gathered over ``data`` (``gather_dtypes``, one string
    a call, from ``record_collectives``); with ``task["collectives"]`` every
    collective of the first step (``collectives`` [n, 4]: op, axis, the
    shape a rank passed, dtype) and the number of ``torch.distributed``
    collectives called in it (``dist_calls``); with ``task["dropout"]`` the
    masks' uniforms each rank drew (``draws`` [world, n], ``draw_shapes``);
    with ``task["first_moments"]`` the dense first moments after the first
    step (``step1/opt_dense/m/...``, gathered whole: (1 - b1) times that
    step's dense gradients)."""
    mesh = _mesh(task)
    mp = mesh[MODEL_AXIS].size()
    tp = task.get("tensor_parallel", False)
    cfg, state = _model(task, inputs)
    features = getattr(torch, task.get("features_dtype", "float32"))
    data = BatchData(
        _t(inputs, "data/user_features").to(features), _t(inputs, "data/item_features").to(features),
        *(_t(inputs, f"data/{k}") for k in ("positive_rows", "category_ids")),
        item_log_q=_t(inputs, "data/item_log_q") if task.get("log_q") else None)
    state = place_state(mesh, pad_state_rows(state, mp), tensor_parallel=tp)
    data = place_data(mesh, pad_batch_data(data, mp))
    tscfg = TrainStepConfig(**dict(task["tscfg"], opt=DenseOptConfig(**task["opt"])))
    step = make_sharded_train_step(cfg, tscfg, mesh)
    prefix, losses, dtypes, first = task.get("inputs_prefix", task["name"]), [], [], {}
    collectives, draws, dist_calls = [], [], -1
    # with task["dropout"], the trainer's dropout stream of this rank
    drop = dropout_generator(3, mesh, torch.device("cpu")) if task.get("dropout") else None
    if drop is not None:
        state.model.train()
    for s in range(task["steps"]):
        spies = contextlib.ExitStack()
        records, calls = [], []
        if task.get("spy") or (task.get("collectives") and s == 0):
            records = spies.enter_context(record_collectives(mesh))
            spies.enter_context(_dist_calls(calls))
        if drop is not None:
            spies.enter_context(_draw_spy(draws))
        with spies:
            state, metrics = step(
                state, data, _t(inputs, f"{prefix}/u{s}"), _t(inputs, f"{prefix}/p{s}"),
                generator=None, negatives=_t(inputs, f"{prefix}/neg{s}"), dropout_generator=drop,
            )
        if task.get("spy"):
            dtypes += [c.dtype for c in records if c.op == "all-gather" and c.axis == DATA_AXIS
                       and c.dtype.startswith(("float", "bfloat"))]
        if task.get("collectives") and s == 0:
            collectives = [(c.op, c.axis, _input_shape(c), c.dtype) for c in records]
            dist_calls = len(calls)
        losses.append([float(metrics[k]) for k in sorted(metrics)])
        if task.get("first_moments") and s == 0:
            # copies: a replicated leaf's array is a view of the live
            # moment, which the next step updates in place
            first = {f"step1/{k}": v.copy() for k, v in gather_state_flat(state, mesh).items()
                     if k.startswith("opt_dense/m/")}
    # every rank's dense parameters (its slices under tensor parallelism),
    # to hold them equal
    dense = torch.cat([p.detach().reshape(-1) for _, p in state.model.dense_parameters()])
    ranks = [torch.empty_like(dense) for _ in range(dist.get_world_size())]
    dist.all_gather(ranks, dense)
    out = dict(gather_state_flat(state, mesh), losses=np.asarray(losses),
               gather_dtypes=np.asarray(dtypes, dtype=str), rank_dense=torch.stack(ranks).numpy(),
               collectives=np.asarray(collectives, dtype=str).reshape(-1, 4),
               dist_calls=np.asarray(dist_calls), **first)
    if draws:
        mine = torch.cat([d.reshape(-1) for d in draws])
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        out.update(draws=torch.stack(every).numpy(),
                   draw_shapes=np.asarray([list(d.shape) for d in draws]))
    return out


def _data_part(mesh, t):
    """This data shard's equal part of ``t``'s rows."""
    rows = t.shape[0] // mesh[DATA_AXIS].size()
    start = axis_index(mesh, DATA_AXIS) * rows
    return t[start : start + rows]


def exchange_lookup(task, inputs):
    """The exchange's rows of ``exchange/table`` at ``exchange/ids`` (each
    data shard its equal part of them) by both variants, gathered to the
    whole batch, and the table gradient of ``sum(rows * exchange/cot)``
    (dense variant), gathered over ``model``."""
    mesh = _mesh(task)
    table = _t(inputs, "exchange/table")
    local = _slice(mesh, table)
    ids = _data_part(mesh, _t(inputs, task["ids"]))
    out = {}
    for variant in exchange.VARIANTS:
        rows = exchange.exchange_rows(local, ids, mesh, variant=variant)
        out[variant] = all_gather_rows(rows, mesh, DATA_AXIS).numpy()
    leaf = local.clone().requires_grad_()
    rows = exchange.exchange_lookup(leaf, ids, mesh)
    torch.sum(rows * _data_part(mesh, _t(inputs, "exchange/cot"))).backward()
    out["grad"] = all_gather_rows(leaf.grad, mesh, MODEL_AXIS).numpy()
    return out


def feature_rows(task, inputs):
    """bf16 feature rows through ``sharded_rows`` against ``index_select`` of
    the whole bf16 matrix, both as int16 bit patterns."""
    mesh = _mesh(task)
    mp = mesh[MODEL_AXIS].size()
    full = _t(inputs, "data/user_features").to(torch.bfloat16)
    full[3] = -0.0  # an owner's -0.0 comes back +0.0 from the sum over model
    padded = pad_batch_data(BatchData(full, full, None, None), mp).user_features
    ids = _t(inputs, "exchange/ids") % full.shape[0]
    ids[0] = 3
    got = sharded_rows(_slice(mesh, padded), ids, mesh)
    return {"got": got.view(torch.int16).numpy(),
            "want": torch.index_select(full, 0, ids.long()).view(torch.int16).numpy()}


def search(task, inputs):
    """The sharded search; with ``task["ceiling_items"]`` the slab ceiling
    lowered to that many items and the score budget to ``chunk_size``
    float32 columns of the queries, and the chunk scans of every rank
    counted (``chunked``, one a rank) with the chunk each took."""
    mesh = _mesh(task)
    mp = mesh[MODEL_AXIS].size()
    prefix = task.get("inputs_prefix", "search")
    items = _t(inputs, f"{prefix}/items")
    n = items.shape[0]
    padded = torch.cat([items, items.new_zeros(padded_rows(n, mp) - n, items.shape[1])])
    queries = _t(inputs, f"{prefix}/queries")
    chunked, scan = [], topk._chunked_topk
    if "ceiling_items" in task:
        topk.SCORES_BYTES_CEILING = 64 * 4 * task["ceiling_items"]
        topk.SCORES_BYTES_BUDGET = 4 * queries.shape[0] * task["chunk_size"]
        topk._chunked_topk = (
            lambda *a, **k: chunked.append(topk.chunk_items(a[0].shape[0])) or scan(*a, **k)
        )
    try:
        search = make_sharded_topk(mesh, k=task["k"], num_valid_rows=n,
                                   score_dtype=task["score_dtype"])
        scores, ids = search(
            queries, _slice(mesh, padded),
            mask_rows=_t(inputs, f"{prefix}/mask") if task["masked"] else None,
        )
    finally:
        topk._chunked_topk = scan
    mine = torch.tensor([len(chunked)])
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return {"scores": scores.numpy(), "ids": ids.numpy(), "chunked": torch.cat(every).numpy(),
            "chunk_sizes": np.asarray(sorted(set(chunked)))}


def checkpoint(task, inputs):
    """The state placed (``task["tensor_parallel"]``: with tensor
    parallelism) and saved as a sharded directory, and (``task["flat"]``)
    gathered and saved flat by rank 0; then JAX's directory read into a
    fresh placement (``task["load_tensor_parallel"]``, default as saved)
    and, with ``task["reload"]``, the ranks' own directory into the other
    placement (``reloaded/`` keys)."""
    mesh = _mesh(task)
    mp = mesh[MODEL_AXIS].size()
    _, state = _model(task, inputs)
    tp = task.get("tensor_parallel", False)

    def fresh(tensor_parallel):
        return place_state(mesh, pad_state_rows(create_train_state(
            state.model.cfg, num_users=state.model.num_users, num_items=state.model.num_items,
            seed=5, device="cpu", packed_moments=task.get("load_packed", False),
        ), mp), tensor_parallel=tensor_parallel)

    placed = place_state(mesh, pad_state_rows(state, mp), tensor_parallel=tp)
    names = dict(experiment_name="port", epoch=3, metric_name="recall@10", metric_value=0.25,
                 template="{experiment}_epoch{epoch}")
    saved = save_sharded_checkpoint(task["save_dir"], placed, mesh=mesh, **names)
    if task.get("flat"):
        flat = gather_state_flat(placed, mesh)
        if dist.get_rank() == 0:
            save_checkpoint(Path(task["save_dir"]) / "flat", flat, **names)
    loaded, meta = load_sharded_checkpoint(
        task["jax_dir"], fresh(task.get("load_tensor_parallel", tp)), mesh)
    out = dict(gather_state_flat(loaded, mesh), epoch=np.asarray(meta["epoch"]))
    if task.get("reload"):
        dist.barrier()  # every rank's shard file written
        back, _ = load_sharded_checkpoint(saved, fresh(not tp), mesh)
        out.update({f"reloaded/{k}": v for k, v in gather_state_flat(back, mesh).items()})
    return out


def multi_step(task, inputs):
    """K steps of the placed state two ways: K calls of
    ``make_sharded_train_step`` and one ``make_sharded_multi_train_step``
    call on the batches ``{prefix}/u``, ``{prefix}/p`` [K, B], the negatives
    (or the pool) drawn from a generator seeded ``task["seed"]`` on every
    rank and, with ``task["dropout"]``, dropout from the trainer's stream of
    this rank; then the eval loss of the same batches by single steps and by
    ``make_sharded_multi_eval_loss_step``. Returns each way's state
    (``single/...``, ``multi/...``), losses, host counts, generator states
    (the dropout stream's of every rank) and eval losses, and the owner
    routing's device counters over both (``owner_stats``: checks,
    overflows)."""
    mesh = _mesh(task)
    mp = mesh[MODEL_AXIS].size()
    cfg, state = _model(task, inputs)
    data = BatchData(
        _t(inputs, "data/user_features"), _t(inputs, "data/item_features"),
        *(_t(inputs, f"data/{k}") for k in ("positive_rows", "category_ids")),
        item_log_q=_t(inputs, "data/item_log_q") if task.get("log_q") else None)
    state = place_state(mesh, pad_state_rows(state, mp),
                        tensor_parallel=task.get("tensor_parallel", False))
    data = place_data(mesh, pad_batch_data(data, mp))
    tscfg = TrainStepConfig(**dict(task["tscfg"], opt=DenseOptConfig(**task["opt"])))
    u_all, p_all = _t(inputs, f"{task['inputs_prefix']}/u"), _t(inputs, f"{task['inputs_prefix']}/p")
    single = make_sharded_train_step(cfg, tscfg, mesh)
    multi = make_sharded_multi_train_step(cfg, tscfg, mesh)
    sparse_update_module.reset_owner_stats()
    out = {}
    for way in ("single", "multi"):
        st = copy.deepcopy(state)
        gen = torch.Generator().manual_seed(task["seed"])
        drop = dropout_generator(3, mesh, torch.device("cpu")) if task.get("dropout") else None
        if drop is not None:
            st.model.train()
        if way == "single":
            losses = torch.stack([
                single(st, data, u_all[k], p_all[k], generator=gen, dropout_generator=drop)[1]["loss"]
                for k in range(u_all.shape[0])])
        else:
            st, losses = multi(st, data, u_all, p_all, generator=gen, dropout_generator=drop)
        out.update({f"{way}/{k}": v for k, v in gather_state_flat(st, mesh).items()})
        out[f"{way}/losses"] = losses.numpy()
        out[f"{way}/counts"] = np.asarray(
            [st.step, st.opt_dense.step, *(s.step for s in st.opt_sparse.values())])
        out[f"{way}/generator"] = gen.get_state().numpy()
        if drop is not None:
            mine = drop.get_state()
            every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
            dist.all_gather(every, mine)
            out[f"{way}/dropout_generators"] = torch.stack(every).numpy()
        st.model.eval()
        gen.manual_seed(task["seed"] + 1)
        if way == "single":
            step = make_eval_loss_step(cfg, tscfg, mesh=mesh)
            evals = torch.stack([step(st, data, u_all[k], p_all[k], generator=gen)
                                 for k in range(u_all.shape[0])])
        else:
            evals = make_sharded_multi_eval_loss_step(cfg, tscfg, mesh)(
                st, data, u_all, p_all, generator=gen)
        out[f"{way}/eval_losses"] = evals.numpy()
    stats = sparse_update_module.owner_stats()
    out["owner_stats"] = np.asarray([stats["checks"], stats["overflows"]])
    return out


def owner_overflow(task, inputs):
    """One update of the sparse-update inputs ``task["inputs_prefix"]`` under
    each routing of ``task["runs"]`` ([name, routing, capacity factor]),
    every run from the same shards, with the owner routing's device counters
    counted from zero for each: ``{name}/table`` ... and ``{name}/stats``
    (checks, overflows), and ``{name}/flag`` the flag it returned (-1 for
    None)."""
    mesh = _mesh(task)
    prefix = task["inputs_prefix"]
    idx, grads = _t(inputs, f"{prefix}/idx"), _t(inputs, f"{prefix}/grads")
    dp = mesh[DATA_AXIS].size()
    chunk = idx.shape[0] // dp
    lo = axis_index(mesh, DATA_AXIS) * chunk
    out = {}
    for name, routing, factor in task["runs"]:
        table, m, v = (_slice(mesh, _t(inputs, f"{prefix}/{k}")) for k in ("table", "m", "v"))
        state = SparseAdamState(m=m, v=v, step=2)
        sparse_update_module.reset_owner_stats()
        flag = sharded_sparse_adam_update(
            mesh, table, state, idx[lo : lo + chunk], grads[lo : lo + chunk], lr=task["lr"],
            routing=routing, capacity_factor=factor)
        stats = sparse_update_module.owner_stats()
        out.update({f"{name}/{k}": all_gather_rows(t, mesh, MODEL_AXIS).numpy()
                    for k, t in (("table", table), ("m", state.m), ("v", state.v))})
        out[f"{name}/stats"] = np.asarray([stats["checks"], stats["overflows"]])
        out[f"{name}/flag"] = np.asarray(-1 if flag is None else int(flag.reshape(-1)[0]))
    return out


def train_run(task, inputs):
    """``run_single_experiment`` of ``task["config"]`` on the CPU mesh (the
    process group is this worker's); the losses, the checkpoint paths and
    the steps run through ``make_sharded_multi_train_step``
    (``multi_steps``)."""
    steps, build = [], training_module.make_sharded_multi_train_step

    def counted(*args, **kwargs):
        multi = build(*args, **kwargs)

        def run(state, data, u_all, *rest, **kw):
            steps.append(u_all.shape[0])
            return multi(state, data, u_all, *rest, **kw)

        return run

    training_module.make_sharded_multi_train_step = counted
    try:
        result = run_single_experiment(task["config"], device="cpu")
    finally:
        training_module.make_sharded_multi_train_step = build
    return {"multi_steps": np.asarray(sum(steps)),
            "train_loss": np.asarray(result.train_loss), "val_loss": np.asarray(result.val_loss),
            "test_loss": np.asarray(result.test_loss), "steps": np.asarray(result.steps),
            "best_checkpoint": np.asarray(str(result.best_checkpoint_path)),
            "last_checkpoint": np.asarray(str(result.checkpoint_path)),
            "tensor_parallel": np.asarray(result.state.tensor_parallel)}


def async_checkpoint(task, inputs):
    """The state placed on the mesh, saved as the trainer saves it: the
    sharded format (each rank its pieces) and the flat one (gathered, rank
    0 writes), each synchronously and through AsyncCheckpointer, into
    ``save_dir``/{sync,async}_{sharded,flat}."""
    mesh = _mesh(task)
    _, state = _model(task, inputs)
    placed = place_state(mesh, pad_state_rows(state, mesh[MODEL_AXIS].size()))
    names = dict(experiment_name="port", epoch=2, metric_name="last", metric_value=2.0,
                 template="{experiment}_last.pt")
    out = Path(task["save_dir"])
    save_sharded_checkpoint(out / "sync_sharded", placed, mesh=mesh, **names)
    flat = gather_state_flat(placed, mesh)
    if dist.get_rank() == 0:
        save_checkpoint(out / "sync_flat", flat, **names)
    sharded, single = AsyncCheckpointer(sharded=True, mesh=mesh), AsyncCheckpointer()
    sharded.submit(copy.deepcopy(placed), [dict(directory=out / "async_sharded", **names)])
    flat = gather_state_flat(placed, mesh)  # the collective on the main thread
    if dist.get_rank() == 0:
        single.submit(flat, [dict(directory=out / "async_flat", **names)])
    sharded.wait()
    single.wait()
    return {}


def _seeded_mesh_step(task, mesh):
    """The model, a seeded state of ``task["rows"]`` rows a table placed on
    ``mesh`` (``task["tensor_parallel"]``), seeded dataset arrays, the step
    config and a seeded batch of ``task["batch"]`` (users, items): the
    shapes of the JAX package's collective tests, values from numpy."""
    rows, f = task["rows"], task["features"]
    mp = mesh[MODEL_AXIS].size()
    cfg = parse_model_config(task["model"], user_feature_dim=f, item_feature_dim=f)
    state = create_train_state(cfg, num_users=rows, num_items=rows, seed=0, device="cpu")
    state = place_state(mesh, pad_state_rows(state, mp),
                        tensor_parallel=task.get("tensor_parallel", False))
    rng = np.random.default_rng(0)
    data = BatchData(
        torch.from_numpy(rng.normal(0, 1, (rows, f)).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 1, (rows, f)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, rows, (rows, 3)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 4, rows).astype(np.int32)))
    data = place_data(mesh, pad_batch_data(data, mp))
    tscfg = TrainStepConfig(**dict(task["tscfg"], num_items=rows, opt=DenseOptConfig(**task["opt"])))
    u, p = (torch.from_numpy(rng.integers(0, rows, task["batch"]).astype(np.int32)) for _ in range(2))
    return cfg, state, data, tscfg, u, p


def _record_arrays(records) -> dict:
    """A record as ``records`` [n, 7] strings (op, axis, dtype, shape as
    ``AxB``, branch or '', bytes, group size)."""
    rows = [(c.op, c.axis, c.dtype, "x".join(map(str, c.shape)), c.branch or "", str(c.bytes),
             str(c.group_size)) for c in records]
    return {"records": np.asarray(rows, dtype=str).reshape(-1, 7)}


def collectives(task, inputs):
    """One sharded step of a seeded state (``_seeded_mesh_step``) under
    ``record_collectives``, or with ``task["eval"]`` the eval's item-corpus
    encode and two masked user-batch searches (``batch_hits``) over a
    corpus row-sharded over ``model``: rank 0's record (``_record_arrays``)
    and whether every rank recorded the same ops, axes, dtypes, shapes and
    branches (``ranks_agree``); the number of ``torch.distributed``
    collectives rank 0 called in the recorded block (``dist_calls``). With ``task["unrecorded"]`` also the same
    step from a copy of the state run without a record
    (``recorded/...``, ``unrecorded/...`` the state leaves), and whether the
    mesh's primitives are the plain ones again after the record
    (``restored``)."""
    from ttamm_torch.parallel import collective_inspect
    from ttamm_torch.parallel import mesh as mesh_module

    mesh = _mesh(task)
    cfg, state, data, tscfg, u, p = _seeded_mesh_step(task, mesh)
    out = {}
    if task.get("eval"):
        from ttamm_torch.evaluation import retrieval

        state.model.eval()
        rows, b = task["rows"], task["batch"]
        rng = np.random.default_rng(1)
        plan = retrieval.EvalPlan(
            batches=(), gt_per_user={}, deep_k=13, num_items=rows, gt_sizes=np.zeros((2, b), np.int32),
            user_mat=torch.from_numpy(rng.integers(0, rows, (2, b)).astype(np.int32)),
            blocked_rows=torch.from_numpy(rng.integers(0, rows, (rows, 4)).astype(np.int32)),
            gt_mat=torch.from_numpy(rng.integers(0, rows, (2, b, 3)).astype(np.int32)))
        with record_collectives(mesh) as records, _dist_calls([]) as calls:
            items = retrieval._corpus(state.model, data, None, mesh)
            for batch in range(2):
                retrieval.batch_hits(state.model, data, items, plan, batch, max_k=10, mesh=mesh)
    else:
        twin = copy.deepcopy(state) if task.get("unrecorded") else None
        step = make_sharded_train_step(cfg, tscfg, mesh)
        gen = torch.Generator().manual_seed(3)
        with record_collectives(mesh) as records, _dist_calls([]) as calls:
            step(state, data, u, p, generator=gen)
        if twin is not None:
            step(twin, data, u, p, generator=torch.Generator().manual_seed(3))
            out.update({f"recorded/{k}": v for k, v in gather_state_flat(state, mesh).items()})
            out.update({f"unrecorded/{k}": v for k, v in gather_state_flat(twin, mesh).items()})
            out["restored"] = np.asarray(all(
                getattr(mesh_module, name) is fn for name, fn in collective_inspect._plain.items()))
    mine = [(c.op, c.axis, c.dtype, c.shape, c.branch) for c in records]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out.update(_record_arrays(records), ranks_agree=np.asarray(all(r == mine for r in every)),
               dist_calls=np.asarray(len(calls)))
    return out


TASKS = {"collectives": collectives, "sparse_update": sparse_update, "train_step": train_step,
         "search": search, "checkpoint": checkpoint, "async_checkpoint": async_checkpoint,
         "exchange_lookup": exchange_lookup, "feature_rows": feature_rows, "train_run": train_run,
         "multi_step": multi_step, "owner_overflow": owner_overflow}


def main() -> int:
    spec_path = sys.argv[1]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", timeout=timedelta(seconds=TIMEOUT_SECONDS))
    rank = dist.get_rank()
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    with np.load(spec["inputs"]) as inputs:
        for task in spec["tasks"]:
            result = TASKS[task["kind"]](task, inputs)
            if rank == 0:
                np.savez(out / f"{task['name']}.npz", **result)
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "ttamm_tpu")))
    assert not leaked, leaked
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
