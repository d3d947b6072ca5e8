"""How the training state and the dataset arrays lay out on a mesh (port of
``ttamm_tpu/parallel/sharding.py``).

Row tables (the user/item ID tables and the mimic tables) and their
optimizer moments are row-sharded over ``model``, and so are the dataset
arrays indexed by user or item (feature matrices, padded positives,
category ids, log q). The dense parameters and their moments are replicated,
or, with ``tensor_parallel=True`` (``mesh.tensor_parallel``), split over
``model`` by each linear layer's Megatron role (``Tower.tp_roles``, the JAX
``tp_dense_shardings``): a ``col`` layer keeps rows ``[out/s]`` of its
``nn.Linear`` ``weight`` and of its ``bias`` (the JAX ``w[:, c0:c1]`` and
``b[c0:c1]``), a ``row`` layer columns ``[in/s]`` of ``weight`` (JAX
``w[r0:r1, :]``) and its whole ``bias``, a ``rep`` layer (the concat
projection too) all of it; the AdamW moments of each leaf as the leaf.
torch has no sharded tensor here: :func:`place_state` and
:func:`place_data` keep this rank's contiguous slice of every sharded
array and a whole copy of the rest.

Divisibility: a sharded array is first padded with zero rows (or
``finfo(f32).min`` for ``item_log_q``) by :func:`pad_state_rows` and
:func:`pad_batch_data`. Every array of one side (users or items) is padded
to the same :func:`padded_rows`, a multiple of the model axis with room for
a scratch row, so that shard ``s`` holds the same users or items in every
table and matrix and can encode its rows on its own. (The JAX package pads
each array to its own multiple; the sharded checkpoints record global row
bounds, so the two layouts read each other's files.) Pad rows are never
gathered, never drawn as negatives and never returned by the search. A
sparse table's scratch row, the last of its ``num_users + 1`` /
``num_items + 1`` rows, becomes an ordinary row of some shard: the sharded
update needs no scratch row. :func:`logical_rows` gives each table's
unpadded row count, to which the gathered state and the checkpoints are cut
back.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..models.convert import host_leaf, pack_moment_leaves, train_state_to_flat
from ..models.two_tower import TwoTower
from ..ops.sparse_adam import SparseAdamState
from ..train.optim import DenseOptState
from ..train.state import BatchData, TrainState, dense_table_names, sparse_table_names
from .mesh import MODEL_AXIS, all_gather_rows, axis_index, axis_size, round_up


def _table_module(model, name: str) -> nn.Embedding:
    if name in ("user_id", "item_id"):
        return model.tower(name[:4]).id_embedding
    return model.mimic.table(name[:4])


def logical_rows(model, name: str) -> int:
    """Unpadded rows of table ``name``: the users or items, plus the scratch
    row of a table on the sparse-row optimizer (a sparse ID table, or a
    mimic table under ``adaptive_mimic.sparse``)."""
    count = model.num_users if name.startswith("user") else model.num_items
    return count + int(name in sparse_table_names(model.cfg))


def row_sharded_tensors(state: TrainState) -> dict[str, tuple[str, torch.Tensor]]:
    """Every row-sharded tensor of ``state`` by its flat checkpoint key, with
    the name of the table whose rows it has."""
    out = {f"tables/{n}": (n, t) for n, t in state.tables.items()}
    offset = len(state.opt_dense.m) - len(dense_table_names(state.model.cfg))
    for i, n in enumerate(dense_table_names(state.model.cfg)):
        out[f"opt_dense/m/tables/{n}"] = (n, state.opt_dense.m[offset + i])
        out[f"opt_dense/v/tables/{n}"] = (n, state.opt_dense.v[offset + i])
    for n, s in state.opt_sparse.items():
        out[f"opt_sparse/{n}/m"] = (n, s.m)
        out[f"opt_sparse/{n}/v"] = (n, s.v)
    return out


def _map_rows(state: TrainState, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> TrainState:
    """A copy of ``state`` with ``fn(table name, tensor)`` applied to every
    row-sharded tensor."""
    model = copy.deepcopy(state.model)
    for name, table in state.tables.items():
        _table_module(model, name).weight = nn.Parameter(fn(name, table.detach()), requires_grad=False)
    names = dense_table_names(state.model.cfg)
    n_dense = len(state.opt_dense.m) - len(names)

    def moments(ms: list[torch.Tensor]) -> list[torch.Tensor]:
        return [m.clone() if i < n_dense else fn(names[i - n_dense], m) for i, m in enumerate(ms)]

    return TrainState(
        model=model,
        opt_dense=DenseOptState(
            m=moments(state.opt_dense.m), v=moments(state.opt_dense.v),
            step=state.opt_dense.step,
        ),
        opt_sparse={
            n: SparseAdamState(m=fn(n, s.m), v=fn(n, s.v), step=s.step)
            for n, s in state.opt_sparse.items()
        },
        step=state.step,
        packed_moments=state.packed_moments,
        tensor_parallel=state.tensor_parallel,
    )


def _pad_rows_to(t: torch.Tensor | None, rows: int, fill: float = 0.0) -> torch.Tensor | None:
    if t is None or t.shape[0] == rows:
        return t
    pad = t.new_full((rows - t.shape[0], *t.shape[1:]), fill)
    return torch.cat([t, pad])


def padded_rows(count: int, model_parallel: int) -> int:
    """Rows of every sharded array of a side with ``count`` users or items:
    ``count + 1`` (the scratch row) rounded up to the model axis."""
    return round_up(count + 1, model_parallel)


def pad_state_rows(state: TrainState, model_parallel: int) -> TrainState:
    """Every row table and its moments padded with zero rows to its side's
    :func:`padded_rows` (a copy; ``state`` itself at one model shard)."""
    if model_parallel <= 1:
        return state
    model = state.model
    side_rows = {
        "user": padded_rows(model.num_users, model_parallel),
        "item": padded_rows(model.num_items, model_parallel),
    }
    return _map_rows(state, lambda name, t: _pad_rows_to(t, side_rows[name[:4]]))


def pad_batch_data(data: BatchData, model_parallel: int) -> BatchData:
    """Every dataset array padded to its side's :func:`padded_rows`."""
    if model_parallel <= 1:
        return data

    def pad(t, fill=0.0):
        return None if t is None else _pad_rows_to(t, padded_rows(t.shape[0], model_parallel), fill)

    return BatchData(
        user_features=pad(data.user_features),
        item_features=pad(data.item_features),
        positive_rows=pad(data.positive_rows),
        category_ids=pad(data.category_ids),
        # log q = 0 would mark a pad item as certain to be sampled; the
        # float32 minimum makes pad rows inert for any consumer that scans
        # the whole vector
        item_log_q=pad(data.item_log_q, fill=float(np.finfo(np.float32).min)),
    )


def _local_slice(mesh: DeviceMesh, t: torch.Tensor | None) -> torch.Tensor | None:
    if t is None:
        return None
    mp = axis_size(mesh, MODEL_AXIS)
    if t.shape[0] % mp:
        raise ValueError(f"{t.shape[0]} rows do not divide the model axis ({mp}): pad first")
    rows = t.shape[0] // mp
    start = axis_index(mesh, MODEL_AXIS) * rows
    return t[start : start + rows].clone()


def tp_leaf_dims(model: TwoTower, size: int) -> dict[str, int]:
    """The dense parameters that tensor parallelism splits over a model axis
    of ``size``, by their ``dense_parameters`` key, with the dim of the
    ``nn.Linear`` tensor it splits: a ``col`` layer's ``w`` and ``b`` along
    0, a ``row`` layer's ``w`` along 1."""
    out = {}
    for side in ("user", "item"):
        for name, role in model.tower(side).tp_roles(size).items():
            key = f"{side}_tower/{name}"
            if role == "col":
                out[f"{key}/w"] = out[f"{key}/b"] = 0
            elif role == "row":
                out[f"{key}/w"] = 1
    return out


def tp_sharded_tensors(state: TrainState, mesh: DeviceMesh) -> dict[str, tuple[int, torch.Tensor]]:
    """Every tensor a tensor-parallel state holds a slice of, by its flat
    checkpoint key (the parameter and its two AdamW moments), with the dim
    of the ``nn.Linear`` tensor it is sliced along; empty unless
    ``state.tensor_parallel``."""
    if not state.tensor_parallel:
        return {}
    dims = tp_leaf_dims(state.model, axis_size(mesh, MODEL_AXIS))
    out = {}
    for i, (key, param) in enumerate(state.model.dense_parameters()):
        if key in dims:
            out[f"dense/{key}"] = (dims[key], param)
            out[f"opt_dense/m/dense/{key}"] = (dims[key], state.opt_dense.m[i])
            out[f"opt_dense/v/dense/{key}"] = (dims[key], state.opt_dense.v[i])
    return out


def _set_dense(model: TwoTower, key: str, tensor: torch.Tensor, requires_grad: bool) -> None:
    """Replace the dense parameter ``key`` (``dense_parameters``' naming) of
    ``model`` by ``tensor``."""
    name, _, leaf = key.rpartition("/")
    layer = dict(model.dense_layers())[name]
    setattr(layer, "weight" if leaf == "w" else "bias",
            nn.Parameter(tensor, requires_grad=requires_grad))


@torch.no_grad()
def _split_dense(state: TrainState, mesh: DeviceMesh) -> None:
    """Keep this rank's tensor-parallel slice of each split dense parameter
    and of its moments (in place)."""
    size, index = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)

    def cut(t: torch.Tensor, dim: int) -> torch.Tensor:
        part = t.shape[dim] // size
        return t.narrow(dim, index * part, part).clone()

    dims = tp_leaf_dims(state.model, size)
    for i, (key, param) in enumerate(state.model.dense_parameters()):
        if key not in dims:
            continue
        _set_dense(state.model, key, cut(param.detach(), dims[key]), param.requires_grad)
        state.opt_dense.m[i] = cut(state.opt_dense.m[i], dims[key])
        state.opt_dense.v[i] = cut(state.opt_dense.v[i], dims[key])
    state.tensor_parallel = True


def place_state(mesh: DeviceMesh, state: TrainState, *, tensor_parallel: bool = False) -> TrainState:
    """This rank's part of a padded state: its row slice of every table and
    moment, and of the dense parameters and their moments a whole copy, or
    with ``tensor_parallel`` this rank's slices of the split layers (see
    the module docstring)."""
    placed = _map_rows(state, lambda _, t: _local_slice(mesh, t))
    if tensor_parallel:
        _split_dense(placed, mesh)
    return placed


def place_data(mesh: DeviceMesh, data: BatchData) -> BatchData:
    """This rank's row slice of every (padded) dataset array."""
    return BatchData(
        user_features=_local_slice(mesh, data.user_features),
        item_features=_local_slice(mesh, data.item_features),
        positive_rows=_local_slice(mesh, data.positive_rows),
        category_ids=_local_slice(mesh, data.category_ids),
        item_log_q=_local_slice(mesh, data.item_log_q),
    )


def row_offset(mesh: DeviceMesh, local_rows: int) -> int:
    """Global id of this rank's first row of a table with ``local_rows``
    rows per shard."""
    return axis_index(mesh, MODEL_AXIS) * local_rows


def _gather_dim(t: torch.Tensor, mesh: DeviceMesh, dim: int) -> torch.Tensor:
    """Every model rank's slice of a tensor joined along ``dim`` (0 or 1)."""
    if dim == 0:
        return all_gather_rows(t, mesh, MODEL_AXIS)
    return all_gather_rows(t.T, mesh, MODEL_AXIS).T


def gather_state_flat(state: TrainState, mesh: DeviceMesh) -> dict[str, np.ndarray]:
    """The whole unpadded state as the flat checkpoint arrays of
    ``train_state_to_flat``, on every rank (row-sharded tensors gathered
    over ``model`` and cut back to their logical rows, tensor-parallel
    slices gathered over ``model``)."""
    flat = train_state_to_flat(dataclasses.replace(state, packed_moments=False))
    for key, (name, t) in row_sharded_tensors(state).items():
        full = all_gather_rows(t, mesh, MODEL_AXIS)[: logical_rows(state.model, name)]
        flat[key] = full.cpu().numpy()
    for key, (dim, t) in tp_sharded_tensors(state, mesh).items():
        flat[key] = host_leaf(key, _gather_dim(t.detach(), mesh, dim))
    return pack_moment_leaves(flat) if state.packed_moments else flat


@torch.no_grad()
def encode_model(state: TrainState, mesh: DeviceMesh | None) -> TwoTower:
    """The model every encode path reads (the eval's corpus and user
    encodes, the end-of-run diagnostics and recommendations, the serving
    bundle and its gate): ``state.model``, or for a tensor-parallel state a
    copy whose split layers are whole again, gathered over ``model`` (the
    tables stay this rank's, shared with the state). The encodes of a
    model-sharded mesh read other rows on each model rank, so they cannot
    run the tensor-parallel forward, whose ranks must hold the same rows."""
    if not state.tensor_parallel:
        return state.model
    model = state.model
    memo = {id(t): t for t in model.tables().values()}
    whole = copy.deepcopy(model, memo)
    params = dict(model.dense_parameters())
    for key, dim in tp_leaf_dims(model, axis_size(mesh, MODEL_AXIS)).items():
        _set_dense(whole, key, _gather_dim(params[key].detach(), mesh, dim), False)
    return whole.eval()
