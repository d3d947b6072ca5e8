"""JAX parameters and training states into the port, and back: the one way
weights cross over.

Inputs accepted:

- ``(tables, dense)`` as numpy pytrees, the JAX ``init_model`` output (or a
  ``TrainState``'s ``tables``/``dense``) after ``jax.device_get``;
- a checkpoint ``.npz`` (``ttamm_tpu/train/checkpoint.py`` format, which the
  port's ``ttamm_torch/train/checkpoint.py`` writes too), whose leaves are
  stored under flat ``/``-joined keys (``tables/user_id``,
  ``dense/user_tower/feature_encoder/layers/0/w``, ...);
- a whole training state as those flat keys (``train_state_from_flat`` /
  ``train_state_to_flat``): tables, dense parameters, the dense optimizer's
  moments and step, the sparse tables' moments and steps, and the step.

Layout differences handled here: a JAX dense weight ``w`` is ``[in, out]``
and ``nn.Linear.weight`` is ``[out, in]``, so weights, and the dense
optimizer's moments of weights, are transposed. Tables on the sparse-row
optimizer carry one zero scratch row at the end (a scatter-padding target
that is never read) on both sides, so every table is copied whole.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .encoders import Tower
from .two_tower import ModelConfig, TwoTower

if TYPE_CHECKING:
    from ..train.state import TrainState


def _unflatten(flat: Mapping[str, np.ndarray], prefix: str) -> dict[str, Any]:
    """Rebuild the nested dict under ``prefix/`` from flat checkpoint keys
    (list indices become int keys)."""
    tree: dict[Any, Any] = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1 :].split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(int(part) if part.isdigit() else part, {})
        node[parts[-1]] = value
    return tree


def _layers(node: Any) -> list[Mapping[str, np.ndarray]]:
    """A JAX layer list, either a real list or the int-keyed dict of a
    flattened checkpoint."""
    if isinstance(node, Mapping):
        return [node[i] for i in sorted(node)]
    return list(node)


@torch.no_grad()
def _copy_linear(layer: nn.Linear, params: Mapping[str, np.ndarray]) -> None:
    w = np.array(params["w"], np.float32)
    b = np.array(params["b"], np.float32)
    if layer.weight.shape != (w.shape[1], w.shape[0]) or layer.bias.shape != b.shape:
        raise ValueError(
            f"linear layer {tuple(layer.weight.shape)} vs JAX w {w.shape}, b {b.shape}"
        )
    layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
    layer.bias.copy_(torch.from_numpy(b))


@torch.no_grad()
def _copy_table(table: nn.Embedding, rows: np.ndarray) -> None:
    if tuple(rows.shape) != tuple(table.weight.shape):
        raise ValueError(f"table {tuple(table.weight.shape)} vs JAX {rows.shape}")
    table.weight.copy_(torch.from_numpy(np.array(rows, np.float32)))


def _load_tower(tower: Tower, table: np.ndarray, dense: Mapping[str, Any]) -> None:
    _copy_table(tower.id_embedding, table)
    fe_layers = _layers((dense.get("feature_encoder") or {}).get("layers", []))
    if len(fe_layers) != len(tower.feature_layers):
        raise ValueError(
            f"{len(fe_layers)} JAX feature layers vs {len(tower.feature_layers)}"
        )
    for layer, params in zip(tower.feature_layers, fe_layers):
        _copy_linear(layer, params)
    if tower.gate_fc1 is not None:
        _copy_linear(tower.gate_fc1, dense["gate"]["fc1"])
        _copy_linear(tower.gate_fc2, dense["gate"]["fc2"])
    if tower.projection is not None:
        _copy_linear(tower.projection, dense["projection"])


def from_jax_params(
    cfg: ModelConfig,
    tables: Mapping[str, np.ndarray],
    dense: Mapping[str, Any],
    *,
    device: torch.device | str | None = None,
) -> TwoTower:
    """A ``TwoTower`` holding the JAX ``(tables, dense)`` parameters, on
    ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    # a sparse ID table ends in its scratch row
    num_users = tables["user_id"].shape[0] - int(cfg.user_tower.embedding.sparse)
    num_items = tables["item_id"].shape[0] - int(cfg.item_tower.embedding.sparse)
    model = TwoTower(cfg, num_users=num_users, num_items=num_items, device="cpu")
    # A tower with no dense parameters leaves no keys in a checkpoint.
    _load_tower(model.user_tower, tables["user_id"], dense.get("user_tower", {}))
    _load_tower(model.item_tower, tables["item_id"], dense.get("item_tower", {}))
    if model.mimic is not None:
        _copy_table(model.mimic.user_aug, tables["user_aug"])
        _copy_table(model.mimic.item_aug, tables["item_aug"])
    return model.to(device)


def from_jax_checkpoint(
    path: Path | str,
    cfg: ModelConfig,
    *,
    device: torch.device | str | None = None,
) -> TwoTower:
    """A ``TwoTower`` from a JAX checkpoint ``.npz`` on ``device`` (``None``:
    the CUDA card); optimizer state and metadata are ignored."""
    with np.load(Path(path)) as archive:
        flat = {k: archive[k] for k in archive.files if k.startswith(("tables/", "dense/"))}
    return from_jax_params(
        cfg, _unflatten(flat, "tables"), _unflatten(flat, "dense"), device=device
    )


# ---------------------------------------------------------------------------
# Whole training states
# ---------------------------------------------------------------------------


def host_leaf(key: str, tensor: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy leaf ``key`` of a JAX state (a ``.../w``
    transposed to JAX's ``[in, out]``)."""
    arr = tensor.detach().cpu().numpy()
    return np.ascontiguousarray(arr.T) if key.endswith("/w") else arr


def train_state_to_flat(
    state: "TrainState",
    pull: Callable[[dict[str, torch.Tensor]], Mapping[str, torch.Tensor]] | None = None,
) -> dict[str, np.ndarray]:
    """A port ``TrainState`` as the flat ``/``-keyed numpy leaves of the
    JAX ``TrainState`` (``ttamm_tpu.train.checkpoint.state_to_host``).
    ``pull`` takes every tensor leaf by key and returns them on the host at
    once (a background writer's copy into pinned buffers); by default each
    is copied by itself."""
    leaves: dict[str, torch.Tensor | np.ndarray] = {
        f"tables/{n}": t for n, t in state.tables.items()
    }
    for key, param in state.model.dense_parameters():
        leaves[f"dense/{key}"] = param
    keys = [k for k, _ in state.dense_targets()]
    for key, m, v in zip(keys, state.opt_dense.m, state.opt_dense.v):
        leaves[f"opt_dense/m/{key}"] = m
        leaves[f"opt_dense/v/{key}"] = v
    leaves["opt_dense/step"] = np.asarray(state.opt_dense.step, np.int32)
    for name, sparse in state.opt_sparse.items():
        leaves[f"opt_sparse/{name}/m"] = sparse.m
        leaves[f"opt_sparse/{name}/v"] = sparse.v
        leaves[f"opt_sparse/{name}/step"] = np.asarray(sparse.step, np.int32)
    leaves["step"] = np.asarray(state.step, np.int32)
    tensors = {k: t.detach() for k, t in leaves.items() if isinstance(t, torch.Tensor)}
    host = tensors if pull is None else pull(tensors)
    flat = {k: host_leaf(k, host[k]) if k in host else v for k, v in leaves.items()}
    return pack_moment_leaves(flat) if state.packed_moments else flat


def pack_moment_leaves(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``flat`` with each sparse table's ``opt_sparse/<name>/m`` and ``v``
    replaced by one ``opt_sparse/<name>/mv`` = ``[m | v]`` along the
    columns: the leaf of the JAX ``SparseAdamStatePacked``
    (``training.packed_moments``)."""
    out = {}
    for key, value in flat.items():
        prefix, _, leaf = key.rpartition("/")
        if prefix.startswith("opt_sparse/") and leaf == "m":
            out[f"{prefix}/mv"] = np.concatenate([value, flat[f"{prefix}/v"]], axis=1)
        elif not (prefix.startswith("opt_sparse/") and leaf == "v"):
            out[key] = value
    return out


def moment_layout_leaf(key: str, flat: Mapping[str, np.ndarray]) -> np.ndarray | None:
    """A sparse-Adam moment leaf ``<prefix>/m`` / ``<prefix>/v`` cut from
    the left / right half of a packed ``<prefix>/mv`` (the JAX
    ``_convert_moment_layout``); None when ``flat`` has no such leaf. A
    relayout only, so a packed checkpoint restores bit for bit."""
    prefix, _, leaf = key.rpartition("/")
    if leaf in ("m", "v") and f"{prefix}/mv" in flat:
        mv = flat[f"{prefix}/mv"]
        half = mv.shape[1] // 2
        return mv[:, :half] if leaf == "m" else mv[:, half:]
    return None


@torch.no_grad()
def train_state_from_flat(state: "TrainState", flat: Mapping[str, np.ndarray]) -> "TrainState":
    """Fill the port ``TrainState`` ``state`` (built for the same config and
    sizes, e.g. by ``create_train_state``) in place from flat JAX keys; a
    missing key or a shape mismatch raises. The sparse-Adam moments are
    read from either layout, separate ``m`` / ``v`` or packed ``mv``
    (:func:`moment_layout_leaf`). Returns ``state``."""
    def put(key: str, tensor: torch.Tensor) -> None:
        arr = flat[key] if key in flat else moment_layout_leaf(key, flat)
        if arr is None:
            raise ValueError(f"training state is missing '{key}'")
        arr = np.array(arr, np.float32)  # a writable copy
        if key.endswith("/w"):
            arr = arr.T
        if arr.shape != tuple(tensor.shape):
            raise ValueError(f"'{key}': {arr.shape} vs the port's {tuple(tensor.shape)}")
        tensor.copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    for name, table in state.tables.items():
        put(f"tables/{name}", table)
    for key, param in state.model.dense_parameters():
        put(f"dense/{key}", param)
    keys = [k for k, _ in state.dense_targets()]
    for key, m, v in zip(keys, state.opt_dense.m, state.opt_dense.v):
        put(f"opt_dense/m/{key}", m)
        put(f"opt_dense/v/{key}", v)
    state.opt_dense.step = int(flat["opt_dense/step"])
    for name, sparse in state.opt_sparse.items():
        put(f"opt_sparse/{name}/m", sparse.m)
        put(f"opt_sparse/{name}/v", sparse.v)
        sparse.step = int(flat[f"opt_sparse/{name}/step"])
    state.step = int(flat["step"])
    return state
