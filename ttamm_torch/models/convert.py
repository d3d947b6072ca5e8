"""JAX parameters into the port: the one way weights cross over.

Two inputs are accepted:

- ``(tables, dense)`` as numpy pytrees, the JAX ``init_model`` output (or a
  ``TrainState``'s ``tables``/``dense``) after ``jax.device_get``;
- a JAX checkpoint ``.npz`` (``ttamm_tpu/train/checkpoint.py``), whose
  leaves are stored under flat ``/``-joined keys (``tables/user_id``,
  ``dense/user_tower/feature_encoder/layers/0/w``, ...).

Layout differences handled here: a JAX dense weight ``w`` is ``[in, out]``
and ``nn.Linear.weight`` is ``[out, in]``, so weights are transposed. Tables
on the sparse-row optimizer carry one zero scratch row at the end (a
scatter-padding target that is never read); it is sliced off, so every
port table has exactly one row per user or item.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .encoders import Tower
from .two_tower import ModelConfig, TwoTower


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
    n = table.weight.shape[0]
    if rows.shape[0] < n or rows.shape[1] != table.weight.shape[1]:
        raise ValueError(f"table {tuple(table.weight.shape)} vs JAX {rows.shape}")
    table.weight.copy_(torch.from_numpy(np.array(rows[:n], np.float32)))


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


def _num_rows(rows: np.ndarray, scratch: bool) -> int:
    return int(rows.shape[0]) - (1 if scratch else 0)


def from_jax_params(
    cfg: ModelConfig,
    tables: Mapping[str, np.ndarray],
    dense: Mapping[str, Any],
    *,
    device: torch.device | str | None = None,
) -> TwoTower:
    """A ``TwoTower`` holding the JAX ``(tables, dense)`` parameters."""
    num_users = _num_rows(tables["user_id"], cfg.user_tower.embedding.sparse)
    num_items = _num_rows(tables["item_id"], cfg.item_tower.embedding.sparse)
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
    """A ``TwoTower`` from a JAX checkpoint ``.npz`` (optimizer state and
    metadata are ignored)."""
    with np.load(Path(path)) as archive:
        flat = {k: archive[k] for k in archive.files if k.startswith(("tables/", "dense/"))}
    return from_jax_params(
        cfg, _unflatten(flat, "tables"), _unflatten(flat, "dense"), device=device
    )
