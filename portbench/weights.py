"""The initial weights of a training cell, drawn by the benchmark from the
seed on the run's device, and the seeds of a run's streams.

Every leaf of the two-tower model, by the benchmark's own names: the row
tables ``user_id``, ``item_id``, ``user_aug``, ``item_aug`` (a table on the
sparse-row optimizer, as the configuration says, ends in one zero scratch
row, the port's layout, which no lane reads), and each tower's linear
layers ``<side>_tower/<layer>/weight`` ``[out, in]`` and ``.../bias``. The
distributions are the configuration's: normal tables (``init.std``, the
mimic tables ``adaptive_mimic.init_std``), xavier-uniform weights and
uniform ``±1/sqrt(fan_in)`` biases. Two draws make them all: one normal
draw for the tables and one uniform draw for the linear layers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import yardstick

# the streams a run draws from its --seed
WEIGHTS, STEPS, ORDER, CATALOGUE, QUERIES, SAMPLE = range(6)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of ``stream`` from the run's ``seed`` (any whole number)."""
    state = np.random.SeedSequence([int(seed) & (2**128 - 1), stream]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def _linears(side: str, enc: dict, feature_dim: int) -> list[tuple[str, int, int]]:
    """``(name, in, out)`` of one tower's linear layers: the feature MLP's,
    then the σ-gate's two (``yardstick.linear_widths`` gives the widths)."""
    widths = yardstick.linear_widths(feature_dim, enc)
    gate = 2 if widths and enc.get("fusion", "gated") in ("gated", "adaptive_mimic") else 0
    names = [f"{side}_tower/feature_encoder/layers/{i}" for i in range(len(widths) - gate)]
    names += [f"{side}_tower/gate/fc1", f"{side}_tower/gate/fc2"][:gate]
    return [(name, din, dout) for name, (din, dout, _) in zip(names, widths)]


def sparse_tables(model: dict) -> set[str]:
    """The tables on sparse-row Adam (the rest are on the dense optimizer)."""
    out = {f"{side}_id" for side in ("user", "item")
           if (model[f"{side}_encoder"]["id_embedding"].get("params") or {}).get("sparse", False)}
    mimic = model.get("adaptive_mimic") or {}
    if mimic.get("enabled", True) and mimic.get("sparse", False):
        out |= {"user_aug", "item_aug"}
    return out


def leaf_specs(model: dict, rows: dict[str, int], feature_dims: dict[str, int]):
    """``(tables, linears)``: ``{name: (rows, scratch rows, dim, std)}`` and
    ``[(layer name, in, out)]`` of the YAML ``model`` section, for ``rows``
    users and items."""
    sparse = sparse_tables(model)
    tables = {}
    for side in ("user", "item"):
        emb = model[f"{side}_encoder"]["id_embedding"]
        std = float((emb.get("init") or {}).get("std", 0.02))
        tables[f"{side}_id"] = (rows[side], int(f"{side}_id" in sparse),
                                int(emb["params"]["embedding_dim"]), std)
    mimic = model.get("adaptive_mimic") or {}
    if mimic.get("enabled", True):
        dim = int(model["user_encoder"]["id_embedding"]["params"]["embedding_dim"])
        for side in ("user", "item"):
            tables[f"{side}_aug"] = (rows[side], int(f"{side}_aug" in sparse), dim,
                                     float(mimic.get("init_std", 0.02)))
    linears = []
    for side in ("user", "item"):
        linears += _linears(side, model[f"{side}_encoder"], feature_dims[side])
    return tables, linears


def initial_weights(model: dict, rows: dict[str, int], feature_dims: dict[str, int], seed: int,
                    device) -> dict[str, torch.Tensor]:
    """Every leaf's initial value, float32 on ``device``, from ``seed``."""
    tables, linears = leaf_specs(model, rows, feature_dims)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHTS))
    normal = torch.randn(sum(n * d for n, _, d, _ in tables.values()), generator=gen, device=device)
    uniform = torch.rand(sum(i * o + o for _, i, o in linears), generator=gen, device=device)
    out, at = {}, 0
    for name, (n, scratch, d, std) in tables.items():
        t = torch.zeros(n + scratch, d, device=device)
        t[:n] = normal[at : at + n * d].view(n, d) * std
        out[name], at = t, at + n * d
    at = 0
    for name, fan_in, fan_out in linears:
        bound_w = math.sqrt(6.0 / (fan_in + fan_out))
        bound_b = 1.0 / math.sqrt(fan_in)
        w = uniform[at : at + fan_in * fan_out].view(fan_out, fan_in)
        b = uniform[at + fan_in * fan_out : at + fan_in * fan_out + fan_out]
        out[f"{name}/weight"] = (w * 2.0 - 1.0) * bound_w
        out[f"{name}/bias"] = (b * 2.0 - 1.0) * bound_b
        at += fan_in * fan_out + fan_out
    return out
