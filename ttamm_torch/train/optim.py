"""Dense optimizers with torch-parity semantics: Adam / AdamW / SGD (port of
``ttamm_tpu/train/optim.py``).

A functional update over a list of tensors, in place:

- Adam: L2 weight decay folded into the gradient (torch ``Adam``);
- AdamW: decoupled decay ``w -= lr*wd*w`` before the Adam step (torch
  ``AdamW``);
- SGD: optional momentum buffer, L2 decay folded into the gradient.

Bias correction as torch: ``lr * sqrt(1-b2^t) / (1-b1^t)``. The step count
and the learning-rate schedule live on the host (Python numbers): the
scalars that change from step to step (the decay factor, the step size,
the second bias correction) are formed there in double, rounded to f32 once
(:func:`dense_scalars`) and read by the update from device memory
(:func:`dense_opt_apply`), so an update issues no host sync and a captured
update (``train/step.py``'s CUDA graph) reads each replay's own step. On
the card Adam and AdamW are one ``csrc/dense_adam.cu`` launch
(``kernels.dense_adam``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels


class DenseOptConfig(NamedTuple):
    name: str = "adam"  # 'adam' | 'adamw' | 'sgd'
    lr: float = 1e-3
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.0
    lr_schedule: str = "constant"  # 'constant' | 'cosine' | 'linear'
    lr_total_steps: int = 0  # schedule horizon (optimizer steps)
    lr_final_factor: float = 0.0  # lr multiplier reached at the horizon


@dataclass
class DenseOptState:
    m: list[torch.Tensor]  # first moments (or SGD momentum buffers)
    v: list[torch.Tensor]  # second moments (zeros for SGD)
    step: int = 0


def init_dense_opt(params: list[torch.Tensor]) -> DenseOptState:
    return DenseOptState(
        m=[torch.zeros_like(p) for p in params], v=[torch.zeros_like(p) for p in params]
    )


def lr_scale(cfg: DenseOptConfig, step: int) -> float:
    """Schedule multiplier for the (1-indexed) optimizer step ``step``:
    1.0 for the constant schedule, else cosine or linear decay to
    ``lr_final_factor`` over ``lr_total_steps``, clamped at the horizon."""
    if cfg.lr_schedule == "constant" or cfg.lr_total_steps <= 0:
        return 1.0
    t = min(max((step - 1.0) / max(cfg.lr_total_steps - 1, 1), 0.0), 1.0)
    f = cfg.lr_final_factor
    if cfg.lr_schedule == "linear":
        return 1.0 + (f - 1.0) * t
    if cfg.lr_schedule == "cosine":
        return f + (1.0 - f) * 0.5 * (1.0 + math.cos(math.pi * t))
    raise ValueError(f"Unknown lr_schedule: {cfg.lr_schedule}")


DENSE_SCALARS = 3  # the f32 scalars of one dense step (dense_scalars)


def dense_scalars(cfg: DenseOptConfig, step: int) -> np.ndarray:
    """The f32 ``[DENSE_SCALARS]`` scalars of (1-indexed) step ``step``,
    formed in double and rounded once: Adam / AdamW ``(1 - lr * wd, -lr /
    (1 - b1^t), 1 - b2^t)`` (the first read under AdamW with decay only),
    SGD ``(-lr, 0, 0)``."""
    lr = cfg.lr * lr_scale(cfg, step)
    if cfg.name == "sgd":
        row = (-lr, 0.0, 0.0)
    else:
        row = (1.0 - lr * cfg.weight_decay, -lr / (1.0 - cfg.b1**step), 1.0 - cfg.b2**step)
    return np.array(row, dtype=np.float32)


@torch.no_grad()
def dense_opt_update(
    params: list[torch.Tensor],
    grads: list[torch.Tensor],
    state: DenseOptState,
    cfg: DenseOptConfig,
) -> None:
    """One optimizer step on ``params`` in place (and on ``state``) at
    ``state.step + 1``, which it advances: :func:`dense_opt_apply` with the
    step's scalars formed here."""
    state.step += 1
    scalars = torch.from_numpy(dense_scalars(cfg, state.step))
    dense_opt_apply(params, grads, state, cfg, scalars.to(params[0].device) if params else scalars)


@torch.no_grad()
def dense_opt_apply(
    params: list[torch.Tensor],
    grads: list[torch.Tensor],
    state: DenseOptState,
    cfg: DenseOptConfig,
    scalars: torch.Tensor,
) -> None:
    """The update of :func:`dense_opt_update` with the step's f32 scalars
    (:func:`dense_scalars`' row, on the parameters' device) read from
    device memory, ``state.step`` left as it is. Adam and AdamW go through
    ``kernels.dense_adam`` (on the card one fused launch, bit for bit the
    ``torch._foreach_*`` composition that the CPU runs); SGD is its own
    ``_foreach_`` composition."""
    if not params:
        return
    if cfg.name != "sgd":
        kernels.dense_adam(params, grads, state.m, state.v, scalars=scalars, b1=cfg.b1, b2=cfg.b2,
                           eps=cfg.eps, weight_decay=cfg.weight_decay,
                           decoupled=cfg.name == "adamw")
        return
    if cfg.weight_decay:
        grads = torch._foreach_add(grads, params, alpha=cfg.weight_decay)
    if cfg.momentum:
        torch._foreach_mul_(state.m, cfg.momentum)
        torch._foreach_add_(state.m, grads)
        grads = state.m
    torch._foreach_add_(params, torch._foreach_mul(grads, scalars[0]))


def parse_dense_opt_config(training_cfg: dict, *, total_steps: int = 0) -> DenseOptConfig:
    """Resolve the YAML ``training:`` section into a DenseOptConfig;
    ``lr_schedule`` may be a string or ``{type, final_factor,
    total_steps}`` (``total_steps`` defaults to the caller's horizon)."""
    name = str(training_cfg.get("optimizer", "adam")).lower()
    if name not in {"adam", "adamw", "sgd"}:
        raise ValueError(f"Unsupported optimizer: {name}")
    betas = training_cfg.get("betas", (0.9, 0.999))
    sched = training_cfg.get("lr_schedule", "constant") or "constant"
    if isinstance(sched, str):
        sched = {"type": sched}
    sched_type = str(sched.get("type", "constant")).lower()
    if sched_type not in {"constant", "cosine", "linear"}:
        raise ValueError(f"Unsupported lr_schedule: {sched_type}")
    return DenseOptConfig(
        name=name,
        lr=float(training_cfg.get("learning_rate", 1e-3)),
        weight_decay=float(training_cfg.get("weight_decay", 0.0)),
        b1=float(betas[0]),
        b2=float(betas[1]),
        momentum=float(training_cfg.get("momentum", 0.0)),
        lr_schedule=sched_type,
        lr_total_steps=int(sched.get("total_steps", total_steps)),
        lr_final_factor=float(sched.get("final_factor", 0.0)),
    )
