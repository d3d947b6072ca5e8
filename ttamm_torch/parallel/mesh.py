"""The device mesh and its collectives (port of ``ttamm_tpu/parallel/mesh.py``).

The scale-out model of the JAX package: a 2-D logical mesh

- ``data`` axis: the batch (data parallelism); dense parameters replicated,
  their gradients summed over ``data``;
- ``model`` axis: embedding-table rows; the ID tables, the mimic tables, the
  feature matrices and every optimizer moment of a table are row-sharded;
  under ``mesh.tensor_parallel`` also the dense tower layers and their
  moments, in Megatron column / row slices (:func:`copy_to_axis` and
  :func:`all_reduce_statistic` are their f and g).

torch runs one process per device, so the mesh is a ``DeviceMesh`` over the
default process group with dims ``("data", "model")``: rank = data index x
model + model index, the JAX ``reshape(dp, mp)`` of the device list. The
collectives below are the only ones the port's code issues; each names
the mesh axis it runs over (``world``: the whole mesh). Every one goes
through one of three primitives, ``_all_reduce``, ``_all_gather`` and
``_all_to_all``, which ``collective_inspect.record_collectives`` swaps for
recording versions while it is active; outside it they are the plain
``torch.distributed`` calls below.

On a card they may be captured into a CUDA graph (the replayed steps of
``train/step.py``), as PyTorch allows for NCCL: each takes its group from
the mesh, which resolves it on the host while the capture records, and
each group's communicator is made before the first capture
(:func:`warm_groups`, from the eager step that precedes it). None reads a
value on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
WORLD_AXIS = "world"  # every rank of the mesh (the default process group)


@dataclass(frozen=True)
class MeshConfig:
    data_parallel: int = 1
    model_parallel: int = 1

    @property
    def num_devices(self) -> int:
        return self.data_parallel * self.model_parallel


def parse_mesh_config(config: Mapping[str, Any] | None) -> MeshConfig:
    cfg = dict(config or {})
    return MeshConfig(
        data_parallel=int(cfg.get("data_parallel", 1)),
        model_parallel=int(cfg.get("model_parallel", 1)),
    )


def build_mesh(cfg: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """The ``(data, model)`` mesh over the default process group, whose world
    size must be ``data_parallel * model_parallel``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != cfg.num_devices:
        raise RuntimeError(
            f"Mesh needs {cfg.num_devices} processes (data={cfg.data_parallel} x "
            f"model={cfg.model_parallel}) but the process group has {world}: start them "
            f"with torchrun --nproc_per_node {cfg.num_devices}"
        )
    return init_device_mesh(
        device_type, (cfg.data_parallel, cfg.model_parallel),
        mesh_dim_names=(DATA_AXIS, MODEL_AXIS),
    )


def round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh[axis].size()


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def _all_reduce(t: torch.Tensor, op, group, axis: str) -> None:
    dist.all_reduce(t, op=op, group=group)


def _all_gather(out: torch.Tensor, t: torch.Tensor, group, axis: str) -> None:
    dist.all_gather_into_tensor(out, t, group=group)


def _all_to_all(out: torch.Tensor, t: torch.Tensor, out_splits, in_splits, group, axis: str) -> None:
    dist.all_to_all_single(out, t, out_splits, in_splits, group=group)


def _group(mesh: DeviceMesh, axis: str):
    return None if axis == WORLD_AXIS else mesh.get_group(axis)


def warm_groups(mesh: DeviceMesh, device: torch.device) -> None:
    """One small all-reduce on the whole mesh and on each axis's group, so
    that every communicator a step's collectives use exists before a CUDA
    graph captures them (a capture cannot create one). Every rank must call
    it at the same point."""
    one = torch.ones(1, device=device)
    for axis in (WORLD_AXIS, DATA_AXIS, MODEL_AXIS):
        all_reduce(one, mesh, axis)


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over one mesh axis (or ``world``);
    returns ``t``."""
    _all_reduce(t, op, _group(mesh, axis), axis)
    return t


def all_gather_rows(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``t`` of every rank of the axis, concatenated along dim 0 in axis
    order (every rank's ``t`` has the same shape)."""
    size = axis_size(mesh, axis)
    t = t.contiguous()
    out = t.new_empty((size * t.shape[0], *t.shape[1:]))
    _all_gather(out, t, _group(mesh, axis), axis)
    return out


def all_to_all(out: torch.Tensor, t: torch.Tensor, mesh: DeviceMesh, axis: str,
               out_splits: list[int] | None = None, in_splits: list[int] | None = None) -> torch.Tensor:
    """``all_to_all_single`` over one mesh axis: ``t``'s dim-0 chunks (equal,
    or ``in_splits`` rows each) go to the axis's ranks in order, ``out``
    receives theirs (``out_splits``); returns ``out``."""
    _all_to_all(out, t.contiguous(), out_splits, in_splits, _group(mesh, axis), axis)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over one mesh axis whose every rank then computes the same value
    from the sum. The backward passes the cotangent through unchanged: each
    rank's gradient reaches only its own summand, so summing the ranks'
    parameter gradients afterwards counts the statistic once."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def all_reduce_statistic(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Differentiable sum of a statistic over ``axis`` (see ``_AllReduceSum``)."""
    return _AllReduceSum.apply(t, mesh, axis)


class _AllGatherRowsGrad(torch.autograd.Function):
    """``all_gather_rows`` as a differentiable read: every rank's loss may
    read every rank's rows, so the gradient of a row is the sum of what
    each rank's loss sends it. The backward sums the cotangent over the
    axis (one all-reduce, which gloo and NCCL both run) and keeps this
    rank's rows."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, t.shape[0]
        return all_gather_rows(t, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        summed = all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.mesh, ctx.axis)
        start = axis_index(ctx.mesh, ctx.axis) * ctx.rows
        return summed[start : start + ctx.rows], None, None


def all_gather_rows_grad(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Differentiable :func:`all_gather_rows` (see ``_AllGatherRowsGrad``)."""
    return _AllGatherRowsGrad.apply(t, mesh, axis)


class _CopyToAxis(torch.autograd.Function):
    """Megatron's f: the identity forward (every rank of the axis holds the
    same input) whose backward sums the cotangent over the axis, since each
    rank's consumer of the input (a column slice of a layer) sends back
    only its part of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.mesh, ctx.axis), None, None


def copy_to_axis(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Megatron's f over ``axis`` (see ``_CopyToAxis``); its counterpart g is
    :func:`all_reduce_statistic`."""
    return _CopyToAxis.apply(t, mesh, axis)
