"""One of two branches chosen by a flag on the device, with no host read: the
counterpart of ``lax.cond`` for a step that runs eagerly and as a captured
CUDA graph (``train/step.py``'s replays).

:func:`cond` runs ``true_fn(*operands)`` where an int32 flag is nonzero,
else ``false_fn(*operands)``. The branches update tensors in place (the
tables and moments a sparse update writes) and return nothing.

On a card each branch is captured once, on its own, into a CUDA graph that
reads static copies of the operands; a call copies the operands and the flag
into them and then runs two IF nodes (``csrc/graph_cond.cu``): a
one-thread kernel sets each node's condition from the flag, so exactly one
branch's graph runs and the host never learns which. Under a capture (a
replayed step) the nodes go into the graph being captured; in an eager call
they are one small graph of their own, launched. Both forms run the same
kernels on the same values, so an eager step and its replay agree bit for
bit. Collectives may sit in a branch (NCCL's kernels and copies are
allowed in a conditional body): every rank must pass the same flag, as
``lax.cond`` after a ``pmax``.

A branch's graphs are built by the first call of its key (the branch's
settings and the operands' shapes and dtypes, which the caller's ``key``
and this function form), which must be eager: a capture cannot hold the
capture of another graph. The communicators of the collectives in a branch
must exist by then (``parallel.mesh.warm_groups``). A graph that embeds the
nodes holds the branches' graphs (:func:`holding`), whose memory the nodes
address. The kernel launches of one branch are added to the counts at each
call (both branches must launch the same kernels).

On the CPU the flag lies on the host: the branch is chosen in Python.

A later call of a key runs the branches' graphs and none of their Python.
A caller that keeps account of what a branch does when it runs (the
collectives the parallel layer records) passes ``on_replay``: the callable
given at the key's build is kept with its graphs and called at each later
call.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Callable, NamedTuple

import torch

from . import kernels


class _Branches(NamedTuple):
    """A key's two branch graphs (kept as graphs: ``raw_cuda_graph``), the
    static operands and flag they read, the graph of the two IF nodes that
    an eager call launches, one branch's kernel launches and the
    caller's ``on_replay``."""

    graphs: tuple[Any, Any]
    inputs: tuple[torch.Tensor, ...]
    flag: torch.Tensor
    eager: Any
    launches: dict[str, int]
    on_replay: Callable[[], None] | None


KEEP = 32  # keys held at once (a graph embedding a key's nodes holds it too)
_cache: collections.OrderedDict[tuple, _Branches] = collections.OrderedDict()
_held: list[list[_Branches]] = []


def clear() -> None:
    """Drop every key's branch graphs (before the communicators their
    collectives use are destroyed; a graph embedding their nodes must go
    first)."""
    _cache.clear()


@contextlib.contextmanager
def holding():
    """Collect the branches whose nodes go into the graph being captured in
    this block: the caller keeps the list as long as the graph lives."""
    held: list[_Branches] = []
    _held.append(held)
    try:
        yield held
    finally:
        _held.remove(held)


def cond(flag: torch.Tensor, true_fn: Callable[..., None], false_fn: Callable[..., None],
         operands: tuple[torch.Tensor, ...], *, key: tuple,
         on_replay: Callable[[], None] | None = None) -> None:
    """``true_fn(*operands)`` where the int32 ``flag`` (one element) is
    nonzero, else ``false_fn(*operands)``, with no host read on a card.
    ``key`` names the branches and every setting they close over (tensors
    they write by address included); the operands' shapes and dtypes are
    added to it. ``on_replay``: on a card, the build's is called at every
    later call of the key."""
    if flag.device.type != "cuda":
        (true_fn if bool(flag.reshape(-1)[0]) else false_fn)(*operands)
        return
    full_key = (key, flag.device, tuple((tuple(t.shape), t.dtype) for t in operands))
    capturing = torch.cuda.is_current_stream_capturing()
    entry = _cache.get(full_key)
    if entry is None:
        if capturing:
            raise RuntimeError(
                "device_cond: a branch met for the first time inside a CUDA graph capture; "
                "an eager call of the step must build its branch graphs first")
        entry = _build(true_fn, false_fn, operands, flag.device, on_replay)
        _cache[full_key] = entry
        while len(_cache) > KEEP:
            _cache.popitem(last=False)
    elif entry.on_replay is not None:
        entry.on_replay()
    _cache.move_to_end(full_key)
    for dst, src in zip(entry.inputs, operands):
        dst.copy_(src)
    entry.flag.copy_(flag.reshape(1))
    if capturing:
        _if_nodes(entry.flag, entry.graphs)
        for held in _held:
            held.append(entry)
    else:
        entry.eager.replay()
    kernels.add_launch_counts(entry.launches)


def _build(true_fn, false_fn, operands, dev: torch.device, on_replay) -> _Branches:
    """Capture each branch on static copies of the operands, then the eager
    launcher (the two IF nodes on a static flag)."""
    inputs = tuple(t.clone() for t in operands)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    graphs, launches = [], []
    for fn in (true_fn, false_fn):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = kernels.launch_counts()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                fn(*inputs)
        finally:
            after = kernels.launch_counts()
            counts = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            kernels.add_launch_counts(counts, -1)  # captured, not run
        graphs.append(graph)
        launches.append(counts)
    if launches[0] != launches[1]:
        raise RuntimeError(f"device_cond: the branches launch different kernels: {launches}")
    eager = torch.cuda.CUDAGraph()
    with torch.cuda.graph(eager, capture_error_mode="thread_local"):
        _if_nodes(flag, graphs)
    return _Branches(tuple(graphs), inputs, flag, eager, launches[0], on_replay)


def _if_nodes(flag: torch.Tensor, graphs) -> None:
    """Into the graph being captured on the current stream: an IF node on
    ``flag != 0`` holding the first graph, then one on ``flag == 0``
    holding the second."""
    lib = kernels.load_library()
    stream = torch.cuda.current_stream(flag.device).cuda_stream
    for invert, graph in enumerate(graphs):
        rc = lib.ttamm_graph_if(flag.data_ptr(), invert, graph.raw_cuda_graph(), stream)
        if rc != 0:
            msg = lib.ttamm_error_string(rc).decode()
            raise RuntimeError(f"device_cond: conditional node refused: {msg} ({rc})")
