#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper card: training with
the per-epoch retrieval eval, and serving, at the canonical scale.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero and prints no
result line):

1. build the CUDA kernels from ``ttamm_torch/csrc/`` and report the card,
   the ``ptxas`` registers and spills of every kernel, and the SASS
   counts of the search and moments kernels (groupmax_matmul must contain
   ``wgmma``, HGMMA, and TMA loads, UTMALDG; the moments' chunk kernel f64
   ``mma.sync``, DMMA, and their backward bf16 ``mma.sync``, HMMA, beside
   their ``ldmatrix`` and 16-byte loads; select_topk_from_groups's 16-byte
   loads, block barriers and warp matches are printed; sparse_adam_rows must
   have 16-byte loads and stores and no local memory, and its FFMA count is
   printed);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes and time kernel, plain version and the nearest library call
   (device time from ``torch.profiler``; the row kernels are timed in
   phase 4):
   small_k_topk bit-identical at its six search widths (782, 2560, 3072,
   the chunked search's 40-wide merge, 15,625, and the chunked search's
   262,144-wide chunk; each timed against torch.topk, 15,625 the headline
   row, the others its ``parts``; up to 16K wide over 200 calls), gather_rows and scatter_set_rows
   bit-identical (the
   scatter away from its scratch row, with duplicate-heavy indices and the
   scratch row), sparse_adam_rows at duplicate-heavy lanes coalesced with
   the non-head lanes masked, table, m and v bit-identical to its plain
   version over every row at steps 1 and 1000, weight decay 0 and 0.01; select_topk_from_groups bit-identical at its three
   shapes (``select_shapes``: one query block of a 4096-user val batch over
   99,880 items, KG = k = 21, with a ragged tail, finfo.min blocked columns
   and tied rows, the headline row; float32 serving of 1,024 queries over
   the same items and a 134-query block over 2M items, KG = k = 20), each
   timed against its plain version and a gather + torch.topk;
   groupmax_matmul (1024 x 2M x 128 bf16 and a ragged float32 case, each
   with its share of the bf16 peak) and rescore_groups
   within rtol 1e-6 + atol 1e-5 (exact bf16 products, f32 sums in another
   order); segment_second_moments forward within 2e-5 x the largest |M2|
   entry of each category (its entries off the f64 sum rounded to f32
   counted) and backward within 2e-5 x the largest |dx| (f32 sums of up to
   N products in another order), with empty and one-member
   categories and ids >= C, each direction timed as the loss calls it (the
   forward with the row grouping it builds, the backward given that
   grouping), the forward's kernels and the grouping kernel also timed
   alone, the grouping bit-identical to its plain version (PyTorch ops);
3. the canonical corpus (200k users x 100k items x 2M interactions) from
   the port's generator, and its data prep;
4. one training step of ``configs/default.yaml`` from a seeded state with
   injected negatives and no dropout, with the kernels and with their plain
   versions on the card: losses within rtol 1e-5, Adam moments of the
   touched rows within rtol 1e-4 + atol 1e-9, touched table rows and dense
   parameters within atol 1e-5 (lr / 100: Adam's first step is
   lr * g / (|g| + eps), which multiplies gradient differences by up to
   lr / eps = 1e5 where |g| is near eps, and the kernels sum in another
   order than the plain versions); then gather_rows and scatter_set_rows
   on the item table at that step's coalesced targets (its 12,288 item
   lanes, every duplicate on the scratch row), bit-identical to their plain
   versions and timed with a cold L2 (a 256 MB fill before each call, its
   kernels left out), their bound counting each distinct row once;
   gather_rows at the sparse ID tables' forward reads (every lane), equal to
   index_select and timed against it; sparse_adam_rows at that step's item
   lanes (the row) and user lanes (``parts``), checked as in phase 2 and
   timed with a cold L2 beside its plain version and the composition it
   replaces (gather_rows x 3, eager Adam, scatter_set_rows x 3, the row's
   ``library_ms``), its bound every lane's index and, for each live lane,
   the gradient row in and the table, m and v rows in and out; and
   segment_second_moments checked and timed as in phase 2 at that step's
   item lanes' real category ids (``parts`` ``*_canonical``);
4b. the multi-device layer on one card, at that step's item lanes for each
   of 4 virtual model shards of the padded item table and at 1x1:
   gather_rows_masked at the lookup's lanes (global ids in batch order, a
   shard's base; zeros on the lanes it does not own), bit-identical to its
   plain version on every lane and to the lookup it replaced, timed with a
   cold L2 beside it (index_select + where, the row's ``library_ms``), the
   bound every lane's index and row and each owned distinct row;
   sparse_adam_rows at the sharded update's lanes (coalesced, localized,
   non-heads and foreign lanes -1 at the head and the tail; the owner
   buffer at 1x1 with its sentinel tail), bit-identical to its plain
   version over every row at steps 1 / 1000, weight decay 0 / 0.01, timed
   beside it and the composition it replaced (3 masked gathers, adam_rows,
   3 masked scatters); scatter_set_rows_masked, on no path now, held to its
   plain version at the lanes the update gave it before and timed; the
   shard loop (one sparse_adam_rows launch a shard) against the
   single-device sparse_adam_update, bit-identical; then the sharded
   training step on a 1x1 DeviceMesh over a one-rank NCCL group at
   ``configs/default.yaml`` width, 3 steps under the allgather and 3 under
   the owner routing (their launches are the mesh path's counts, counted
   from zero just before them: gather_rows_masked and sparse_adam_rows
   must run, the scatters and the unmasked gather must not), each against
   the single-device step with the same negatives and no dropout, within
   phase 4's tolerances, and against the same steps through the parent's
   row code (``parent_mesh_path``), bit for bit; then the device ms and
   device ops and the host ms per step of the one-device step, of both
   routings and of both through the parent's row code;
4c. ``training.packed_moments: true`` (checkpoints hold each sparse
   table's Adam moments as one [rows, 2D] leaf ``mv``; in memory they stay
   two tensors): one step from phase 4's seeded state, batch and negatives,
   equal bit for bit to phase 4's step (losses, every table, dense
   parameter and moment; its launches, counted from zero just before it:
   sparse_adam_rows and gather_rows once a sparse table); its flat and
   sharded checkpoints hold ``mv`` = [m | v] and no ``m`` / ``v``, and
   restore bit for bit into a packed and a separate state;
4d. ``mesh.tensor_parallel`` on a 1x1 NCCL mesh (every all-reduce of the
   split tower layers has one rank) at ``configs/default.yaml``'s widths
   (float32 and ``model.precision: bfloat16``) and
   ``configs/in_batch_softmax.yaml``'s: (a) three TP steps from the seeded
   state against the same steps without TP, both routings, the default
   lookup and the all-to-all exchange, bit for bit (or, where a float32
   row layer's ``mm`` + sum + bias add rounds otherwise than ``addmm``,
   within phase 4's tolerances, each difference printed); (b) the TP
   steps' launches: gather_rows_masked, sparse_adam_rows (and gather_rows
   at the exchange) and the moments kernels, no scatter; (c) device ms,
   device ops, host ms and idle share of a TP and a non-TP step in turns;
   (d) a TP sharded directory read back bit for bit into a TP and a non-TP
   placement, and the export CLI from it = the non-TP directory's export;
4e. ``training.steps_per_call`` at ``configs/default.yaml``'s and
   ``configs/in_batch_softmax.yaml``'s widths (B = 2048, dropout on): from
   phase 4's seeded state, 100 eager single steps against two
   ``make_multi_train_step`` calls of 50 (the first: the eager warm-up
   step, the CUDA graph capture and 49 replays; the second: 50 replays):
   every state leaf, the losses, the host counts and the generator's state
   bit for bit, the same launch counts (a replay adds its graph's captured
   launches); then 5 turns of
   each, alternating eager and replay, 20 steps a turn: host ms/step,
   device ms/step, device ops/step and idle share (median and range) and
   launches a step, which must be the same for both;
4f. the mesh's multi-step on a 1x1 NCCL mesh (``configs/default.yaml``
   allgather / owner, each with and without ``mesh.tensor_parallel``,
   ``configs/pod_2x4.yaml`` owner through the all-to-all exchange; B = 2048,
   dropout on): two ``make_sharded_multi_train_step`` calls of 50 = 100
   eager sharded steps bit for bit, a replayed forced overflow, then 3
   turns each way of host / device ms, ops and idle share;
4g. the wire inventory on 4f's mesh: each 4f case's collectives recorded
   (``parallel/collective_inspect.py``) for one eager sharded step and for
   a multi-step call (the groups' warm-up, its eager step, the capture):
   the same list in order (op, axis, dtype, shape, branch); no collective
   moving half the smallest table or more; every floating all-gather over
   ``data`` bf16 under the pod recipe; under the owner routing each sparse
   table's full-width gathers in the ``overflow`` branch, issued by 4f's
   forced overflow (its device counters); each case's count and bytes by
   axis printed; then ``scripts/torch_predict_scaling.py`` (run beside the
   card's steps on CPU gloo ranks) for ``configs/default.yaml`` and
   ``configs/pod_2x4.yaml`` at 2x4 and 8x1 from 4e's replay ms/step, its
   lines printed;
5. train two epochs of ``configs/default.yaml`` on the card with the
   retrieval eval after each, through ``run_training`` (the main path's
   launches are counted from here; its sweep ledger must hold the one
   run; ``training.steps_per_call: auto`` as the config says: an epoch's
   full batches as one chunk of CUDA-graph replays, the eval losses' full
   batches likewise): finite losses, the last epoch's mean train loss below the first
   step's; each epoch's val and test recall/ndcg@{5,10,20}, with recall@5 <=
   recall@10 <= recall@20, and the eval's seconds (host clock); the best
   val recall@10 above 20x chance (10 / items); the best checkpoint under
   the template's name; then, outside the counts, the device ms of one val
   user batch, the hit matrices of the first two val batches with the
   kernels and with their plain versions (equal bit for bit), and 256 users'
   masked ids against a host numpy masked search (equal but where scores tie
   within 1e-5); the checkpoint laps (the trainer's background writer)
   and the end-of-run wait for it; the reports: the Markdown report (its
   recall@k line that of the best epoch, one entry per sampled user), the
   JSON embedding summary and, where matplotlib is installed, the loss
   PNG (which of the two is printed); the end-of-run block again on the
   best state, its launches counted apart (small_k_topk and gather_rows
   must run), each sample user's recommended ids equal to a host numpy
   search of the same embeddings but where scores tie within 1e-5; then
   steps, ms/step, examples/s, launches per step and a
   ``torch.profiler`` table of the top device ops with the device's idle
   share over 20 more steps (each step must launch gather_rows and
   sparse_adam_rows twice, once a sparse table, and scatter_set_rows never);
   last, outside the counts, the checkpoint A/B: one state saved
   synchronously and through AsyncCheckpointer, the files equal (arrays
   bit for bit, the meta but its timestamp), then 50 canonical train steps
   a turn in the turns none, write, write, none, with the host ms/step of
   each, the checkpoint lap and the writer's remaining time after the
   steps;
5b. the recommended configuration, ``configs/in_batch_softmax.yaml`` (the
   logQ-corrected in-batch softmax, sparse-row Adam on the mimic tables):
   (a) one step from the seeded state with an injected pool of 256 mixed
   negatives and with the shipped M = 0, no dropout, kernels vs plain
   versions within phase 4's tolerances on all four sparse tables, each
   launching gather_rows and sparse_adam_rows 4 times and scatter_set_rows
   never; (b) gather_rows and sparse_adam_rows on both mimic tables at the
   M = 0 step's lanes, bit-identical to their plain versions and timed with
   a cold L2 beside their bound (the rows' ``parts`` ``in_batch_*``), and
   segment_second_moments at its N = B item lanes' real category ids
   (``parts`` ``*_in_batch``); (c) two epochs through ``run_training``
   (its launches counted from zero just before it), checked as phase 5
   (its reports and end-of-run block too) and profiled over 20 steps (4 gather_rows and 4 sparse_adam_rows a step, no
   scatter_set_rows), its ms/step, examples/s, device ms and ops per step
   and idle share printed beside phase 5's; (d) the best checkpoint
   exported and 256 users searched, ids equal to the host numpy search but
   where scores tie; (e) 3 steps a routing on the 1x1 NCCL mesh, each held
   to the one-device step within phase 4's tolerances;
5c. the pod recipe, ``configs/pod_2x4.yaml`` with its mesh set to 1x1 (the
   in-batch softmax with sparse mimic tables, the bf16 gradient wire, bf16
   feature matrices, owner routing) and ``checkpointing.sharded: true``:
   (a) one step from the seeded state, kernels vs plain versions within
   phase 4's tolerances but for elements a bf16 rounding flip moved (at
   most FLIP_SHARE of a table's touched elements, each within 2.5 lr), 4
   gather_rows, 4 sparse_adam_rows, the moments once each way, no scatter;
   (b) 3 steps a routing on the 1x1 NCCL mesh, each held to its own run
   with the plain versions and to the one-device step (allgather within
   phase 4's tolerances, owner within the bound of its second rounding),
   the dtype of every tensor the sparse update all-gathers over data
   printed (each must be bf16); (c) the same steps with
   ``embedding_exchange: alltoall``, equal to (b)'s bit for bit, one
   gather_rows a table a step at the exchange; then device ms, device ops
   and host ms a step of each beside the one-device step; (d) two epochs
   through ``run_training`` (launches counted from zero just before it),
   checked as phase 5b, profiled beside 5b's numbers, the feature
   matrices' device bytes at float32 and bf16; (e) the export CLI from the
   best checkpoint directory, its bundle equal bit for bit to the export of
   a flat checkpoint of the same state, 256 users searched (ids equal to
   the host numpy search but where scores tie);
5d. ``model.precision: bfloat16`` in ``configs/default.yaml`` (the towers'
   matmuls on bf16 operands with float32 sums, the backward rounded as the
   JAX ``_dot``'s): one step from the seeded state, kernels vs plain
   versions within phase 4's tolerances but for bf16 rounding flips (as
   5c); one epoch through ``run_training`` (launches counted from zero just
   before it), its val recall@10 and ms/step printed beside phase 5's first
   epoch, then 20 profiled steps;
6. export the serving bundle from the best checkpoint at the score dtype
   the trainer's precision gate chose, and serve it behind the HTTP front
   end (``/healthz``, GET user, POST user, POST embedding); ids must equal
   the host numpy search except where scores tie within 1e-5 (within 2^-6
   for a bf16 index: bf16 operands and slab move each score by up to ~2^-8,
   so near items may swap); then the same from the trainer's own index
   directory, whose vocab must equal the export's and whose user
   embeddings must be within 1e-5 of the export's (the same encode of the
   same best state);
6b. the port's command lines and host backends, each CLI in a process of
   its own, side by side: (a) ``python -m ttamm_torch.pipelines.preprocess``
   on phase 3's CSVs and config, whose seven arrays must equal phase 3's
   dataset and whose vocabularies its index maps; (b) ``python -m
   ttamm_torch.serve.query`` on phase 6's ``items.index`` for its first
   1,024 users at k = 20 under ``--backend device``, ``native`` and
   ``numpy``, ids agreeing but for ties (phase 6's tolerance); (c) ``python
   -m ttamm_torch.serve`` under ``--backend native`` and ``device`` for 8
   users, the same asins but for ties; (d) meanwhile, in this process,
   ``run_training`` with ``diagnostics.profile_dir`` for 20 steps: one
   trace, naming ``sparse_adam_rows_kernel``, ``m2_chunk_kernel`` and
   ``gather_rows_kernel``. Then each backend's ``FlatIndex.search`` host ms
   at 1,024 queries, alone, and the host CPU. Its launches are counted from
   zero and must include the search, row and moments kernels;
7. corpus scale: a 2M x 128 index of seeded random rows searched through
   ``auto``, ``group_exact`` and ``fused`` at B=1024, k=20; fused ids must
   equal the plain-version fused ids (ties within 1e-5 aside); then one
   masked bf16 search (M = 32 blocked ids per query, half of them each
   query's own top ids), which ``auto`` must route to ``fused`` and whose
   ids must equal the plain-version masked fused ids and hold no blocked id;
   then the bf16 group_exact / fused device-ms sweep at 500k, 1M and 2M
   items (logged, not acted on);
7b. the chunked search past the float32 slab ceiling: a seeded 10M x 128
   float32 cosine index, B = 1024, k = 20 through ``FlatIndex.search``
   (``auto`` must scan in chunks of ``chunk_items(1024)`` = 262,144, the
   widest whose float32 scores fit the 1 GiB budget) and a masked search (M = 32, half
   each query's own top ids), their launches counted from zero just before
   them (small_k_topk twice a chunk, nothing else); the ids and scores equal
   the scan with small_k_topk's plain version, 32 queries' ids equal a host
   numpy search (ties within 1e-5 aside), no blocked id returned, and at 2M
   items an explicit chunked search equals group_exact's ids; then device
   ms, host ms and the launches a search;
8. the launch counts of phases 5-7b, 6b's included (phase 5b's and 5c's are their own, in
   the summary's ``in_batch_softmax`` and ``pod_2x4``) and, for gather_rows_masked, of phase
   4b's sharded steps (every kernel must have run), leaving out the
   launches made to compare or time a kernel against its plain version;
   scatter_set_rows and scatter_set_rows_masked, whose work
   sparse_adam_rows does on the one-device and the mesh path, must have
   run in the comparisons of phases 2, 4 and 4b instead.

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH, K = 1024, 20
TIE_TOL = 1e-5
BF16_TIE_TOL = 2.0 ** -6  # a bf16-scored index against the float32 numpy search
EVAL_USERS = 4096  # evaluation.user_batch_size of configs/default.yaml
KERNEL_RTOL, KERNEL_ATOL = 1e-6, 1e-5
M2_TOL = 2e-5  # relative to the largest entry of each category (fwd) / of dx (bwd)
STEP_ATOL = 1e-5  # parameters after one step, kernels vs plain (lr / 100)
STEP_SEED = 7  # the seeded state of the single steps (phases 4 and 4b)
STEP_LR = 1e-3  # training.learning_rate of every shipped config the steps run
FLIP_SHARE = 1e-4  # elements a bf16 rounding flip may move, of a table's touched ones
VIRTUAL_SHARDS = 4  # model shards of the masked kernels' layouts (phase 4b)
MESH_STEPS = 3  # sharded steps per routing (phases 4b and 5b)
IB_POOL = 256  # mixed negatives of phase 5b's second one-step comparison
CORPUS_ROWS, CORPUS_DIM = 2_000_000, 128
CHUNKED_ROWS = 10_000_000  # past the float32 slab ceiling (8,388,608 items): the chunked search
PROFILE_STEPS = 20
AB_STEPS = 50  # canonical train steps a turn of phase 5's checkpoint A/B
MULTI_STEPS = 50  # replayed steps held to eager ones (phase 4e)
MULTI_TURNS = 5  # timed turns of each, eager and replayed (phase 4e)
MESH_TURNS = 3  # the same on the 1x1 mesh for five cases (phase 4f; fewer, for the script's time)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
L2_FLUSH_BYTES = 256 << 20  # five times the 50 MB L2 of an H100

# Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

KERNEL_INFO = {
    "small_k_topk": ("ttamm_torch/csrc/small_k_topk.cu", "ttamm_tpu/ops/pallas/topk.py:239"),
    "select_topk_from_groups": (
        "ttamm_torch/csrc/select_topk.cu", "ttamm_tpu/ops/pallas/topk.py:140",
    ),
    "groupmax_matmul": ("ttamm_torch/csrc/groupmax_matmul.cu", "ttamm_tpu/ops/pallas/fused_mips.py:91"),
    "rescore_groups": ("ttamm_torch/csrc/rescore_groups.cu", "ttamm_tpu/ops/pallas/fused_mips.py:176"),
    "gather_rows": ("ttamm_torch/csrc/rows.cu", "ttamm_tpu/ops/pallas/rows.py:109"),
    "scatter_set_rows": ("ttamm_torch/csrc/rows.cu", "ttamm_tpu/ops/pallas/rows.py:220"),
    "segment_second_moments": (
        "ttamm_torch/csrc/category_stats.cu", "ttamm_tpu/ops/pallas/category_stats.py:83",
    ),
    "gather_rows_masked": ("ttamm_torch/csrc/rows.cu", "ttamm_tpu/ops/pallas/rows.py:133"),
    "scatter_set_rows_masked": ("ttamm_torch/csrc/rows.cu", "ttamm_tpu/ops/pallas/rows.py:248"),
    # gather_rows x 3 -> Adam -> scatter_set_rows x 3 of the JAX row-kernel path
    "sparse_adam_rows": ("ttamm_torch/csrc/rows.cu", "ttamm_tpu/ops/sparse_adam.py:191-208"),
}
MESH_KERNELS = ("gather_rows_masked",)  # counted in phase 4b (sparse_adam_rows runs there too)
# Off every path since sparse_adam_rows took their work: launched and held
# to their plain versions in phases 2, 4 and 4b.
COMPARED_ONLY = ("scatter_set_rows", "scatter_set_rows_masked")


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "Phase":
        log(f"== phase {self.name}")
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        status = "ok" if exc_type is None else "FAILED"
        log(f"phase {self.name}: {status} in {time.perf_counter() - self.start:.2f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def uncounted(excluded: collections.Counter):
    """Add the launches made inside (a kernel compared or timed against its
    plain version) to ``excluded``, which phase 8 takes off the counts."""
    from ttamm_torch.ops import kernels

    before = kernels.launch_counts()
    try:
        yield
    finally:
        after = kernels.launch_counts()
        excluded.update({k: after[k] - before[k] for k in after})


def _on_card(evt) -> bool:
    """Whether an entry of a profile's ``key_averages()`` is a kernel, copy
    or fill that ran on the card. Where CPU ops are profiled too, an op's
    own device time repeats its kernels'; and kineto copies each annotated
    range (``ProfilerStep*``, the port's ``ttamm.*`` spans) onto the card's
    timeline, where it spans the work beneath it."""
    from torch.autograd import DeviceType

    return (evt.device_type != DeviceType.CPU and not getattr(evt, "is_user_annotation", False)
            and not evt.key.startswith(("ProfilerStep", "ttamm.")))


def _device_us(events) -> float:
    """Total device time (µs) of the kernels, copies and fills among a
    profile's ``key_averages()`` (:func:`_on_card`)."""
    total = 0.0
    for evt in events:
        if not _on_card(evt):
            continue
        t = getattr(evt, "self_device_time_total", None)
        total += evt.self_cuda_time_total if t is None else t
    return total


def _profiled(warm, body, cpu: bool = False):
    """``key_averages()`` of ``body()`` under ``torch.profiler``, after
    ``warm()`` has run in a traced step that is thrown away (the first
    records of a session are the likeliest to be dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    traces = []
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda prof: traces.append(prof.key_averages())) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        body()
        torch.cuda.synchronize()
        prof.step()
    check(len(traces) == 1, f"profiler: {len(traces)} traces")
    return traces[0]


def _per_call_us(events, calls: int) -> float:
    """Device time (µs) of one of ``calls`` equal calls: each kernel's mean
    duration times its launches per call, rounded to whole launches (the
    profiler drops a kernel's record now and then)."""
    total = 0.0
    for evt in events:
        if evt.count:
            per_call = round(evt.count / calls) or evt.count / calls
            total += _device_us([evt]) / evt.count * per_call
    return total


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms: the summed durations of the work it
    puts on the card (``torch.profiler``), over ``iters`` calls. Host gaps
    between launches are not counted; where the profiler sees no device
    work, CUDA events around the calls are used instead."""
    import torch

    def calls(n):
        for _ in range(n):
            fn()

    events = _profiled(lambda: calls(warmup), lambda: calls(iters))
    if _device_us(events) > 0:
        return _per_call_us(events, iters) / 1e3
    log("  (the profiler saw no device time: timing with CUDA events)")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_cold(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms with a cold L2: a 256 MB fill before
    each call evicts what the earlier calls left in the L2, and the fill's
    kernels (``FillFunctor``, which ``fn`` must not launch) are left out of
    the sum (``torch.profiler``; CUDA events around each call where the
    profiler sees no device work, or so few fills that its records cannot
    be trusted to tell the flush from ``fn``)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def calls(n):
        for i in range(n):
            flush.fill_(float(i + 1))
            fn()

    events = _profiled(lambda: calls(2), lambda: calls(iters))
    fills = sum(e.count for e in events if "FillFunctor" in e.key)
    # the profiler drops a record now and then; most fills must show, or
    # the flush's kernel is not the one left out by name
    if _device_us(events) > 0 and fills >= iters // 2:
        return _per_call_us([e for e in events if "FillFunctor" not in e.key], iters) / 1e3
    log(f"  (the profiler saw {fills} of {iters} flush kernels: timing with CUDA events)")
    total = 0.0
    for i in range(iters):
        flush.fill_(float(i + 1))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_ms(nbytes: float, bf16_flops: float = 0.0) -> tuple[float, str]:
    """Least time on the card: bytes over HBM bandwidth or bf16 operations
    over the bf16 peak, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = bf16_flops / BF16_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def host_qps(fn, batch: int, iters: int = 15) -> float:
    """Queries/s of a host-level search call that returns numpy arrays, from
    the median call (the host clock of a shared machine is noisy)."""
    fn()
    fn()
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    return batch / sorted(times)[len(times) // 2]


def ids_agree(ids, scores, ref_ids, ref_scores, tol: float = TIE_TOL) -> bool:
    """Equal ids except at positions whose scores tie within ``tol``."""
    import numpy as np

    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    scores, ref_scores = np.asarray(scores), np.asarray(ref_scores)
    close = np.abs(scores - ref_scores) <= tol
    return bool(np.all(close) and np.all(close[ids != ref_ids]))


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _row(**kw) -> dict:
    b, by = bound_ms(kw.pop("nbytes"), kw.pop("flops", 0.0))
    return dict(kw, bound_ms=b, bound_by=by)


def _log_row(name: str, row: dict) -> None:
    lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    log(f"{name} {row['shape']}: max abs err {row['max_abs_err']:.3e} | kernel {row['ms']:.4f} ms "
        f"| plain {row['plain_ms']:.4f} ms | library {lib} ms | bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    """HGMMA / UTMALDG / MATCH instructions of the search kernels' SASS,
    16-byte loads (LDG.E.128), block barriers (BAR.SYNC) and MATCH of the
    select kernel's, DMMA / HMMA / LDSM / LDG.E.128 of the moments' chunk
    and backward kernels, and the fused row update's 16-byte loads and
    stores (any cache hint), FFMA, and local-memory loads and stores
    (spills) (``cuobjdump -sass`` beside ``nvcc``). Each op is matched by
    ``sass_op``."""
    from ttamm_torch.ops import kernels

    cuobjdump = Path(kernels.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    ops = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops = None
            if "groupmax_kernel" in name or "small_k_topk_kernel" in name:
                ops = counts.setdefault(name, {"HGMMA": 0, "UTMALDG": 0, "MATCH": 0})
            elif "select_topk_kernel" in name:
                ops = counts.setdefault(name, {"LDG.E.128": 0, "BAR.SYNC": 0, "MATCH": 0})
            elif "m2_chunk_kernel" in name or "m2_bwd_kernel" in name:
                ops = counts.setdefault(name, {"DMMA": 0, "HMMA": 0, "LDSM": 0, "LDG.E.128": 0})
            elif "sparse_adam_rows_kernel" in name:
                ops = counts.setdefault(name, {"LDG.128": 0, "STG.128": 0, "FFMA": 0, "LDL": 0, "STL": 0})
        elif ops is not None:
            for op in ops:
                ops[op] += bool(sass_op(op).search(line))
    return counts


def sass_op(op: str) -> re.Pattern:
    """The SASS instructions ``op`` names: its mnemonic as a whole word,
    then each of its modifiers in order, with any others (cache hints,
    widths) around them, so ``LDG.128`` matches ``LDG.E.EF.128`` and
    ``LDL`` matches ``LDL.LU`` but not ``ULDL``."""
    first, *mods = op.split(".")
    return re.compile(
        rf"\b{re.escape(first)}" + "".join(rf"(?:\.\w+)*?\.{re.escape(m)}" for m in mods) + r"\b"
    )


def phase_build(dev) -> str:
    import torch

    from ttamm_torch.ops import kernels

    lib = kernels.build_library()
    kernels.load_library()
    log(f"kernels: {lib.relative_to(REPO)}")
    build_log = lib.parent / "build.log"
    if build_log.is_file():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    # what the search kernels run: warpgroup MMAs (HGMMA) and TMA loads
    # (UTMALDG) in groupmax_matmul, warp matches (MATCH) in small_k_topk and
    # select_topk_from_groups, and the select kernel's 16-byte loads and
    # block barriers
    sass = sass_counts(lib)
    for fn, ops in sass.items():
        log(f"  sass: {fn}: {ops}")
    gm = [ops for fn, ops in sass.items() if "groupmax_kernel" in fn]
    check(gm and all(o["HGMMA"] > 0 and o["UTMALDG"] > 0 for o in gm),
          f"groupmax_matmul has no wgmma or no TMA load: {gm}")
    # the moments' forward on the f64 tensor cores (DMMA), the backward on the
    # bf16 ones (HMMA)
    fwd = [ops for fn, ops in sass.items() if "m2_chunk_kernel" in fn]
    bwd = [ops for fn, ops in sass.items() if "m2_bwd_kernel" in fn]
    check(len(fwd) == 1 and fwd[0]["DMMA"] > 0 and len(bwd) == 1 and bwd[0]["HMMA"] > 0,
          f"the moments kernels do not run on the tensor cores: {fwd} {bwd}")
    # the fused row update: 16-byte loads and stores, no local memory. Its
    # FFMAs come from the correctly rounded division and square root
    # sequences (nvcc contracts none of the _rn operations).
    adam = [ops for fn, ops in sass.items() if "sparse_adam_rows_kernel" in fn]
    check(len(adam) == 1 and adam[0]["LDG.128"] > 0 and adam[0]["STG.128"] > 0
          and adam[0]["LDL"] == adam[0]["STL"] == 0,
          f"sparse_adam_rows: no 16-byte loads or stores, or spills: {adam}")
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(dev)} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    import importlib.util

    log("matplotlib: " + ("installed (the trainer writes the loss plot)"
                          if importlib.util.find_spec("matplotlib") else
                          "not installed (the trainer writes its reports without the loss plot)"))
    return smi


def _topk_rows(width: int, seed: int, dev):
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((BATCH, width), generator=gen)
    x[0] = 1.5  # all tied
    x[1] = float("-inf")  # all -inf
    x[2] = float("-inf")
    x[2, 5] = 0.5  # fewer than k finite values
    x[3, ::3] = torch.finfo(torch.float32).min  # masked-score sentinels
    x[4, ::5] = -3.0e38
    x[5] = torch.round(x[5] * 2) / 2  # many ties
    return x.to(dev)


def select_shapes() -> list[tuple[str, int, int, int, bool]]:
    """(label, rows, items, k, eval rows) of select_topk_from_groups on the
    main path: one group_exact query block of the val eval's 4096-user batch
    over the canonical corpus's 99,880 items (KG = k = 21: metrics up to
    k = 20, plus the one held-out item per user), float32 serving of B = 1024
    at k = 20 over the same corpus, and one 134-query block of a float32
    search of 2M items."""
    from ttamm_torch.ops import kernels, topk

    def block(n):
        return topk.SCORES_BYTES_BUDGET // (-(-n // kernels.GROUP) * kernels.GROUP * 4)

    return [
        ("val eval block", min(EVAL_USERS, block(99_880)), 99_880, 21, True),
        ("float32 serving", min(BATCH, block(99_880)), 99_880, K, False),
        ("2M float32 query block", block(CORPUS_ROWS), CORPUS_ROWS, K, False),
    ]


def select_case(rows: int, n: int, k: int, eval_rows: bool, dev):
    """A float32 score slab [rows, NG * 128] of n items (pad columns 0, as
    the score matmul writes them) and each row's top k groups by maximum,
    as group_exact selects them. Eval rows: a third of them rounded to
    quarters (ties), 32 finfo.min blocked columns per row, and the ragged
    tail group selected in every other row."""
    import torch

    from ttamm_torch.ops import kernels

    g = kernels.GROUP
    ng = -(-n // g)
    gen = torch.Generator(device=dev).manual_seed(k)
    s = torch.randn((rows, ng * g), generator=gen, device=dev)
    if eval_rows:
        s[::3] = torch.round(s[::3] * 4) / 4
        blocked = torch.randint(0, n, (rows, 32), generator=gen, device=dev)
        s.scatter_(1, blocked, torch.finfo(torch.float32).min)
    s[:, n:] = 0.0
    gmax = s.view(rows, ng, g).amax(dim=-1)
    gmax[:, -1] = s[:, (ng - 1) * g : n].amax(dim=-1)
    _, gi = kernels.small_k_topk_cuda(gmax, k)
    if eval_rows:
        even = gi[::2]
        even[:, -1] = torch.where((even == ng - 1).any(dim=1), even[:, -1], ng - 1)
    return s, gi


def _select_kernel(dev) -> dict[str, dict]:
    """select_topk_from_groups at its three main-path shapes
    (``select_shapes``), bit-identical to its plain version; each timed
    against the plain version and a gather + torch.topk (time only: its tie
    order differs), its bound one read of each selected 512-byte group row
    and of the group ids and one write of k values and ids. The val eval
    block is the headline row, the other two its ``parts``."""
    import torch

    from ttamm_torch.ops import kernels

    parts = []
    g = kernels.GROUP
    for label, qb, n, k, eval_rows in select_shapes():
        s, gi = select_case(qb, n, k, eval_rows, dev)
        ng = s.shape[1] // g
        kv, ki = kernels.select_topk_from_groups_cuda(s, gi, k=k, num_items=n)
        pv, pi = kernels.select_topk_from_groups_plain(s, gi, k=k, num_items=n)
        torch.cuda.synchronize()
        same = torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)
        check(same, f"select_topk_from_groups [{qb}, {ng * g}] k={k}: kernel != plain")
        sg, gl = s.view(qb, ng, g), gi.long()[:, :, None].expand(-1, -1, g)
        part = _row(
            shape=f"[{qb}, {ng * g}] f32 slab, KG = k = {k} ({label})",
            max_abs_err=float(torch.where(kv == pv, 0.0, (kv - pv).abs()).max()),
            ms=device_ms(lambda: kernels.select_topk_from_groups_cuda(s, gi, k=k, num_items=n)),
            plain_ms=device_ms(
                lambda: kernels.select_topk_from_groups_plain(s, gi, k=k, num_items=n), iters=5
            ),
            library_ms=device_ms(lambda: torch.topk(torch.gather(sg, 1, gl).view(qb, -1), k)),
            nbytes=qb * k * g * 4 + gi.numel() * 4 + qb * k * 8,
        )
        _log_row("select_topk_from_groups", part)
        parts.append(part)
        del s, sg, gl
        torch.cuda.empty_cache()
    return {"select_topk_from_groups": dict(
        parts[0], max_abs_err=max(p["max_abs_err"] for p in parts), parts=parts[1:]
    )}


def _search_kernels(dev) -> dict[str, dict]:
    import torch

    from ttamm_torch.ops import kernels, topk
    from ttamm_torch.ops.topk import SAFETY_GROUPS

    rows: dict[str, dict] = {}
    # small_k_topk at the path's widths: 100k-item group pick (782) and final
    # top-k (20 groups x 128), the fused candidates ((20+4) x 128), the
    # chunked search's merge with the running top-k (2 x 20), the 2M-item
    # group pick (15,625), the headline row, and a chunk of the chunked
    # search (chunk_items(1024)). Bit-identical values and ids; each width
    # timed against its plain version and torch.topk (time only: its tie
    # order differs) over 200 calls up to 16K wide (a 5 us kernel is timed
    # steadily only over many launches; scripts/topk_merge_timing.py gives
    # the spread), its bound one read of the rows and one write of k values
    # and ids.
    parts = []
    chunk = topk.chunk_items(BATCH)
    for width, k in ((782, 20), (2560, 20), (3072, 20), (2 * K, K), (chunk, K), (15625, 24)):
        x = _topk_rows(width, width, dev)
        iters = 200 if width <= 16384 else 10
        kv, ki = kernels.small_k_topk_cuda(x, k)
        pv, pi = kernels.small_k_topk_plain(x, k)
        torch.cuda.synchronize()
        same = torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)
        check(same, f"small_k_topk [{BATCH}, {width}] k={k}: kernel != plain")
        part = _row(
            shape=f"[{BATCH}, {width}] k={k}",
            # equal values (-inf included) differ by 0, not by inf - inf = nan
            max_abs_err=float(torch.where(kv == pv, 0.0, (kv - pv).abs()).max()),
            ms=device_ms(lambda: kernels.small_k_topk_cuda(x, k), iters=iters),
            plain_ms=device_ms(lambda: kernels.small_k_topk_plain(x, k), iters=min(iters, 50)),
            library_ms=device_ms(lambda: torch.topk(x, k, dim=1), iters=iters),
            nbytes=x.numel() * 4 + BATCH * k * 8,
        )
        _log_row("small_k_topk", part)
        parts.append(part)
        del x
    rows["small_k_topk"] = dict(
        parts[-1], max_abs_err=max(p["max_abs_err"] for p in parts), parts=parts[:-1]
    )

    # groupmax_matmul at B=1024, N=2M, D=128 in bf16, unit rows (cosine).
    gen = torch.Generator(device=dev).manual_seed(11)
    items = torch.randn((CORPUS_ROWS, CORPUS_DIM), generator=gen, device=dev)
    items = torch.nn.functional.normalize(items, dim=1).to(torch.bfloat16)
    q = torch.randn((BATCH, CORPUS_DIM), generator=gen, device=dev)
    q = torch.nn.functional.normalize(q, dim=1).to(torch.bfloat16)
    got = kernels.groupmax_matmul_cuda(q, items, CORPUS_ROWS)
    want = kernels.groupmax_matmul_plain(q, items, CORPUS_ROWS)
    err = (got - want).abs()
    check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.abs()).all()),
          f"groupmax_matmul: max abs err {float(err.max()):.3e}")
    # ragged shapes: B and N not tile multiples, D padded, masked tail rows
    small_q, small_i = q[:200, :40].float().contiguous(), items[:3000, :40].float().contiguous()
    e2 = (kernels.groupmax_matmul_cuda(small_q, small_i, 2900)
          - kernels.groupmax_matmul_plain(small_q, small_i, 2900)).abs().max()
    check(float(e2) <= KERNEL_ATOL, f"groupmax_matmul ragged f32: max abs err {float(e2):.3e}")
    ragged_ms = device_ms(lambda: kernels.groupmax_matmul_cuda(small_q, small_i, 2900))
    log(f"groupmax_matmul ragged f32 [200, 40] x [3000, 40]: max abs err {float(e2):.3e} | kernel "
        f"{ragged_ms:.4f} ms = {2.0 * 200 * 3000 * 40 / (ragged_ms * 1e-3) / BF16_FLOPS:.2%} of the "
        "bf16 peak (launch-bound)")
    ng = CORPUS_ROWS // kernels.GROUP

    def library_groupmax():  # cuBLAS slab + group max, in 4 query blocks
        for s in range(0, BATCH, 256):
            (q[s : s + 256] @ items.T).view(-1, ng, kernels.GROUP).amax(-1)

    rows["groupmax_matmul"] = _row(
        shape=f"[{BATCH}, {CORPUS_DIM}] x [{CORPUS_ROWS}, {CORPUS_DIM}] bf16",
        max_abs_err=float(max(err.max(), e2)),
        ms=device_ms(lambda: kernels.groupmax_matmul_cuda(q, items, CORPUS_ROWS), iters=5),
        plain_ms=device_ms(lambda: kernels.groupmax_matmul_plain(q, items, CORPUS_ROWS), iters=3, warmup=1),
        library_ms=device_ms(library_groupmax, iters=3, warmup=1),
        nbytes=(items.numel() + q.numel()) * 2 + got.numel() * 4,
        flops=2.0 * BATCH * CORPUS_ROWS * CORPUS_DIM,
    )
    gm = rows["groupmax_matmul"]
    log(f"groupmax_matmul {gm['shape']}: {2.0 * BATCH * CORPUS_ROWS * CORPUS_DIM / (gm['ms'] * 1e-3) / BF16_FLOPS:.2%} "
        "of the bf16 peak")

    # rescore_groups at the fused path's shapes: the top (k + 4) groups of
    # those maxima.
    kg = K + SAFETY_GROUPS
    _, gi = kernels.small_k_topk_cuda(got, kg)
    grouped = items.view(-1, kernels.GROUP, CORPUS_DIM)
    got_r = kernels.rescore_groups_cuda(q, grouped, gi)
    want_r = kernels.rescore_groups_plain(q, grouped, gi)
    err_r = (got_r - want_r).abs()
    check(bool((err_r <= KERNEL_ATOL + KERNEL_RTOL * want_r.abs()).all()),
          f"rescore_groups: max abs err {float(err_r.max()):.3e}")
    gl = gi.long()
    rows["rescore_groups"] = _row(
        shape=f"[{BATCH}, {CORPUS_DIM}], {kg} groups of {kernels.GROUP} bf16",
        max_abs_err=float(err_r.max()),
        ms=device_ms(lambda: kernels.rescore_groups_cuda(q, grouped, gi)),
        plain_ms=device_ms(lambda: kernels.rescore_groups_plain(q, grouped, gi), iters=3, warmup=1),
        library_ms=device_ms(lambda: torch.bmm(
            grouped[gl].view(BATCH, kg * kernels.GROUP, CORPUS_DIM), q.unsqueeze(-1)
        ), iters=3, warmup=1),
        nbytes=BATCH * kg * kernels.GROUP * CORPUS_DIM * 2 + q.numel() * 2 + gi.numel() * 4
        + got_r.numel() * 4,
        flops=2.0 * BATCH * kg * kernels.GROUP * CORPUS_DIM,
    )
    return rows


def _training_kernels(dev, num_users: int, num_items: int, batch: int, negatives: int,
                      num_categories: int) -> dict[str, dict]:
    """The training step's kernels at its shapes: the row kernels of
    sparse-row Adam on the item table (B * (1 + NEG) lanes; checked here,
    timed in phase 4 on a real step's targets) and the category moments of
    those lanes' embeddings."""
    import torch

    from ttamm_torch.ops import kernels

    rows: dict[str, dict] = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    n, dim = batch * (1 + negatives), 128
    table = torch.randn((num_items + 1, dim), generator=gen, device=dev)  # + scratch row
    scratch = num_items
    # duplicate-heavy indices: a quarter of the lanes on 8 hot rows, and
    # the scratch row
    idx = torch.randint(0, num_items, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[: n // 4] = idx[: n // 4] % 8
    idx[-64:] = scratch
    got, want = kernels.gather_rows_cuda(table, idx), kernels.gather_rows_plain(table, idx)
    check(torch.equal(got, want), "gather_rows: kernel != plain")

    # the coalesced targets: unique rows, every duplicate lane on the scratch row
    uniq = torch.randperm(num_items, generator=gen, device=dev)[:n].to(torch.int32)
    uniq[: n // 4] = scratch
    src = torch.randn((n, dim), generator=gen, device=dev)
    t_kernel, t_plain = table.clone(), table.clone()
    kernels.scatter_set_rows_cuda(t_kernel, uniq, src)
    kernels.scatter_set_rows_plain(t_plain, uniq, src)
    check(torch.equal(t_kernel[:scratch], t_plain[:scratch]), "scatter_set_rows: kernel != plain")
    log(f"gather_rows / scatter_set_rows [{num_items + 1}, {dim}] at {n} duplicate-heavy "
        "indices: bit-identical")
    del t_kernel, t_plain

    # the fused row update at duplicate-heavy lanes (no lane on the scratch
    # row, as a step gives them), coalesced with the non-head lanes masked;
    # its own generator leaves the moments' inputs below as they were
    adam_gen = torch.Generator(device=dev).manual_seed(8)
    table[scratch] = 0.0
    m = torch.randn((num_items + 1, dim), generator=adam_gen, device=dev).abs_() * 0.1
    v = torch.rand((num_items + 1, dim), generator=adam_gen, device=dev) * 0.01
    m[scratch], v[scratch] = 0.0, 0.0
    lanes = idx.clone()
    lanes[-64:] = lanes[:64]
    grads = torch.randn((n, dim), generator=adam_gen, device=dev)
    check_sparse_adam_rows(table, m, v, lanes, grads, "duplicate-heavy lanes")
    del table, m, v

    # category moments: skewed ids (the largest category holds ~30% of the
    # rows), empty categories, a one-member category and ids >= C
    c = num_categories
    ids = torch.clamp(torch.empty(n, device=dev).exponential_(generator=gen) * 6, max=c - 3)
    ids = ids.to(torch.int32)
    ids[ids == 7] = 8  # category 7 empty (and C-1, above the clamp)
    ids[0] = c - 2  # the one member of category C-2
    ids[1:3] = c + 5  # ids >= C add nothing
    x = torch.randn((n, dim), generator=gen, device=dev) * 0.3
    fwd, bwd, err, got, got_b = _moments(ids, x, c, gen, "skewed ids")
    check(bool((got[7] == 0).all()) and bool((got[c - 1] == 0).all()), "empty categories not zero")
    check(bool((got_b[1:3] == 0).all()), "rows with ids >= C got a gradient")
    rows["segment_second_moments"] = dict(
        shape=f"fwd+bwd [{n}, {dim}] f32, C={c}, skewed ids",
        max_abs_err=err,
        ms=fwd["ms"] + bwd["ms"], plain_ms=fwd["plain_ms"] + bwd["plain_ms"],
        library_ms=fwd["library_ms"] + bwd["library_ms"],
        bound_ms=fwd["bound"] + bwd["bound"], bound_by="bytes",
        parts={"fwd": fwd, "bwd": bwd},
    )
    return rows


ADAM_CASES = [(step, wd) for step in (1, 1000) for wd in (0.0, 0.01)]


def check_sparse_adam_rows(table, m, v, lanes, grads, label: str):
    """sparse_adam_rows at ``lanes`` coalesced as ``sparse_adam_update``
    gives them (each touched row on its head lane, every other lane -1):
    table, m and v equal to the plain version's over every row, the
    untouched scratch row included, at steps 1 and 1000 with weight decay 0
    and 0.01. Returns the coalesced ``(target, grads)``."""
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sparse_adam import coalesce_row_grads

    target, summed = coalesce_row_grads(lanes, grads, scratch_row=-1)
    for step, wd in ADAM_CASES:
        hyper = dict(step=step, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
        got, want = [t.clone() for t in (table, m, v)], [t.clone() for t in (table, m, v)]
        kernels.sparse_adam_rows_cuda(*got, target, summed, **hyper)
        kernels.sparse_adam_rows_plain(*want, target, summed, **hyper)
        for name, a, b in zip(("table", "m", "v"), got, want):
            check(torch.equal(a, b), f"sparse_adam_rows ({label}, step {step}, weight decay {wd}): "
                  f"{name} kernel != plain")
    live = int((target >= 0).sum())
    log(f"sparse_adam_rows [{table.shape[0]}, {table.shape[1]}] at {lanes.numel()} {label} "
        f"({live} live after the coalesce), steps 1 / 1000, weight decay 0 / 0.01: table, m, v "
        "bit-identical to the plain version over every row")
    return target, summed


def _moments(ids, x, c: int, gen, label: str):
    """segment_second_moments forward and backward at ``ids`` / ``x`` and a
    random symmetric cotangent: each within M2_TOL of its plain version (of
    each category's largest |M2| entry, of the largest |dx|), then the
    device ms of each direction as the loss calls it (``ms``: the forward
    builds the row grouping, once a loss call, and the backward reuses it),
    of its kernels alone (``kernel_ms``), of its plain version and of the
    einsum, its bound, the grouping's own device ms and its work list.
    Returns ``(fwd, bwd, max abs err, M2, dx)``."""
    import torch

    from ttamm_torch.ops import kernels

    n, dim = x.shape
    grouping = kernels.category_grouping(ids, c)
    check(all(torch.equal(a, b) for a, b in zip(grouping, kernels._group_by_category(ids, c))),
          f"category_grouping ({label}): kernel != plain")
    got = kernels.segment_second_moments_cuda(ids, x, c, grouping)
    want = kernels.segment_second_moments_plain(ids, x, c)
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    err = (got - want).abs()
    check(bool((err <= M2_TOL * scale).all()),
          f"segment_second_moments ({label}): max abs err {float(err.max()):.3e}")
    xd = kernels._bf16(x).double()
    exact = torch.einsum("cn,nd,ne->cde", kernels._selector(ids, c).double(), xd, xd).float()
    off_exact = int((got != exact).sum())  # entries not the exact sum rounded to f32
    h = torch.randn((c, dim, dim), generator=gen, device=x.device)
    h = (h + h.transpose(1, 2)).contiguous()
    got_b = kernels.segment_second_moments_bwd_cuda(ids, x, h, grouping)
    want_b = kernels.segment_second_moments_bwd_plain(ids, x, h)
    err_b = (got_b - want_b).abs()
    check(bool((err_b <= M2_TOL * want_b.abs().max()).all()),
          f"segment_second_moments bwd ({label}): max abs err {float(err_b.max()):.3e}")
    sel = kernels._selector(ids, c)
    xb, hb = kernels._bf16(x), kernels._bf16(h)
    fwd = dict(
        ms=device_ms(lambda: kernels.segment_second_moments_cuda(ids, x, c)),
        kernel_ms=device_ms(lambda: kernels.segment_second_moments_cuda(ids, x, c, grouping)),
        plain_ms=device_ms(lambda: kernels.segment_second_moments_plain(ids, x, c), iters=5),
        library_ms=device_ms(lambda: torch.einsum("cn,nd,ne->cde", sel, xb, xb), iters=5),
        bound=bound_ms(n * dim * 4 + n * 4 + c * dim * dim * 4, 2.0 * n * dim * dim)[0],
    )
    bwd_ms = device_ms(lambda: kernels.segment_second_moments_bwd_cuda(ids, x, h, grouping))
    bwd = dict(
        ms=bwd_ms,
        kernel_ms=bwd_ms,
        plain_ms=device_ms(lambda: kernels.segment_second_moments_bwd_plain(ids, x, h), iters=5),
        library_ms=device_ms(lambda: torch.einsum("cn,ced,nd->ne", sel, hb, xb), iters=5),
        bound=bound_ms(2 * n * dim * 4 + n * 4 + c * dim * dim * 4, 2.0 * n * dim * dim)[0],
    )
    chunks = int(grouping.chunk_offsets[c])  # the chunks of categories [0, C)
    fwd["grouping_ms"] = device_ms(lambda: kernels.category_grouping(ids, c))
    fwd["grouping_plain_ms"] = device_ms(lambda: kernels._group_by_category(ids, c))
    fwd["chunks"] = bwd["chunks"] = chunks
    fwd["off_exact"] = off_exact
    populated = int((grouping.offsets[1 : c + 1] > grouping.offsets[:c]).sum())
    log(f"segment_second_moments [{n}, {dim}] C={c} ({label}): {populated} populated "
        f"categories, {chunks} chunks of {kernels.M2_CHUNK_ROWS} rows; grouping kernel "
        f"{fwd['grouping_ms']:.4f} ms (bit-identical to its plain version, PyTorch ops, "
        f"{fwd['grouping_plain_ms']:.4f} ms); M2 entries off the f64 sum rounded to f32: "
        f"{off_exact} of {got.numel()}")
    for part, r in (("fwd", fwd), ("bwd", bwd)):
        log(f"  {part}: as the loss calls it {r['ms']:.4f} ms (kernels {r['kernel_ms']:.4f} ms) | "
            f"plain {r['plain_ms']:.4f} ms | library {r['library_ms']:.4f} ms | bound "
            f"{r['bound']:.4f} ms")
    return fwd, bwd, float(max(err.max(), err_b.max())), got, got_b


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers to their plain versions (on the card too)."""
    from ttamm_torch.ops import kernels

    names = ("small_k_topk", "select_topk_from_groups", "groupmax_matmul", "rescore_groups",
             "gather_rows", "scatter_set_rows", "sparse_adam_rows", "segment_second_moments",
             "segment_second_moments_bwd")
    saved = {n: getattr(kernels, n) for n in names}
    for n in names:
        setattr(kernels, n, getattr(kernels, f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def _config(data_dir: Path, work: Path, name: str = "default.yaml") -> dict:
    import yaml

    config = yaml.safe_load((REPO / "configs" / name).read_text())
    config["data"]["root"] = str(data_dir)
    config["training"]["num_epochs"] = 2
    config["training"]["checkpointing"]["dir"] = str(work / "checkpoints")
    config["evaluation"]["faiss"]["index_path"] = str(work / "faiss" / "items.index")
    config["evaluation"]["faiss"]["embedding_path"] = str(work / "faiss" / "item_embeddings.npy")
    config["experiment"]["benchmark_report"] = str(work / "reports" / "benchmark_summary.md")
    config["diagnostics"].update(
        report_path=str(work / "reports" / "recommendation_report.md"),
        loss_plot_path=str(work / "reports" / "loss_curve.png"),
        embedding_summary_path=str(work / "reports" / "embedding_diagnostics.json"),
    )
    return config


def phase_corpus(work: Path):
    from ttamm_torch.data import CANONICAL_CORPUS, write_synthetic_csvs
    from ttamm_torch.pipelines.export import prepare_data

    data_dir = work / "data"
    start = time.perf_counter()
    write_synthetic_csvs(data_dir, **CANONICAL_CORPUS)
    log(f"corpus ({CANONICAL_CORPUS}): {time.perf_counter() - start:.2f} s")
    config = _config(data_dir, work)
    start = time.perf_counter()
    dataset = prepare_data(config)
    log(f"data prep: {time.perf_counter() - start:.2f} s | users {len(dataset.user_mapping)} "
        f"items {len(dataset.item_mapping)} F {dataset.item_feature_matrix.shape[1]}")
    return config, dataset


def _step_inputs(dev, config: dict, dataset) -> dict:
    """What one step of ``config`` needs at the canonical scale: the model
    and step configs (its ``comm_dtype`` too), the dataset arrays on the
    card (the feature matrices in ``data.features_dtype``, the train
    split's log q, as the trainer builds it, when the in-batch loss reads
    it) and the train split's (user, item) arrays."""
    import numpy as np
    import torch

    from ttamm_torch.data import (
        build_item_categories, interaction_arrays, pack_positives, split_train_validation_test,
    )
    from ttamm_torch.models.two_tower import parse_model_config
    from ttamm_torch.pipelines.training import features_dtype
    from ttamm_torch.train import BatchData, TrainStepConfig
    from ttamm_torch.train.optim import parse_dense_opt_config

    nu, ni = len(dataset.user_mapping), len(dataset.item_mapping)
    cfg = parse_model_config(
        config["model"], user_feature_dim=dataset.user_feature_matrix.shape[1],
        item_feature_dim=dataset.item_feature_matrix.shape[1],
    )
    cats = build_item_categories(dataset.items, num_items=ni)
    pos = pack_positives(dataset.user_positive_items, num_users=nu, num_items=ni)
    tr = config["training"]
    train_df, _, _ = split_train_validation_test(
        dataset.interactions, train_fraction=config["data"]["train_fraction"],
        test_fraction=config["data"]["test_fraction"], seed=config["experiment"]["seed"],
    )
    log_q = None
    if tr["loss"] == "in_batch_softmax" and tr["logq_correction"]:
        counts = np.bincount(train_df["item_idx"].to_numpy(), minlength=ni).astype(np.float64)
        log_q = torch.from_numpy(np.log(np.maximum(counts, 1.0) / counts.sum()).astype(np.float32))
    feats = features_dtype(config["data"])
    data = BatchData(
        user_features=torch.from_numpy(dataset.user_feature_matrix.astype(np.float32)).to(dev).to(feats),
        item_features=torch.from_numpy(dataset.item_feature_matrix.astype(np.float32)).to(dev).to(feats),
        positive_rows=torch.from_numpy(pos.rows).to(dev),
        category_ids=torch.from_numpy(cats.category_ids).to(dev),
        item_log_q=None if log_q is None else log_q.to(dev),
    )
    tscfg = TrainStepConfig(
        num_items=ni, negatives_per_positive=tr["negatives_per_positive"],
        loss_type=tr["loss"], logq_correction=tr["logq_correction"],
        softmax_temperature=tr["softmax_temperature"],
        lambda_mimic_user=tr["loss_weights"]["mimic_user"],
        lambda_mimic_item=tr["loss_weights"]["mimic_item"],
        lambda_category_alignment=tr["loss_weights"]["category_alignment"],
        cal_max_categories=tr["category_alignment_max_categories"],
        comm_dtype=tr.get("comm_dtype", "float32"),
        opt=parse_dense_opt_config(tr),
    )
    users, items = interaction_arrays(train_df)
    return dict(cfg=cfg, tscfg=tscfg, data=data, users=users, items=items, nu=nu, ni=ni,
                batch=tr["batch_size"])


def _check_steps(label: str, got, got_metrics: dict, want, want_metrics: dict, lanes: dict,
                 *, steps: int = 0, second_rounding: bool = False) -> dict:
    """A step's state and losses held to another run's within phase 4's
    tolerances: losses rtol 1e-5, the sparse tables' touched rows (``lanes``
    by table) atol STEP_ATOL and their Adam moments rtol 1e-4 + atol 1e-9,
    every dense parameter atol STEP_ATOL. Returns the worst row errors.

    ``steps`` > 0 (the bf16 gradient wire, that many steps): the two runs
    sum a lane's float32 gradient in another order, so a lane element near
    a bf16 rounding boundary may round the other way in one of them; Adam
    then moves its row element by up to ~2 lr a step and its moments by a
    bf16 ulp. Such elements (those beyond the tolerances) may be at most
    FLIP_SHARE of a table's touched elements, each row element within
    2.5 lr a step (the JAX package's bf16 bound). ``second_rounding``: the
    owner routing's coalesced totals rounded to bf16 once more (2^-9 of a
    total, where a row had duplicate lanes): rows within STEP_ATOL + steps
    * lr * 2^-8 (Adam's step is lr * m / sqrt(v), whose error stays within
    lr * 2^-8 a step), m within 2^-8 and v within 2^-7 of the largest |m| /
    |v| among the table's touched rows (a step's m and v add gradients of
    both signs, so an element's own value is no scale for its error)."""
    for name in want_metrics:
        g, w = got_metrics[name], want_metrics[name]
        check(math.isfinite(g) and abs(g - w) <= 1e-5 * max(abs(w), 1e-3),
              f"{label} {name}: {g!r} vs {w!r}")
    row_tol = STEP_ATOL + (steps * STEP_LR * 2.0 ** -8 if second_rounding else 0.0)
    worst = {}
    for name, idx in lanes.items():
        diff = (got.tables[name][idx] - want.tables[name][idx]).abs()
        w_err = float(diff.max())
        off = diff > row_tol
        for mom, share in (("m", 2.0 ** -8), ("v", 2.0 ** -7)):
            a = getattr(got.opt_sparse[name], mom)[idx]
            bb = getattr(want.opt_sparse[name], mom)[idx]
            tol = share * bb.abs().max() if second_rounding else 1e-4 * bb.abs()
            off |= (a - bb).abs() > 1e-9 + tol
        flipped = int(off.sum())
        if steps:
            check(flipped <= FLIP_SHARE * off.numel() and w_err <= 2.5 * STEP_LR * steps,
                  f"{label} {name}: {flipped} elements off, rows max abs err {w_err:.3e}")
            worst[f"{name}_flipped"] = flipped
        else:
            check(not flipped, f"{label} {name}: {flipped} row or moment elements differ, rows max "
                  f"abs err {w_err:.3e}")
        worst[name] = w_err
    for (key, a), (_, bb) in zip(got.dense_targets(), want.dense_targets()):
        d_err = float((a.detach() - bb.detach()).abs().max())
        check(d_err <= STEP_ATOL, f"{label} {key}: max abs err {d_err:.3e}")
        worst["dense"] = max(worst.get("dense", 0.0), d_err)
    return worst


def phase_step_vs_plain(dev, config: dict, dataset) -> tuple[dict[str, dict], dict]:
    import torch

    from ttamm_torch.ops.sampling import sample_negative_items
    from ttamm_torch.train import create_train_state, make_train_step

    ctx = _step_inputs(dev, config, dataset)
    cfg, tscfg, data, nu, ni, b = (ctx[k] for k in ("cfg", "tscfg", "data", "nu", "ni", "batch"))
    u = torch.from_numpy(ctx["users"][:b]).to(dev)
    p = torch.from_numpy(ctx["items"][:b]).to(dev)
    neg = sample_negative_items(
        data.positive_rows[u.long()], num_items=ni, num_negatives=tscfg.negatives_per_positive,
        generator=torch.Generator(device=dev).manual_seed(3),
    )
    step = make_train_step(cfg, tscfg)
    results = []
    for plain in (False, True):
        state = create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED, device=dev)
        with plain_kernels() if plain else contextlib.nullcontext():
            state, metrics = step(state, data, u, p, generator=None, negatives=neg)
        torch.cuda.synchronize()
        results.append((state, {k: float(v) for k, v in metrics.items()}))
    (sk, mk), (sp, mp) = results
    item_idx = torch.cat([p, neg.reshape(-1)]).long()
    worst = _check_steps("one step, kernels vs plain", sk, mk, sp, mp,
                         {"user_id": u.long(), "item_id": item_idx})
    log(f"one step, kernels vs plain on the card: losses {mk} | max abs err {worst}")
    context = dict(ctx, item_idx=item_idx, state=sk, inputs=(u, p, neg), metrics=mk)
    rows = _row_kernels(sk.tables["item_id"], item_idx, ni)
    rows["gather_rows"]["parts"] = _forward_reads(sk, {"user_id": u, "item_id": item_idx})
    adam = _sparse_adam_rows(sk, {"item_id": item_idx, "user_id": u.long()}, tscfg)
    rows["sparse_adam_rows"] = dict(adam["item_id"], parts={"user_id": adam["user_id"]})
    # the category moments at this batch's real ids: the item lanes' categories
    ids = data.category_ids[item_idx]
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((item_idx.numel(), 128), generator=gen, device=dev) * 0.3
    fwd, bwd, err, _, _ = _moments(ids, x, tscfg.cal_max_categories, gen, "one canonical batch's ids")
    rows["segment_second_moments_canonical"] = {"fwd": fwd, "bwd": bwd, "max_abs_err": err}
    return rows, context


def _row_kernels(table, lanes, scratch: int) -> dict[str, dict]:
    """gather_rows and scatter_set_rows at the targets sparse-row Adam gives
    them in one step: the step's item lanes coalesced, each row once and
    every duplicate lane on the scratch row. Timed with a cold L2; the bound
    reads (gather) or writes (scatter) each distinct row once, and moves
    every lane's index and payload row."""
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sparse_adam import coalesce_row_grads

    n, dim = lanes.numel(), table.shape[1]
    target, _ = coalesce_row_grads(lanes, torch.zeros((n, 1), device=table.device), scratch_row=scratch)
    distinct = int(torch.unique(target).numel())
    nbytes = n * 4 + (n + distinct) * dim * 4
    shape = f"[{table.shape[0]}, {dim}] f32 at {n} step targets ({distinct} distinct rows)"
    log(f"row kernels on one step's item targets: {n} lanes, {distinct} distinct rows "
        f"(scratch included), {nbytes / 1e6:.3f} MB to move")
    rows: dict[str, dict] = {}
    got, want = kernels.gather_rows_cuda(table, target), kernels.gather_rows_plain(table, target)
    check(torch.equal(got, want), "gather_rows at the step's targets: kernel != plain")
    rows["gather_rows"] = _row(
        shape=shape, max_abs_err=0.0,
        ms=device_ms_cold(lambda: kernels.gather_rows_cuda(table, target)),
        plain_ms=device_ms_cold(lambda: kernels.gather_rows_plain(table, target)),
        library_ms=device_ms_cold(lambda: torch.index_select(table, 0, target)),
        nbytes=nbytes,
    )
    src = got * 0.5
    t_kernel, t_plain = table.clone(), table.clone()
    kernels.scatter_set_rows_cuda(t_kernel, target, src)
    kernels.scatter_set_rows_plain(t_plain, target, src)
    check(torch.equal(t_kernel[:scratch], t_plain[:scratch]),
          "scatter_set_rows at the step's targets: kernel != plain")
    tl = target.long()
    rows["scatter_set_rows"] = _row(
        shape=shape, max_abs_err=0.0,
        ms=device_ms_cold(lambda: kernels.scatter_set_rows_cuda(t_kernel, target, src)),
        plain_ms=device_ms_cold(lambda: kernels.scatter_set_rows_plain(t_plain, target, src)),
        library_ms=device_ms_cold(lambda: t_plain.index_copy_(0, tl, src)),
        nbytes=nbytes,
    )
    for name, row in rows.items():
        _log_row(name, row)
    return rows


def _forward_reads(state, lanes: dict) -> dict[str, dict]:
    """gather_rows at the sparse ID tables' forward reads of one step (every
    lane, duplicates included), equal to index_select and timed against it
    with a cold L2; the bound reads each lane's index and each distinct row
    once, and writes every lane's row (as ``_row_kernels``)."""
    import torch

    from ttamm_torch.ops import kernels

    parts = {}
    for name, lane in lanes.items():
        table, idx = state.tables[name], lane.to(torch.int32)
        n, distinct = idx.numel(), int(torch.unique(idx).numel())
        check(torch.equal(kernels.gather_rows_cuda(table, idx), torch.index_select(table, 0, idx)),
              f"gather_rows at the {name} forward reads != index_select")
        parts[f"forward_{name}"] = dict(
            lanes=n, distinct=distinct,
            ms=device_ms_cold(lambda: kernels.gather_rows_cuda(table, idx)),
            library_ms=device_ms_cold(lambda: torch.index_select(table, 0, idx)),
            bound_ms=bound_ms(n * 4 + (distinct + n) * table.shape[1] * 4)[0],
        )
        log(f"gather_rows at the {name} forward reads ({n} lanes, {distinct} distinct rows): kernel "
            f"{parts[f'forward_{name}']['ms']:.4f} ms | index_select "
            f"{parts[f'forward_{name}']['library_ms']:.4f} ms | bound "
            f"{parts[f'forward_{name}']['bound_ms']:.4f} ms")
    return parts


def _sparse_adam_rows(state, lanes: dict, tscfg) -> dict:
    """sparse_adam_rows at one step's item and user lanes (the item table
    the headline row, the user table its ``parts``): held to its plain
    version (``check_sparse_adam_rows``), then timed with a cold L2 at the
    next step's hyperparameters beside its plain version and the composition
    it replaces on the card (the row's ``library_ms``: no single PyTorch call
    computes the fused update): the coalesce with every
    duplicate lane on the scratch row, gather_rows x 3, eager adam_rows,
    scatter_set_rows x 3, the coalesce itself outside every timing. The
    bound moves every lane's index, the step's scalars and, for each live
    lane, its gradient row in and its table, m and v rows in and out."""
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sparse_adam import coalesce_row_grads, unfused_row_update

    opt = tscfg.opt
    out = {}
    for name, lane in lanes.items():
        table, sparse = state.tables[name], state.opt_sparse[name]
        n, dim = lane.numel(), table.shape[1]
        gen = torch.Generator(device=table.device).manual_seed(17)
        grads = torch.randn((n, dim), generator=gen, device=table.device) * 1e-2
        target, summed = check_sparse_adam_rows(table, sparse.m, sparse.v, lane, grads,
                                                f"one step's {name} lanes")
        scratch_target, scratch_summed = coalesce_row_grads(lane, grads, scratch_row=table.shape[0] - 1)
        hyper = kernels.adam_row(table.device, step=sparse.step + 1, lr=opt.lr, b1=opt.b1,
                                 b2=opt.b2, eps=1e-8, weight_decay=tscfg.sparse_weight_decay)
        copies = [t.clone() for t in (table, sparse.m, sparse.v)]

        def composition():
            unfused_row_update(*copies, scratch_target, scratch_summed,
                               gather=kernels.gather_rows_cuda,
                               scatter=kernels.scatter_set_rows_cuda, **hyper)

        live = int((target >= 0).sum())
        out[name] = _row(
            shape=f"[{table.shape[0]}, {dim}] f32 table, m, v at one step's {n} {name} lanes "
                  f"({live} live)",
            max_abs_err=0.0,
            ms=device_ms_cold(lambda: kernels.sparse_adam_rows_cuda(*copies, target, summed, **hyper)),
            plain_ms=device_ms_cold(lambda: kernels.sparse_adam_rows_plain(*copies, target, summed, **hyper)),
            library_ms=device_ms_cold(composition),
            nbytes=n * 4 + live * dim * 4 * 7 + kernels.ADAM_SCALARS * 4,
        )
        out[name].update(lanes=n, live=live)
        _log_row(f"sparse_adam_rows ({name}; library = the composition it replaces)", out[name])
        del copies
    return out


def _mesh_layouts(table, m, v, lanes):
    """One canonical step's item lanes as the mesh path gives them to its
    kernels, on the item table padded to VIRTUAL_SHARDS shards: ``lookups``
    (each shard's rows, the step's global ids in batch order, the shard's
    base; then the whole table at 1x1, every lane owned), ``updates`` (each
    shard's rows of table, m and v, the lanes coalesced and localized with
    the non-heads and the foreign lanes -1, which sit at the head and the
    tail, the run totals, and the same lanes before head masking; then the
    owner buffer at 1x1: each row once, ascending, then a sentinel tail)."""
    import torch

    from ttamm_torch.parallel.sharding import padded_rows
    from ttamm_torch.parallel.sparse_update import _localize, owner_capacity, sort_lanes

    n, dim = lanes.numel(), table.shape[1]
    rows_total = padded_rows(table.shape[0] - 1, VIRTUAL_SHARDS)

    def pad(t):
        return torch.cat([t, t.new_zeros((rows_total - t.shape[0], dim))])

    padded = [pad(t) for t in (table, m, v)]
    rps = rows_total // VIRTUAL_SHARDS
    gen = torch.Generator(device=table.device).manual_seed(17)
    grads = torch.randn((n, dim), generator=gen, device=table.device) * 1e-2
    runs = sort_lanes(lanes.long(), grads, head_init=-2)
    totals = runs.totals()
    lookups, updates = [], []
    for s in range(VIRTUAL_SHARDS):
        part = slice(s * rps, (s + 1) * rps)
        lookups.append((padded[0][part], lanes, s * rps))
        updates.append(dict(
            tensors=[t[part] for t in padded], totals=totals,
            heads=_localize(runs.idx, s * rps, rps, runs.is_head),
            every=_localize(runs.idx, s * rps, rps),
        ))
    heads = runs.idx[runs.is_head].to(torch.int32)
    owner = torch.full((owner_capacity(n, 1, 1, 2.0),), -1, dtype=torch.int32, device=table.device)
    owner[: heads.numel()] = heads
    owner_grads = torch.zeros((owner.numel(), dim), device=table.device)
    owner_grads[: heads.numel()] = totals[runs.is_head]
    return dict(
        rps=rps, lookups=lookups, lookup_1x1=(table, lanes, 0), updates=updates,
        owner=dict(tensors=[table, m, v], totals=owner_grads, heads=owner, every=owner),
    )


def _lookup_gather(layouts) -> dict:
    """gather_rows_masked at the lookup's lanes of each shard (the row: the
    mean a shard, the four in one timed call) and at 1x1 (``parts``):
    bit-identical to its plain version on every lane, zeros included; timed
    with a cold L2 beside the lookup it replaced (``index_select`` of the
    clamped lanes, then ``where``: the row's ``library_ms``). The bound
    reads every lane's index and each owned distinct row once, and writes
    every lane's row."""
    import torch

    from ttamm_torch.ops import kernels

    def parent(local, idx, base):
        lane = idx.long() - base
        owned = (lane >= 0) & (lane < local.shape[0])
        return torch.where(owned[:, None], torch.index_select(local, 0, torch.where(owned, lane, 0)), 0.0)

    def measure(group):
        nbytes = 0
        for local, idx, base in group:
            got = kernels.gather_rows_cuda(local, idx, masked=True, base=base)
            check(torch.equal(got, kernels.gather_rows_plain(local, idx, masked=True, base=base)),
                  f"gather_rows_masked (base {base}): kernel != plain")
            check(torch.equal(got, parent(local, idx, base)), f"gather_rows_masked (base {base}) != lookup")
            lane = idx.long() - base
            owned = lane[(lane >= 0) & (lane < local.shape[0])]
            distinct = int(torch.unique(owned).numel())
            nbytes += idx.numel() * 4 + (distinct + idx.numel()) * local.shape[1] * 4
            log(f"gather_rows_masked at the lookup (base {base}): {idx.numel()} lanes, {owned.numel()} "
                f"owned, {distinct} distinct rows: bit-identical to plain and to the lookup")
        k = len(group)
        return dict(
            max_abs_err=0.0,
            ms=device_ms_cold(lambda: [kernels.gather_rows_cuda(l, i, masked=True, base=b)
                                       for l, i, b in group]) / k,
            plain_ms=device_ms_cold(lambda: [kernels.gather_rows_plain(l, i, masked=True, base=b)
                                             for l, i, b in group]) / k,
            library_ms=device_ms_cold(lambda: [parent(*c) for c in group]) / k,
            nbytes=nbytes / k,
        )

    local, idx, _ = layouts["lookups"][0]
    row = _row(shape=f"[{local.shape[0]}, {local.shape[1]}] f32 shard of {VIRTUAL_SHARDS} at one step's "
                     f"{idx.numel()} item lookup lanes (mean per shard)", **measure(layouts["lookups"]))
    one = measure([layouts["lookup_1x1"]])
    one["bound_ms"] = bound_ms(one.pop("nbytes"))[0]
    row["parts"] = {"1x1": one}
    _log_row("gather_rows_masked (library = index_select + where, the lookup it replaced)", row)
    log(f"  gather_rows_masked at 1x1 (every lane owned): kernel {one['ms']:.4f} ms | plain "
        f"{one['plain_ms']:.4f} ms | library {one['library_ms']:.4f} ms | bound {one['bound_ms']:.4f} ms")
    return row


def _masked_scatter(layouts) -> dict:
    """scatter_set_rows_masked, which no path runs since the sharded update
    moved onto sparse_adam_rows, at the lanes the update gave it before (each
    shard's lanes localized, every lane of a run carrying the run's bytes;
    the owner buffer at 1x1): bit-identical to its plain version on every
    row, timed with a cold L2; the bound moves every lane's index and each
    owned lane's row and owned distinct row once. The library call
    (``index_copy_`` over the lanes clamped to 0) computes another function:
    time only."""
    import torch

    from ttamm_torch.ops import kernels

    def cases(group):
        out, nbytes = [], 0
        for u in group:
            table, lane = u["tensors"][0], u["every"]
            live = lane >= 0
            owned, distinct = int(live.sum()), int(torch.unique(lane[live]).numel())
            nbytes += lane.numel() * 4 + (owned + distinct) * table.shape[1] * 4
            src = u["totals"]  # every lane of a run carries its bytes
            t_kernel, t_plain = table.clone(), table.clone()
            kernels.scatter_set_rows_cuda(t_kernel, lane, src, masked=True)
            kernels.scatter_set_rows_plain(t_plain, lane, src, masked=True)
            check(torch.equal(t_kernel, t_plain), "scatter_set_rows_masked: kernel != plain")
            out.append((t_kernel, lane, src))
        return out, nbytes

    shard_cases, nbytes = cases(layouts["updates"])
    owner_cases, o_bytes = cases([layouts["owner"]])
    k = len(shard_cases)
    row = _row(
        shape=f"[{layouts['rps']}, {shard_cases[0][0].shape[1]}] f32 shard of {VIRTUAL_SHARDS} at one "
              f"step's {shard_cases[0][1].numel()} item lanes coalesced (mean per shard)",
        max_abs_err=0.0,
        ms=device_ms_cold(lambda: [kernels.scatter_set_rows_cuda(*c, masked=True) for c in shard_cases]) / k,
        plain_ms=device_ms_cold(lambda: [kernels.scatter_set_rows_plain(*c, masked=True)
                                         for c in shard_cases]) / k,
        library_ms=device_ms_cold(lambda: [t.index_copy_(0, lane.clamp_min(0).long(), src)
                                           for t, lane, src in shard_cases]) / k,
        nbytes=nbytes / k,
    )
    row["parts"] = {"owner_1x1": dict(
        ms=device_ms_cold(lambda: [kernels.scatter_set_rows_cuda(*c, masked=True) for c in owner_cases]),
        bound_ms=bound_ms(o_bytes)[0],
    )}
    _log_row("scatter_set_rows_masked (compared only)", row)
    return row


def _mesh_sparse_adam(layouts) -> dict:
    """sparse_adam_rows at the sharded update's lanes: each shard's
    (``mesh_shard_of_4``, the mean a shard, the four in one timed call) and
    the owner buffer at 1x1 (``mesh_owner_1x1``). Bit-identical to its plain
    version over every row at steps 1 and 1000, weight decay 0 and 0.01;
    timed with a cold L2 at step 2 beside its plain version and the
    composition it replaces on the mesh path (the masked gathers x 3, eager
    adam_rows and the masked scatters x 3 at the lanes before head masking:
    ``composition_ms``). The bound moves every lane's index and, for each
    live lane, its gradient row in and its table, m and v rows in and out."""
    import functools

    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sparse_adam import unfused_row_update

    parts = {}
    for label, group in (("mesh_shard_of_4", layouts["updates"]), ("mesh_owner_1x1", [layouts["owner"]])):
        for u in group:
            for step, wd in ADAM_CASES:
                hyper = dict(step=step, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
                got = [t.clone() for t in u["tensors"]]
                want = [t.clone() for t in u["tensors"]]
                kernels.sparse_adam_rows_cuda(*got, u["heads"], u["totals"], **hyper)
                kernels.sparse_adam_rows_plain(*want, u["heads"], u["totals"], **hyper)
                for name, a, b in zip(("table", "m", "v"), got, want):
                    check(torch.equal(a, b), f"sparse_adam_rows ({label}, step {step}, weight decay "
                          f"{wd}): {name} kernel != plain")
        hyper = kernels.adam_row(group[0]["tensors"][0].device, step=2, lr=1e-3, b1=0.9, b2=0.999,
                                 eps=1e-8, weight_decay=0.0)
        copies = [[t.clone() for t in u["tensors"]] for u in group]
        lanes = [(u["heads"], u["totals"], u["every"]) for u in group]
        k = len(group)

        def composition():
            for c, (_, totals, every) in zip(copies, lanes):
                unfused_row_update(*c, every, totals,
                                   gather=functools.partial(kernels.gather_rows_cuda, masked=True),
                                   scatter=functools.partial(kernels.scatter_set_rows_cuda, masked=True),
                                   **hyper)

        live = sum(int((h >= 0).sum()) for h, _, _ in lanes)
        dim = group[0]["tensors"][0].shape[1]
        parts[label] = dict(
            ms=device_ms_cold(lambda: [kernels.sparse_adam_rows_cuda(*c, h, t, **hyper)
                                       for c, (h, t, _) in zip(copies, lanes)]) / k,
            plain_ms=device_ms_cold(lambda: [kernels.sparse_adam_rows_plain(*c, h, t, **hyper)
                                             for c, (h, t, _) in zip(copies, lanes)]) / k,
            composition_ms=device_ms_cold(composition) / k,
            bound_ms=bound_ms((sum(h.numel() for h, _, _ in lanes) * 4 + live * dim * 4 * 7) / k
                              + kernels.ADAM_SCALARS * 4)[0],
            lanes=int(lanes[0][0].numel()), live=live / k,
        )
        p = parts[label]
        log(f"sparse_adam_rows ({label}; {p['lanes']} lanes, {p['live']:.1f} live a shard; bit-identical "
            f"at steps 1 / 1000, weight decay 0 / 0.01): kernel {p['ms']:.4f} ms | plain "
            f"{p['plain_ms']:.4f} ms | composition it replaces {p['composition_ms']:.4f} ms | bound "
            f"{p['bound_ms']:.4f} ms")
        del copies
    return parts


def _shard_loop(ctx, lanes) -> None:
    """One sparse-Adam update of the item table applied shard by shard (the
    allgather routing's body, one ``sparse_adam_rows`` launch on each of
    VIRTUAL_SHARDS row slices of the padded table) against the
    single-device ``sparse_adam_update``: bit-identical table, m and v (the
    same coalesce order and per-row arithmetic), the scratch row aside (the
    single-device update leaves it untouched; a shard's pad rows stay
    zero)."""
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sparse_adam import SparseAdamState, sparse_adam_update
    from ttamm_torch.parallel.sharding import padded_rows
    from ttamm_torch.parallel.sparse_update import _apply, _localize, sort_lanes

    state, ni, opt = ctx["state"], ctx["ni"], ctx["tscfg"].opt
    table, sparse = state.tables["item_id"], state.opt_sparse["item_id"]
    n, dim = lanes.numel(), table.shape[1]
    grads = torch.randn((n, dim), generator=torch.Generator(device=table.device).manual_seed(13),
                        device=table.device) * 1e-2
    ref = SparseAdamState(m=sparse.m.clone(), v=sparse.v.clone(), step=sparse.step)
    ref_table = table.clone()
    sparse_adam_update(ref_table, ref, lanes, grads, lr=opt.lr, b1=opt.b1, b2=opt.b2)
    hyper = kernels.adam_row(table.device, step=ref.step, lr=opt.lr, b1=opt.b1, b2=opt.b2, eps=1e-8,
                             weight_decay=0.0)
    rows_total = padded_rows(ni, VIRTUAL_SHARDS)
    rps = rows_total // VIRTUAL_SHARDS

    def pad(t):
        return torch.cat([t, t.new_zeros((rows_total - t.shape[0], dim))])

    tab, m, v = pad(table), pad(sparse.m), pad(sparse.v)
    runs = sort_lanes(lanes.long(), grads, head_init=-2)
    totals = runs.totals()
    before = kernels.launch_counts()
    for s in range(VIRTUAL_SHARDS):
        rows = slice(s * rps, (s + 1) * rps)
        local = SparseAdamState(m=m[rows], v=v[rows], step=sparse.step)
        _apply(tab[rows], local, _localize(runs.idx, s * rps, rps, runs.is_head), totals, **hyper)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    check(after["sparse_adam_rows"] - before["sparse_adam_rows"] == VIRTUAL_SHARDS,
          "shard loop: not one sparse_adam_rows launch a shard")
    for name, got, want in (("table", tab, ref_table), ("m", m, ref.m), ("v", v, ref.v)):
        err = float((got[:ni] - want[:ni]).abs().max())
        check(torch.equal(got[:ni], want[:ni]), f"shard loop {name}: max abs err {err:.3e}")
        check(not bool(got[ni + 1 :].any()), f"shard loop {name}: a pad row was written")
    log(f"shard loop: {VIRTUAL_SHARDS} shards of {rps} rows, {n} lanes, one sparse_adam_rows a shard: "
        "table, m and v bit-identical to the single-device sparse_adam_update")


def _parent_apply(table, state, lane_idx, grads, *, scalars, decay) -> None:
    """The shard-local row update before sparse_adam_rows took it: the
    masked gathers of m, v and the weights, eager adam_rows (at the step's
    scalar row), the masked scatters back (given head-only lanes, it writes
    what it wrote at every lane of a run: the run's bytes)."""
    import functools

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sparse_adam import unfused_row_update

    unfused_row_update(
        table, state.m, state.v, lane_idx, grads,
        gather=functools.partial(kernels.gather_rows, masked=True),
        scatter=functools.partial(kernels.scatter_set_rows, masked=True), scalars=scalars,
        decay=decay,
    )


@contextlib.contextmanager
def parent_mesh_path():
    """The mesh step's row traffic as it was before the masked gather and
    sparse_adam_rows took it: the sparse tables read by ``sharded_rows``
    (``index_select``, then ``where`` and zeros above one model shard), the
    mimic tables by ``index_select`` and ``where``, the sparse update by
    :func:`_parent_apply`. The replica the 1x1 steps are held to, bit for
    bit, and timed beside."""
    import torch

    from ttamm_torch.parallel import embedding_lookup as el
    from ttamm_torch.parallel import sparse_update as su
    from ttamm_torch.parallel.mesh import MODEL_AXIS, all_reduce, axis_size

    class ParentLookup(el._ShardedLookup):
        @staticmethod
        def forward(ctx, local, idx, mesh, wire_dtype, lanes):
            owned, lane = el._owned(local.shape[0], idx, mesh)
            ctx.save_for_backward(idx)
            ctx.mesh, ctx.rows, ctx.wire, ctx.lanes = mesh, local.shape[0], wire_dtype, lanes
            rows = torch.where(owned[:, None], torch.index_select(local, 0, lane), 0.0)
            if axis_size(mesh, MODEL_AXIS) > 1:
                all_reduce(rows, mesh, MODEL_AXIS)
            return rows

    saved = (su._apply, el.sharded_table_rows, el.sharded_lookup)
    su._apply, el.sharded_table_rows = _parent_apply, el.sharded_rows
    el.sharded_lookup = ParentLookup.apply
    try:
        yield
    finally:
        su._apply, el.sharded_table_rows, el.sharded_lookup = saved


def _mesh_step(dev, ctx) -> tuple[dict[str, int], dict]:
    """The sharded step on a 1x1 DeviceMesh over a one-rank NCCL group at
    ``configs/default.yaml`` width: MESH_STEPS steps from the seeded state
    under the allgather and the owner routing (the launches of these six
    steps are the path's counts), each against the single-device step on the
    same batches and negatives, no dropout, within phase 4's tolerances, and
    against the same steps through :func:`parent_mesh_path`, bit for bit
    (losses, every table, moment and dense parameter); then each step's
    device ms and device ops (profiler) and host ms (clock) beside the
    single-device step's and the parent path's."""

    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sampling import sample_negative_items
    from ttamm_torch.parallel import MeshConfig, build_mesh, place_data, place_state
    from ttamm_torch.parallel.sparse_update import owner_stats, reset_owner_stats
    from ttamm_torch.parallel.step import make_sharded_train_step
    from ttamm_torch.train import create_train_state, make_train_step

    cfg, tscfg, data = ctx["cfg"], ctx["tscfg"], ctx["data"]
    nu, ni, b = ctx["nu"], ctx["ni"], ctx["batch"]
    users, items = ctx["users"], ctx["items"]
    batches = []
    for s in range(MESH_STEPS + 8):  # the compared steps, then the timed ones
        u = torch.from_numpy(users[s * b : (s + 1) * b]).to(dev)
        p = torch.from_numpy(items[s * b : (s + 1) * b]).to(dev)
        neg = sample_negative_items(
            data.positive_rows[u.long()], num_items=ni, num_negatives=tscfg.negatives_per_positive,
            generator=torch.Generator(device=dev).manual_seed(100 + s),
        )
        batches.append((u, p, neg))

    def fresh():
        return create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED, device=dev)

    def run(step, state, d, path=contextlib.nullcontext):
        out = []
        with path():
            for u, p, neg in batches[:MESH_STEPS]:
                _, metrics = step(state, d, u, p, generator=None, negatives=neg)
                out.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        return out

    with one_rank_nccl():
        reset_owner_stats()
        mesh = build_mesh(MeshConfig(1, 1), "cuda")
        mdata = place_data(mesh, data)
        steps = {r: make_sharded_train_step(cfg, tscfg._replace(update_routing=r), mesh)
                 for r in ("allgather", "owner")}
        runs = {r: (place_state(mesh, fresh()), stp) for r, stp in steps.items()}
        kernels.reset_launch_counts()  # the path's launches: the sharded steps
        losses = {r: run(stp, state, mdata) for r, (state, stp) in runs.items()}
        counts = kernels.launch_counts()
        parents = {r: (place_state(mesh, fresh()), stp) for r, stp in steps.items()}
        for routing, (state, stp) in parents.items():
            want = run(stp, state, mdata, parent_mesh_path)
            check(want == losses[routing], f"1x1 {routing}: losses {losses[routing]} != parent path {want}")
            got_state = runs[routing][0]
            pairs = [(f"{n} table", got_state.tables[n], state.tables[n]) for n in state.tables]
            pairs += [(f"{n} {mom}", getattr(got_state.opt_sparse[n], mom), getattr(s, mom))
                      for n, s in state.opt_sparse.items() for mom in ("m", "v")]
            pairs += [(k, a.detach(), bb.detach()) for (k, a), (_, bb) in
                      zip(got_state.dense_targets(), state.dense_targets())]
            for name, a, bb in pairs:
                check(torch.equal(a, bb), f"1x1 {routing} {name}: differs from the parent path")
            log(f"1x1 sharded step ({routing}), {MESH_STEPS} steps: losses and {len(pairs)} state "
                "tensors bit-identical to the parent path")
        ref_state, ref_step = fresh(), make_train_step(cfg, tscfg)
        ref_losses = run(ref_step, ref_state, data)
        touched = {
            "user_id": torch.cat([u for u, _, _ in batches[:MESH_STEPS]]).long(),
            "item_id": torch.cat([torch.cat([p, neg.reshape(-1)]) for _, p, neg in
                                  batches[:MESH_STEPS]]).long(),
        }
        for routing, (state, _) in runs.items():
            worst = 0.0
            for got, want in zip(losses[routing], ref_losses):
                for name in want:
                    check(abs(got[name] - want[name]) <= 1e-5 * max(abs(want[name]), 1e-3),
                          f"1x1 {routing} {name}: {got[name]!r} vs one device {want[name]!r}")
                    worst = max(worst, abs(got[name] - want[name]))
            errs = {}
            for name, idx in touched.items():
                errs[name] = float((state.tables[name][idx] - ref_state.tables[name][idx]).abs().max())
                check(errs[name] <= STEP_ATOL, f"1x1 {routing} {name} rows: max abs err {errs[name]:.3e}")
                for mom in ("m", "v"):
                    a = getattr(state.opt_sparse[name], mom)[idx]
                    bb = getattr(ref_state.opt_sparse[name], mom)[idx]
                    check(bool(((a - bb).abs() <= 1e-9 + 1e-4 * bb.abs()).all()),
                          f"1x1 {routing} {name} {mom}: differ")
            for (key, a), (_, bb) in zip(state.dense_targets(), ref_state.dense_targets()):
                err = float((a.detach() - bb.detach()).abs().max())
                check(err <= STEP_ATOL, f"1x1 {routing} {key}: max abs err {err:.3e}")
                errs["dense"] = max(errs.get("dense", 0.0), err)
            log(f"1x1 sharded step ({routing}) vs one device, {MESH_STEPS} steps: losses max abs "
                f"diff {worst:.3e} | max abs err {errs}")

        timing = {}
        timed = {"one device": (ref_state, ref_step, data, contextlib.nullcontext)}
        for r in runs:
            timed[f"1x1 {r}"] = (*runs[r], mdata, contextlib.nullcontext)
            timed[f"1x1 {r} (parent path)"] = (*parents[r], mdata, parent_mesh_path)
        for label, (state, step, d, path) in timed.items():
            it = iter(batches[MESH_STEPS:])

            def one(state=state, step=step, d=d, it=it):
                u, p, neg = next(it)
                step(state, d, u, p, generator=None, negatives=neg)

            with path():
                events = _profiled(one, lambda: [one() for _ in range(4)])
                dev_ms = _per_call_us(events, 4) / 1e3
                check(dev_ms > 0, f"step {label}: the profiler saw no device work")
                ops = sum(e.count for e in events if _on_card(e)) / 4
                u, p, neg = batches[-1]
                torch.cuda.synchronize()
                start = time.perf_counter()
                for _ in range(3):
                    step(state, d, u, p, generator=None, negatives=neg)
                torch.cuda.synchronize()
            timing[label] = {"device_ms": dev_ms, "device_ops": ops,
                             "host_ms": (time.perf_counter() - start) / 3 * 1e3}
            log(f"step {label}: device {dev_ms:.3f} ms, {ops:.1f} device ops | host clock "
                f"{timing[label]['host_ms']:.3f} ms")
        stats = owner_stats()  # the device counters, read once
        log(f"owner routing: {stats['checks']} overflow checks (on the device, no host sync), "
            f"{stats['overflows']} overflows")
        timing["owner_stats"] = stats
    return counts, timing


def phase_mesh(dev, ctx) -> tuple[dict[str, dict], dict[str, int], dict[str, int], dict]:
    """Phase 4b: the multi-device layer on one card. Returns the kernel
    rows, the launches of the comparisons before the sharded steps, the
    sharded steps' launches (the path's counts) and their timing."""
    import torch

    from ttamm_torch.ops import kernels

    lanes = ctx["item_idx"].to(torch.int32)
    state = ctx["state"]
    sparse = state.opt_sparse["item_id"]
    layouts = _mesh_layouts(state.tables["item_id"], sparse.m, sparse.v, lanes)
    rows = {"gather_rows_masked": _lookup_gather(layouts),
            "scatter_set_rows_masked": _masked_scatter(layouts)}
    adam_parts = _mesh_sparse_adam(layouts)
    del layouts
    _shard_loop(ctx, lanes)
    compared = kernels.launch_counts()
    counts, timing = _mesh_step(dev, ctx)
    for name in ("gather_rows_masked", "sparse_adam_rows", "segment_second_moments"):
        check(counts[name] > 0, f"{name} never launched in the 1x1 sharded steps")
    for name in ("gather_rows", "scatter_set_rows", "scatter_set_rows_masked"):
        check(counts[name] == 0, f"{name} launched in the 1x1 sharded steps")
    log(f"launch counts of the 1x1 sharded steps: {counts}")
    timing["sparse_adam_rows"] = adam_parts
    return rows, compared, counts, timing


@contextlib.contextmanager
def one_rank_nccl():
    """A one-rank NCCL process group on this card, destroyed on exit."""
    import datetime
    import socket

    import torch
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300),
        device_id=torch.device("cuda", torch.cuda.current_device()),
    )
    try:
        yield
    finally:
        from ttamm_torch.ops import device_cond

        # the graphs that hold the group's collectives go before it
        device_cond.clear()
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


def _same_state(label: str, got, want) -> int:
    """``got`` equal to ``want`` bit for bit: every table, dense parameter,
    dense moment and sparse moment. Returns the number of tensors compared."""
    import torch

    pairs = [(f"{n} table", got.tables[n], want.tables[n]) for n in want.tables]
    pairs += [(k, a.detach(), bb.detach()) for (k, a), (_, bb) in
              zip(got.dense_targets(), want.dense_targets())]
    pairs += [(f"dense m {i}", a, bb) for i, (a, bb) in enumerate(zip(got.opt_dense.m, want.opt_dense.m))]
    pairs += [(f"dense v {i}", a, bb) for i, (a, bb) in enumerate(zip(got.opt_dense.v, want.opt_dense.v))]
    for n, s in want.opt_sparse.items():
        pairs += [(f"{n} m", got.opt_sparse[n].m, s.m), (f"{n} v", got.opt_sparse[n].v, s.v)]
        check(got.opt_sparse[n].step == s.step, f"{label} {n}: sparse step {got.opt_sparse[n].step} != {s.step}")
    for name, a, bb in pairs:
        check(torch.equal(a, bb), f"{label} {name}: not bit for bit")
    return len(pairs)


def phase_packed(dev, ctx, work: Path) -> dict:
    """Phase 4c: ``training.packed_moments: true``, which sets the
    checkpoints' moment leaves (the JAX packed layout: one ``[rows, 2D]``
    ``mv`` = [m | v] a sparse table); in memory the moments stay two
    tensors. One step of ``configs/default.yaml`` from phase 4's seeded
    state, batch and negatives with the option set, equal bit for bit to
    phase 4's step (the launches of this step, counted from zero just before
    it, are this path's: sparse_adam_rows and gather_rows once a sparse
    table); then its flat and sharded checkpoints hold ``mv`` and no ``m``
    or ``v``, with ``mv`` = [m | v] of the state, and restore bit for bit
    into a packed and a separate state. Returns a summary."""
    import numpy as np
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.train import create_train_state, make_train_step
    from ttamm_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from ttamm_torch.train.sharded_checkpoint import load_sharded_checkpoint, save_sharded_checkpoint
    from ttamm_torch.train.state import sparse_table_names

    cfg, tscfg, data, nu, ni = (ctx[k] for k in ("cfg", "tscfg", "data", "nu", "ni"))
    tables = sparse_table_names(cfg)

    def fresh(packed):
        return create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED, device=dev,
                                  packed_moments=packed)

    u, p, neg = ctx["inputs"]
    state = fresh(True)
    kernels.reset_launch_counts()  # this path's launches: the packed step
    state, metrics = make_train_step(cfg, tscfg)(state, data, u, p, generator=None, negatives=neg)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check(launches["sparse_adam_rows"] == len(tables) and launches["gather_rows"] == len(tables)
          and launches["scatter_set_rows"] == 0, f"packed step launches: {launches}")
    metrics = {k: float(v) for k, v in metrics.items()}
    check(metrics == ctx["metrics"], f"packed step losses {metrics} != separate {ctx['metrics']}")
    compared = _same_state("one packed step", state, ctx["state"])
    log(f"one step with training.packed_moments: losses and {compared} state tensors bit-identical "
        f"to phase 4's step | launches {launches}")

    names = dict(experiment_name="packed", epoch=1, metric_name=None, metric_value=None)
    flat_path = save_checkpoint(work / "packed_flat", state, **names)
    with np.load(flat_path) as blob:
        for n in tables:
            check(f"opt_sparse/{n}/m" not in blob.files and f"opt_sparse/{n}/v" not in blob.files,
                  f"packed checkpoint holds opt_sparse/{n}/m or v")
            s = state.opt_sparse[n]
            check(np.array_equal(blob[f"opt_sparse/{n}/mv"], torch.cat([s.m, s.v], 1).cpu().numpy()),
                  f"packed checkpoint: opt_sparse/{n}/mv != [m | v]")
    sharded_path = save_sharded_checkpoint(work / "packed_sharded", state, **names)
    restored = 0
    for path, load in ((flat_path, load_checkpoint), (sharded_path, load_sharded_checkpoint)):
        for packed in (True, False):
            back, _ = load(path, fresh(packed))
            restored += _same_state(f"{path.name} into packed={packed}", back, state)
    log(f"flat and sharded checkpoints of the packed state: mv = [m | v] of each of {len(tables)} "
        f"sparse tables, no m / v leaves; restored into packed and separate states, {restored} "
        "tensors bit-identical")
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "tensors_compared": compared, "tensors_restored": restored}


TP_ROUTES = [(r, x) for r in ("allgather", "owner") for x in ("gspmd", "alltoall")]


def _state_diffs(got, want) -> dict[str, float]:
    """Max abs difference of every tensor of two states that differ (every
    table, dense parameter, dense moment and sparse moment); empty when they
    are equal bit for bit."""
    import torch

    pairs = [(f"{n} table", got.tables[n], want.tables[n]) for n in want.tables]
    pairs += [(k, a.detach(), bb.detach()) for (k, a), (_, bb) in
              zip(got.dense_targets(), want.dense_targets())]
    pairs += [(f"dense m {i}", a, bb) for i, (a, bb) in enumerate(zip(got.opt_dense.m, want.opt_dense.m))]
    pairs += [(f"dense v {i}", a, bb) for i, (a, bb) in enumerate(zip(got.opt_dense.v, want.opt_dense.v))]
    for n, st in want.opt_sparse.items():
        pairs += [(f"{n} m", got.opt_sparse[n].m, st.m), (f"{n} v", got.opt_sparse[n].v, st.v)]
    return {name: float((a.double() - bb.double()).abs().max()) for name, a, bb in pairs
            if not torch.equal(a, bb)}


def _tp_case(dev, mesh, label: str, cfg, tscfg, data, batches, nu: int, ni: int, lanes: dict):
    """One model config's TP steps against the same steps without TP on the
    1x1 mesh, for each routing and lookup (``TP_ROUTES``): MESH_STEPS steps
    from one seeded state each. Bit for bit, or, where the row layers'
    ``mm`` + sum + bias rounds otherwise than ``addmm``'s fused bias,
    within phase 4's tolerances (each difference printed). Returns the
    summary, the TP steps' launches, and the last route's TP state."""
    import collections

    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.parallel import place_data, place_state
    from ttamm_torch.parallel.step import make_sharded_train_step
    from ttamm_torch.train import create_train_state

    mdata = place_data(mesh, data)
    counts, summary, tp_state = collections.Counter(), {}, None
    for routing, exchange in TP_ROUTES:
        step_cfg = tscfg._replace(update_routing=routing, embedding_exchange=exchange)
        runs = {}
        for tp in (True, False):
            state = place_state(mesh, create_train_state(cfg, num_users=nu, num_items=ni,
                                                         seed=STEP_SEED, device=dev),
                                tensor_parallel=tp)
            step = make_sharded_train_step(cfg, step_cfg, mesh)
            kernels.reset_launch_counts()
            losses = []
            for u, p, neg in batches[:MESH_STEPS]:
                _, metrics = step(state, mdata, u, p, generator=None, negatives=neg)
                losses.append({k: float(v) for k, v in metrics.items()})
            torch.cuda.synchronize()
            if tp:
                counts.update(kernels.launch_counts())
            runs[tp] = (state, losses)
        (got, got_losses), (want, want_losses) = runs[True], runs[False]
        name = f"{label} {routing} {exchange}"
        diffs = _state_diffs(got, want)
        if not diffs and got_losses == want_losses:
            summary[f"{routing}_{exchange}"] = "bit for bit"
            log(f"1x1 TP {name}, {MESH_STEPS} steps: losses and every state tensor bit-identical "
                "to the non-TP steps")
        else:
            for s, (g, w) in enumerate(zip(got_losses, want_losses)):
                check(all(abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1e-3) for k in w),
                      f"1x1 TP {name} step {s}: losses {g} vs non-TP {w}")
            worst = _check_steps(f"1x1 TP {name}", got, got_losses[-1], want, want_losses[-1], lanes)
            summary[f"{routing}_{exchange}"] = {"differs": diffs, "worst": worst}
            log(f"1x1 TP {name}, {MESH_STEPS} steps: {len(diffs)} state tensors differ from the "
                f"non-TP steps (max abs {max(diffs.values(), default=0.0):.3e}), within phase 4's "
                f"tolerances: {worst}")
        tp_state = got
        del runs, want
    return summary, counts, tp_state


def _tp_timing(dev, mesh, cases: dict) -> dict:
    """Device ms, device ops, host ms and idle share of one 1x1 step with and
    without TP, in turns (plain, TP, TP, plain), for each ``cases`` entry
    ``label -> (cfg, tscfg, data, batches, nu, ni)``."""
    import torch

    from ttamm_torch.parallel import place_data, place_state
    from ttamm_torch.parallel.step import make_sharded_train_step
    from ttamm_torch.train import create_train_state

    out = {}
    for label, (cfg, tscfg, data, batches, nu, ni) in cases.items():
        mdata = place_data(mesh, data)
        for turn, tp in enumerate((False, True, True, False)):
            state = place_state(mesh, create_train_state(cfg, num_users=nu, num_items=ni,
                                                         seed=STEP_SEED, device=dev),
                                tensor_parallel=tp)
            step = make_sharded_train_step(cfg, tscfg, mesh)
            it = iter(batches[MESH_STEPS:])

            def one(state=state, step=step, it=it):
                u, p, neg = next(it)
                step(state, mdata, u, p, generator=None, negatives=neg)

            events = _profiled(one, lambda: [one() for _ in range(4)])
            dev_ms = _per_call_us(events, 4) / 1e3
            check(dev_ms > 0, f"TP step {label}: the profiler saw no device work")
            ops = sum(e.count for e in events if _on_card(e)) / 4
            u, p, neg = batches[-1]
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(3):
                step(state, mdata, u, p, generator=None, negatives=neg)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - start) / 3 * 1e3
            key = f"{label} {'tp' if tp else 'plain'} turn {turn + 1}"
            out[key] = {"device_ms": dev_ms, "device_ops": ops, "host_ms": host_ms,
                        "idle_share": 1.0 - dev_ms / host_ms}
            log(f"step {key}: device {dev_ms:.3f} ms, {ops:.1f} device ops | host clock "
                f"{host_ms:.3f} ms | idle share {out[key]['idle_share']:.3f}")
            del state
    return out


def _tp_checkpoint(dev, mesh, work: Path, cfg, nu: int, ni: int, tp_state) -> tuple[Path, Path, int]:
    """Phase 4d (d), on the mesh: ``tp_state``'s sharded directory read back
    bit for bit into a TP and a non-TP placement; the non-TP one saved as a
    directory of its own. Returns both directories and the tensors
    compared."""
    from ttamm_torch.parallel import place_state
    from ttamm_torch.train import create_train_state
    from ttamm_torch.train.sharded_checkpoint import load_sharded_checkpoint, save_sharded_checkpoint

    names = dict(experiment_name="tp", epoch=1, metric_name=None, metric_value=None,
                 template="{experiment}_epoch{epoch}")
    tp_dir = save_sharded_checkpoint(work / "tp_sharded", tp_state, mesh=mesh, **names)
    compared, plain = 0, None
    for tp in (True, False):
        fresh = place_state(mesh, create_train_state(cfg, num_users=nu, num_items=ni, seed=1,
                                                     device=dev), tensor_parallel=tp)
        back, _ = load_sharded_checkpoint(tp_dir, fresh, mesh)
        check(back.tensor_parallel == tp, "the loaded state lost its placement")
        compared += _same_state(f"TP directory into tensor_parallel={tp}", back, tp_state)
        plain = back
    plain_dir = save_sharded_checkpoint(work / "tp_plain_sharded", plain, mesh=mesh, **names)
    return tp_dir, plain_dir, compared


def phase_tensor_parallel(dev, work: Path, ctx: dict, config: dict, dataset) -> dict:
    """Phase 4d: ``mesh.tensor_parallel`` on a 1x1 NCCL mesh (one card, so
    every all-reduce of the split layers has one rank), at the widths of
    ``configs/default.yaml`` (float32 and ``model.precision: bfloat16``) and
    ``configs/in_batch_softmax.yaml``: (a) the TP steps against the same
    steps without TP, both routings, the default lookup and the all-to-all
    exchange (``_tp_case``); (b) the TP steps' launches: the masked gather,
    the fused row update and the moments kernels, never the scatter;
    (c) device ms, device ops, host ms and idle share of a TP and a non-TP
    step in turns (``_tp_timing``); (d) a TP sharded directory read back bit
    for bit into a TP and a non-TP placement (``_tp_checkpoint``), and the
    export CLI from it = the export of the non-TP directory of the same
    state, bit for bit. Returns the summary phase 8 prints."""
    import numpy as np
    import torch
    import yaml

    from ttamm_torch.models.two_tower import parse_model_config
    from ttamm_torch.ops.sampling import sample_negative_items
    from ttamm_torch.parallel import MeshConfig, build_mesh
    from ttamm_torch.pipelines import export

    nu, ni, b = ctx["nu"], ctx["ni"], ctx["batch"]
    ib = _step_inputs(dev, _config(work / "data", work / "tp_in_batch", "in_batch_softmax.yaml"),
                      dataset)
    dims = dict(user_feature_dim=dataset.user_feature_matrix.shape[1],
                item_feature_dim=dataset.item_feature_matrix.shape[1])
    bf16_cfg = parse_model_config(dict(config["model"], precision="bfloat16"), **dims)

    def batches_of(c, with_negatives: bool):
        out = []
        for s in range(MESH_STEPS + 8):  # the compared steps, then the timed ones
            u = torch.from_numpy(c["users"][s * b : (s + 1) * b]).to(dev)
            p = torch.from_numpy(c["items"][s * b : (s + 1) * b]).to(dev)
            neg = None
            if with_negatives:
                neg = sample_negative_items(
                    c["data"].positive_rows[u.long()], num_items=ni,
                    num_negatives=c["tscfg"].negatives_per_positive,
                    generator=torch.Generator(device=dev).manual_seed(300 + s))
            out.append((u, p, neg))
        return out

    def lanes_of(batches, in_batch: bool):
        steps = batches[:MESH_STEPS]
        items = [p if neg is None else torch.cat([p, neg.reshape(-1)]) for _, p, neg in steps]
        lanes = {"user_id": torch.cat([u for u, _, _ in steps]).long(),
                 "item_id": torch.cat(items).long()}
        if in_batch:
            lanes.update(user_aug=lanes["user_id"], item_aug=lanes["item_id"])
        return lanes

    default_batches, ib_batches = batches_of(ctx, True), batches_of(ib, False)
    cases = {
        "default float32": (ctx["cfg"], ctx["tscfg"], ctx["data"], default_batches, False),
        "default bfloat16": (bf16_cfg, ctx["tscfg"], ctx["data"], default_batches, False),
        "in_batch_softmax float32": (ib["cfg"], ib["tscfg"], ib["data"], ib_batches, True),
    }
    summary, counts = {}, None
    with one_rank_nccl():
        mesh = build_mesh(MeshConfig(1, 1), "cuda")
        tp_state = None
        for label, (cfg, tscfg, data, batches, in_batch) in cases.items():
            summary[label], case_counts, state = _tp_case(
                dev, mesh, label, cfg, tscfg, data, batches, nu, ni, lanes_of(batches, in_batch))
            counts = case_counts if counts is None else counts + case_counts
            if label == "default float32":
                tp_state = state
        launches = dict(counts)
        for name in ("gather_rows_masked", "sparse_adam_rows", "segment_second_moments",
                     "segment_second_moments_bwd", "gather_rows"):
            check(launches.get(name, 0) > 0, f"{name} never launched in the 1x1 TP steps")
        for name in ("scatter_set_rows", "scatter_set_rows_masked"):
            check(launches.get(name, 0) == 0, f"{name} launched in the 1x1 TP steps")
        log(f"launch counts of the 1x1 TP steps ({len(cases) * len(TP_ROUTES) * MESH_STEPS} steps; "
            f"gather_rows at the all-to-all exchange): {launches}")
        timing = _tp_timing(dev, mesh, {
            "default float32 allgather": (ctx["cfg"], ctx["tscfg"], ctx["data"], default_batches,
                                          nu, ni),
            "in_batch_softmax float32 allgather": (ib["cfg"], ib["tscfg"], ib["data"], ib_batches,
                                                   nu, ni),
        })
        tp_dir, plain_dir, restored = _tp_checkpoint(dev, mesh, work, ctx["cfg"], nu, ni, tp_state)
        del tp_state
    log(f"TP sharded directory {tp_dir.name}: {restored} tensors restored bit for bit into a TP and "
        "a non-TP placement")
    cfg_path = work / "tp_export.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    start = time.perf_counter()
    export.main(["--config", str(cfg_path), "--out", str(work / "tp_bundle"), "--device", str(dev),
                 "--checkpoint", str(tp_dir)])
    cli_s = time.perf_counter() - start
    export.export_bundle(config, work / "tp_plain_bundle", device=dev, checkpoint=plain_dir,
                         dataset=dataset)
    for name in ("items.index", "vocab.json"):
        check((work / "tp_bundle" / name).read_bytes() == (work / "tp_plain_bundle" / name).read_bytes(),
              f"TP export: {name} differs from the non-TP directory's export")
    for name in ("item_embeddings.npy", "user_embeddings.npy"):
        check(np.array_equal(np.load(work / "tp_bundle" / name), np.load(work / "tp_plain_bundle" / name)),
              f"TP export: {name} differs from the non-TP directory's export")
    log(f"export CLI from the TP directory in {cli_s:.2f} s (its data prep included): the bundle of "
        "the non-TP directory of the same state, bit for bit")
    del ib
    torch.cuda.empty_cache()
    return {"steps": summary, "launches": launches, "timing": timing,
            "tensors_restored": restored, "export_cli_s": cli_s}


def _turn_stats(dev, run, steps: int) -> dict:
    """One turn of ``run(first, n)`` (n steps from batch ``first``): host
    ms/step over ``steps`` steps, unprofiled, ending in a synchronise; then
    device ms/step, device ops/step and the idle share over ``steps`` more
    under ``torch.profiler`` (the card only); and the port's kernel
    launches a step."""
    import torch

    from ttamm_torch.ops import kernels

    torch.cuda.synchronize()
    before = kernels.launch_counts()
    start = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - start) / steps * 1e3
    after = kernels.launch_counts()
    launches = {k: (after[k] - before[k]) / steps for k in after if after[k] != before[k]}
    timed = {}

    def body():
        begin = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        timed["wall"] = time.perf_counter() - begin

    events = _profiled(lambda: run(2), body)
    device_ms = _per_call_us(events, steps) / 1e3
    ops = sum(e.count for e in events if _on_card(e)) / steps
    return {"host_ms": host_ms, "device_ms": device_ms, "device_ops": ops,
            "idle_share": 1.0 - device_ms * steps / (timed["wall"] * 1e3), "launches": launches}


def phase_multi_step(dev, work: Path, config: dict, dataset) -> dict:
    """Phase 4e: ``training.steps_per_call`` on the card, at
    ``configs/default.yaml``'s and ``configs/in_batch_softmax.yaml``'s
    widths (B = 2048, F = 105, 256 / 128, D = 128, dropout on). From phase
    4's seeded state: 2 x MULTI_STEPS eager single steps against the same
    steps through ``make_multi_train_step`` in two calls of MULTI_STEPS
    (the first: the eager warm-up step, the capture and the rest replayed;
    the second: MULTI_STEPS replays): every state leaf, the losses, the
    host counts and the generator's state bit for bit, and the same launch
    counts. Then MULTI_TURNS turns of each,
    alternating (eager, replay, ...), PROFILE_STEPS steps a turn: host
    ms/step, device ms/step, device ops/step and idle share (median and
    range), and launches a step. Returns the summary phase 8 prints."""
    import copy

    import torch

    from ttamm_torch.models.convert import train_state_to_flat
    from ttamm_torch.ops import kernels
    from ttamm_torch.train import create_train_state, make_train_step
    from ttamm_torch.train.step import make_multi_train_step

    summary = {}
    for name in ("default.yaml", "in_batch_softmax.yaml"):
        ctx = _step_inputs(dev, _config(Path(config["data"]["root"]), work, name), dataset)
        cfg, tscfg, data, nu, ni, b = (ctx[k] for k in ("cfg", "tscfg", "data", "nu", "ni", "batch"))
        check(cfg.user_tower.feature_encoder.dropout > 0, f"{name}: dropout off")
        first = 2 * MULTI_STEPS
        total = first + MULTI_TURNS * (2 * PROFILE_STEPS + 2)  # a turn: timed, warm-up, profiled
        users = torch.from_numpy(ctx["users"][: total * b]).to(dev).view(total, b)
        items = torch.from_numpy(ctx["items"][: total * b]).to(dev).view(total, b)
        state = create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED, device=dev)
        eager, replayed = state, copy.deepcopy(state)
        gen_e = torch.Generator(device=dev).manual_seed(STEP_SEED)
        gen_r = torch.Generator(device=dev).manual_seed(STEP_SEED)
        single, multi = make_train_step(cfg, tscfg), make_multi_train_step(cfg, tscfg)
        kernels.reset_launch_counts()
        want = torch.stack([single(eager, data, users[k], items[k], generator=gen_e)[1]["loss"]
                            for k in range(first)])
        torch.cuda.synchronize()
        eager_counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        got = torch.cat([multi(replayed, data, users[k : k + MULTI_STEPS], items[k : k + MULTI_STEPS],
                               generator=gen_r)[1] for k in (0, MULTI_STEPS)])
        torch.cuda.synchronize()
        replay_counts = kernels.launch_counts()
        check(replay_counts == eager_counts,
              f"{name}: launches of the replayed steps {replay_counts} != eager {eager_counts}")
        check(torch.equal(got, want), f"{name}: replayed losses differ from the eager steps")
        check((replayed.step, replayed.opt_dense.step) == (eager.step, eager.opt_dense.step),
              f"{name}: host counts differ")
        a, e = train_state_to_flat(replayed), train_state_to_flat(eager)
        check(list(a) == list(e), f"{name}: the state leaves differ")
        differ = [k for k in e if a[k].tobytes() != e[k].tobytes()]
        check(not differ, f"{name}: leaves differ from the eager steps: {differ[:5]}")
        check(torch.equal(gen_r.get_state(), gen_e.get_state()), f"{name}: generator states differ")
        log(f"4e {name}: two calls of {MULTI_STEPS} steps (the first: the warm-up step, the "
            f"capture, {MULTI_STEPS - 1} replays; the second: {MULTI_STEPS} replays) = {first} eager "
            f"steps bit for bit: {len(e)} state leaves, {first} losses (last {float(got[-1]):.6f}), "
            f"the generator's state; launches {replay_counts}")

        pos = {"eager": first, "replay": first}

        def run_eager(n):
            k = pos["eager"]
            for i in range(k, k + n):
                single(eager, data, users[i], items[i], generator=gen_e)
            pos["eager"] = k + n

        def run_replay(n):
            k = pos["replay"]
            multi(replayed, data, users[k : k + n], items[k : k + n], generator=gen_r)
            pos["replay"] = k + n

        turns = {"eager": [], "replay": []}
        for _ in range(MULTI_TURNS):
            for mode, run in (("eager", run_eager), ("replay", run_replay)):
                turns[mode].append(_turn_stats(dev, run, PROFILE_STEPS))
        out = {}
        for mode, stats in turns.items():
            out[mode] = {"launches_per_step": stats[-1]["launches"]}
            for key in ("host_ms", "device_ms", "device_ops", "idle_share"):
                vals = sorted(t[key] for t in stats)
                out[mode][key] = {"median": vals[len(vals) // 2], "min": vals[0], "max": vals[-1]}
            check(out[mode]["device_ms"]["min"] > 0, f"4e {name} {mode}: the profiler saw no device work")
            check(all(t["launches"] == stats[0]["launches"] for t in stats),
                  f"4e {name} {mode}: launches a step changed between turns")
            log(f"4e {name} {mode} ({MULTI_TURNS} turns of {PROFILE_STEPS} steps, median [min, max]): "
                + " | ".join(f"{key} {v['median']:.3f} [{v['min']:.3f}, {v['max']:.3f}]"
                             for key, v in out[mode].items() if key != "launches_per_step")
                + f" | launches a step {out[mode]['launches_per_step']}")
        check(out["replay"]["launches_per_step"] == out["eager"]["launches_per_step"],
              f"4e {name}: launches a step differ between replay and eager")
        summary[name] = out
        del eager, replayed, state, single, multi, data
        torch.cuda.empty_cache()
    return summary


def _flat_bytes(state, mesh) -> dict:
    """Every leaf of a placed state, gathered whole, as bytes."""
    from ttamm_torch.parallel import gather_state_flat

    return {k: v.tobytes() for k, v in gather_state_flat(state, mesh).items()}


def _mesh_multi_case(dev, mesh, label: str, c: dict, tscfg, tp: bool) -> dict:
    """One case of phase 4f on the 1x1 NCCL ``mesh``: from phase 4's seeded
    state, 2 x MULTI_STEPS eager sharded steps against two
    ``make_sharded_multi_train_step`` calls of MULTI_STEPS (the first: the
    eager warm-up step, the capture, the rest replayed; the second:
    replays), both generators (negatives, dropout) drawn, bit for bit:
    every leaf, the losses, the host counts, both generators' states and
    the launch counts; then MESH_TURNS turns each way, alternating, of
    PROFILE_STEPS steps (``_turn_stats``). Returns the turns' summary."""
    import copy

    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.parallel import place_state
    from ttamm_torch.parallel.sparse_update import owner_stats, reset_owner_stats
    from ttamm_torch.parallel.step import make_sharded_multi_train_step, make_sharded_train_step
    from ttamm_torch.pipelines.training import dropout_generator
    from ttamm_torch.train import create_train_state

    cfg, data, nu, ni, b = (c[k] for k in ("cfg", "data", "nu", "ni", "batch"))
    check(cfg.user_tower.feature_encoder.dropout > 0, f"4f {label}: dropout off")
    first = 2 * MULTI_STEPS
    total = first + MESH_TURNS * (2 * PROFILE_STEPS + 2)  # a turn: timed, warm-up, profiled
    users = torch.from_numpy(c["users"][: total * b]).to(dev).view(total, b)
    items = torch.from_numpy(c["items"][: total * b]).to(dev).view(total, b)
    state = place_state(mesh, create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED,
                                                 device=dev), tensor_parallel=tp)
    eager, replayed = state, copy.deepcopy(state)
    gens = {w: (torch.Generator(device=dev).manual_seed(STEP_SEED),
                dropout_generator(STEP_SEED, mesh, dev)) for w in ("eager", "replay")}
    single = make_sharded_train_step(cfg, tscfg, mesh)
    multi = make_sharded_multi_train_step(cfg, tscfg, mesh)
    reset_owner_stats()
    kernels.reset_launch_counts()
    g, d = gens["eager"]
    want = torch.stack([single(eager, data, users[k], items[k], generator=g, dropout_generator=d)[1]
                        ["loss"] for k in range(first)])
    torch.cuda.synchronize()
    eager_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    g, d = gens["replay"]
    got = torch.cat([multi(replayed, data, users[k : k + MULTI_STEPS], items[k : k + MULTI_STEPS],
                           generator=g, dropout_generator=d)[1] for k in (0, MULTI_STEPS)])
    torch.cuda.synchronize()
    replay_counts = kernels.launch_counts()
    stats = owner_stats()
    check(replay_counts == eager_counts,
          f"4f {label}: launches of the replayed steps {replay_counts} != eager {eager_counts}")
    check(torch.equal(got, want), f"4f {label}: replayed losses differ from the eager steps")
    counts = lambda st: (st.step, st.opt_dense.step, *(s.step for s in st.opt_sparse.values()))  # noqa: E731
    check(counts(replayed) == counts(eager), f"4f {label}: host counts differ")
    a, e = _flat_bytes(replayed, mesh), _flat_bytes(eager, mesh)
    check(list(a) == list(e), f"4f {label}: the state leaves differ")
    differ = [k for k in e if a[k] != e[k]]
    check(not differ, f"4f {label}: leaves differ from the eager steps: {differ[:5]}")
    for i, name in enumerate(("negatives'", "dropout")):
        check(torch.equal(gens["replay"][i].get_state(), gens["eager"][i].get_state()),
              f"4f {label}: the {name} generator states differ")
    if tscfg.update_routing == "owner":
        tables = len(eager.opt_sparse)
        check(stats == {"checks": 2 * first * tables, "overflows": 0},
              f"4f {label}: owner routing counters {stats}")
    log(f"4f {label}: two calls of {MULTI_STEPS} steps (the first: the warm-up step, the capture, "
        f"{MULTI_STEPS - 1} replays; the second: {MULTI_STEPS} replays) = {first} eager sharded "
        f"steps bit for bit: {len(e)} state leaves, {first} losses (last {float(got[-1]):.6f}), both "
        f"generators' states; launches {replay_counts}; owner counters {stats}")

    pos = {"eager": first, "replay": first}

    def run_eager(n):
        k = pos["eager"]
        g, d = gens["eager"]
        for i in range(k, k + n):
            single(eager, data, users[i], items[i], generator=g, dropout_generator=d)
        pos["eager"] = k + n

    def run_replay(n):
        k = pos["replay"]
        g, d = gens["replay"]
        multi(replayed, data, users[k : k + n], items[k : k + n], generator=g, dropout_generator=d)
        pos["replay"] = k + n

    turns = {"eager": [], "replay": []}
    for _ in range(MESH_TURNS):
        for mode, run in (("eager", run_eager), ("replay", run_replay)):
            turns[mode].append(_turn_stats(dev, run, PROFILE_STEPS))
    out = {}
    for mode, stats in turns.items():
        out[mode] = {"launches_per_step": stats[-1]["launches"]}
        for key in ("host_ms", "device_ms", "device_ops", "idle_share"):
            vals = sorted(t[key] for t in stats)
            out[mode][key] = {"median": vals[len(vals) // 2], "min": vals[0], "max": vals[-1]}
        check(out[mode]["device_ms"]["min"] > 0, f"4f {label} {mode}: the profiler saw no device work")
        log(f"4f {label} {mode} ({MESH_TURNS} turns of {PROFILE_STEPS} steps, median [min, max]): "
            + " | ".join(f"{key} {v['median']:.3f} [{v['min']:.3f}, {v['max']:.3f}]"
                         for key, v in out[mode].items() if key != "launches_per_step")
            + f" | launches a step {out[mode]['launches_per_step']}")
    check(out["replay"]["launches_per_step"] == out["eager"]["launches_per_step"],
          f"4f {label}: launches a step differ between replay and eager")
    return out


def _forced_overflow(dev, mesh, c: dict, tscfg) -> dict:
    """Phase 4f's forced overflow: the owner routing at capacity factor
    1e-4 (a buffer of 256 lanes a table, far below a step's distinct rows).
    From phase 4's seeded state, three eager sharded steps against one
    multi-step call of two (the warm-up step, the capture, a replay) and
    one of one (a replay alone), dropout on: bit for bit, and the device
    counters of the replayed step alone must read one check and one
    overflow a sparse table."""
    import copy

    import torch

    from ttamm_torch.parallel import place_state
    from ttamm_torch.parallel.sparse_update import owner_stats, reset_owner_stats
    from ttamm_torch.parallel.step import make_sharded_multi_train_step, make_sharded_train_step
    from ttamm_torch.pipelines.training import dropout_generator
    from ttamm_torch.train import create_train_state

    cfg, data, nu, ni, b = (c[k] for k in ("cfg", "data", "nu", "ni", "batch"))
    tscfg = tscfg._replace(update_routing="owner", update_capacity_factor=1e-4)
    users = torch.from_numpy(c["users"][: 3 * b]).to(dev).view(3, b)
    items = torch.from_numpy(c["items"][: 3 * b]).to(dev).view(3, b)
    eager = place_state(mesh, create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED,
                                                 device=dev))
    replayed = copy.deepcopy(eager)
    gens = [(torch.Generator(device=dev).manual_seed(STEP_SEED), dropout_generator(STEP_SEED, mesh, dev))
            for _ in range(2)]
    single = make_sharded_train_step(cfg, tscfg, mesh)
    multi = make_sharded_multi_train_step(cfg, tscfg, mesh)
    reset_owner_stats()
    want = torch.stack([single(eager, data, users[k], items[k], generator=gens[0][0],
                               dropout_generator=gens[0][1])[1]["loss"] for k in range(3)])
    eager_stats = owner_stats()
    _, first = multi(replayed, data, users[:2], items[:2], generator=gens[1][0],
                     dropout_generator=gens[1][1])
    reset_owner_stats()
    _, last = multi(replayed, data, users[2:], items[2:], generator=gens[1][0],
                    dropout_generator=gens[1][1])
    torch.cuda.synchronize()
    stats = owner_stats()
    tables = len(eager.opt_sparse)
    check(eager_stats == {"checks": 3 * tables, "overflows": 3 * tables},
          f"4f forced overflow: the eager steps' counters {eager_stats}")
    check(stats == {"checks": tables, "overflows": tables},
          f"4f forced overflow: the replayed step's counters {stats}")
    check(torch.equal(torch.cat([first, last]), want), "4f forced overflow: losses differ")
    a, e = _flat_bytes(replayed, mesh), _flat_bytes(eager, mesh)
    differ = [k for k in e if a[k] != e[k]]
    check(not differ, f"4f forced overflow: leaves differ from the eager steps: {differ[:5]}")
    log(f"4f forced overflow (owner, capacity factor 1e-4): a replayed overflowing step (one replay "
        f"alone) = its eager step bit for bit ({len(e)} leaves, losses); its device counters "
        f"{stats} (one overflow a sparse table), the eager steps' {eager_stats}")
    return {"replayed_step": stats, "eager_steps": eager_stats}


def _wire_steps(dev, mesh, c: dict, tscfg, tp: bool) -> tuple[list, list, dict, int]:
    """Phase 4g's records of one case: one eager sharded step of a fresh
    seeded state, and one ``make_sharded_multi_train_step`` call of two
    steps on a copy (the warm-up of the groups, its eager first step, the
    capture, a replay, which runs no Python). Returns the eager step's
    record, the multi-step call's, the tables' shapes and the number of
    sparse tables."""
    import copy

    import torch

    from ttamm_torch.parallel import place_state
    from ttamm_torch.parallel.collective_inspect import record_collectives
    from ttamm_torch.parallel.step import make_sharded_multi_train_step, make_sharded_train_step
    from ttamm_torch.pipelines.training import dropout_generator
    from ttamm_torch.train import create_train_state

    cfg, data, nu, ni, b = (c[k] for k in ("cfg", "data", "nu", "ni", "batch"))
    users = torch.from_numpy(c["users"][: 2 * b]).to(dev).view(2, b)
    items = torch.from_numpy(c["items"][: 2 * b]).to(dev).view(2, b)
    eager = place_state(mesh, create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED,
                                                 device=dev), tensor_parallel=tp)
    replayed = copy.deepcopy(eager)
    gens = [(torch.Generator(device=dev).manual_seed(STEP_SEED), dropout_generator(STEP_SEED, mesh, dev))
            for _ in range(2)]
    with record_collectives(mesh) as one:
        make_sharded_train_step(cfg, tscfg, mesh)(eager, data, users[0], items[0], generator=gens[0][0],
                                                  dropout_generator=gens[0][1])
    with record_collectives(mesh) as multi:
        multi_step = make_sharded_multi_train_step(cfg, tscfg, mesh)
        multi_step(replayed, data, users, items, generator=gens[1][0], dropout_generator=gens[1][1])
    torch.cuda.synchronize()
    return one, multi, {n: tuple(t.shape) for n, t in eager.tables.items()}, len(eager.opt_sparse)


def _axis_totals(records) -> dict:
    out: dict[str, dict[str, int]] = {}
    for r in records:
        entry = out.setdefault(r.axis, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += r.bytes
    return out


def _wire_inventory(dev, mesh, cases: dict, default: dict, scaling) -> dict:
    """Phase 4g on 4f's 1x1 NCCL mesh: each of 4f's cases recorded
    (``_wire_steps``): the eager step's record = the captured step's (op,
    axis, dtype, shape, branch, in order); no collective moves half the
    smallest table or more; every all-gather over ``data`` of a floating tensor in
    bf16 under the pod recipe; under the owner routing the overflow branch
    (``branch="overflow"``) holds each sparse table's full-width gathers,
    and 4f's forced overflow issues them (its device counters: one
    overflow a table). Then the weak-scaling prediction's lines
    (``scaling``: the running ``scripts/torch_predict_scaling.py``)."""
    import torch

    from ttamm_torch.parallel.collective_inspect import assert_no_table_sized_collectives
    from ttamm_torch.parallel.sparse_update import owner_stats, reset_owner_stats

    key = lambda r: (r.op, r.axis, r.dtype, r.shape, r.branch)  # noqa: E731
    summary = {}
    for label, (c, case_tscfg, tp) in cases.items():
        one, multi, tables, _ = _wire_steps(dev, mesh, c, case_tscfg, tp)
        warm = [key(r) for r in multi[:3]]
        check(warm == [("all-reduce", a, "float32", (1,), None) for a in ("world", "data", "model")],
              f"4g {label}: the multi-step call's first collectives {warm} are not warm_groups'")
        n = len(one)
        check(len(multi) == 3 + 2 * n, f"4g {label}: {len(multi)} collectives in the multi-step "
              f"call, not 3 + 2 x {n}")
        check([key(r) for r in multi[3 : 3 + n]] == [key(r) for r in one],
              f"4g {label}: the multi-step call's eager step differs from the eager step")
        check([key(r) for r in multi[3 + n :]] == [key(r) for r in one],
              f"4g {label}: the captured step's collectives differ from the eager step's")
        # half the smallest table, the JAX default fraction: a tenth is below
        # one step's item lanes here (12,288 x 128 f32 = 12.3% of the item
        # table), which the sparse update has always gathered
        assert_no_table_sized_collectives(one, tables)
        if "pod" in label:
            floats = [r.dtype for r in one if r.op == "all-gather" and r.axis == "data"
                      and r.dtype in ("float32", "bfloat16")]
            check(floats and all(d == "bfloat16" for d in floats),
                  f"4g {label}: all-gathers over data in {floats}")
        if case_tscfg.update_routing == "owner":
            b, dim = c["batch"], tables["user_id"][1]
            items = (b + case_tscfg.mixed_negatives if case_tscfg.loss_type == "in_batch_softmax"
                     else b * (1 + case_tscfg.negatives_per_positive))
            for lanes in (b, items):  # at one data shard the lanes of the whole batch
                for shape in ((lanes,), (lanes, dim)):
                    check(any(r.branch == "overflow" and r.op == "all-gather" and r.shape == shape
                              for r in one), f"4g {label}: no full-width {shape} gather in the "
                              "overflow branch")
        totals = _axis_totals(one)
        largest = max(one, key=lambda r: r.bytes)
        share = largest.bytes / min(math.prod(shape) * 4 for shape in tables.values())
        log(f"4g {label}: {n} collectives a step, eager = captured (op, axis, dtype, shape, "
            f"branch); by axis {totals}; the largest {largest}, {share:.4f} of the smallest table; "
            f"overflow-branch entries {sum(r.branch == 'overflow' for r in one)}")
        summary[label] = {"collectives": n, "by_axis": totals, "largest_bytes": largest.bytes,
                          "largest_table_share": share}
        torch.cuda.empty_cache()
    forced = default["tscfg"]._replace(update_routing="owner", update_capacity_factor=1e-4)
    reset_owner_stats()
    one, _, _, tables = _wire_steps(dev, mesh, default, forced, False)
    stats = owner_stats()
    over = [r for r in one if r.branch == "overflow"]
    check(stats["overflows"] >= tables and len(over) == 2 * tables,
          f"4g forced overflow: counters {stats}, overflow-branch entries {len(over)}")
    log(f"4g forced overflow (capacity factor 1e-4): its overflow branch's gathers "
        f"{[str(r) for r in over]}; device counters {stats}")
    summary["forced_overflow"] = {"overflow_entries": len(over), "counters": stats}
    out, err = scaling.communicate(timeout=600)
    check(scaling.returncode == 0,
          f"4g torch_predict_scaling.py exited {scaling.returncode}:\n{err[-3000:]}")
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    check(len(lines) == 4, f"4g torch_predict_scaling.py printed {len(lines)} lines, not 4")
    for line in lines:
        check(line["ranks_agree"] and 0 < line["predicted_weak_scaling_efficiency"] <= 1
              and line["wire_bytes_per_device"] > 0, f"4g prediction line {line}")
        log("4g prediction: " + json.dumps({k: line[k] for k in (
            "config", "mesh", "features_dtype", "comm_dtype", "update_routing", "collectives_per_step",
            "wire_bytes_per_device", "wire_bytes_by_axis", "t1_ms", "t_comm_ms",
            "predicted_weak_scaling_efficiency")}))
        log("4g prediction, per op and axis: " + json.dumps(line["collectives"])
            + f" | overflow branch (not paid): {json.dumps(line['overflow_branch'])}")
    summary["prediction"] = lines
    return summary


def phase_wire(dev, mesh, cases: dict, default: dict, t1_ms: list[float], features: int) -> dict:
    """Phase 4g: ``scripts/torch_predict_scaling.py`` started for
    ``configs/default.yaml`` and ``configs/pod_2x4.yaml`` at 2x4 and 8x1 from
    ``t1_ms`` (4e's one-device replay ms/step of the default and the
    in-batch configuration, which the pod recipe stacks its wire options
    on) at the corpus's feature width; its CPU ranks run while
    ``_wire_inventory`` records 4f's cases on the card."""
    scaling = subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "torch_predict_scaling.py"), "--config",
         "configs/default.yaml", "configs/pod_2x4.yaml", "--meshes", "2x4,8x1", "--t1-ms",
         *(f"{t:.6f}" for t in t1_ms), "--features", str(features)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        return _wire_inventory(dev, mesh, cases, default, scaling)
    finally:
        if scaling.poll() is None:
            scaling.kill()
            scaling.communicate()


def phase_mesh_multi_step(dev, work: Path, config: dict, dataset, multi_summary: dict) -> dict:
    """Phase 4f: the mesh's multi-step on a 1x1 NCCL mesh (one card),
    ``make_sharded_multi_train_step`` as CUDA-graph replays of the sharded
    step with its collectives, held to the eager sharded steps
    (``_mesh_multi_case``) at full width (B = 2048, dropout on):
    ``configs/default.yaml`` under the allgather and the owner routing, the
    same with ``mesh.tensor_parallel``, and ``configs/pod_2x4.yaml`` with
    ``embedding_exchange: alltoall`` (owner routing, bf16 wire and
    features); then the forced overflow (``_forced_overflow``). Returns the
    summary phase 8 prints."""
    import torch

    from ttamm_torch.parallel import MeshConfig, build_mesh, place_data

    default = _step_inputs(dev, _config(Path(config["data"]["root"]), work), dataset)
    pod_config = _config(Path(config["data"]["root"]), work / "pod_4f", "pod_2x4.yaml")
    pod = _step_inputs(dev, pod_config, dataset)
    pod_tscfg = pod["tscfg"]._replace(
        update_routing=pod_config["training"]["update_routing"], embedding_exchange="alltoall",
        update_capacity_factor=float(pod_config["training"].get("update_capacity_factor", 2.0)))
    summary = {}
    with one_rank_nccl():
        mesh = build_mesh(MeshConfig(1, 1), "cuda")
        for c in (default, pod):
            c["data"] = place_data(mesh, c["data"])
        cases = {f"default {r}{' tp' if tp else ''}": (default, default["tscfg"]._replace(
                     update_routing=r), tp)
                 for tp in (False, True) for r in ("allgather", "owner")}
        cases["pod_2x4 owner alltoall"] = (pod, pod_tscfg, False)
        for label, (c, tscfg, tp) in cases.items():
            summary[label] = _mesh_multi_case(dev, mesh, label, c, tscfg, tp)
            torch.cuda.empty_cache()
        summary["forced_overflow"] = _forced_overflow(dev, mesh, default, default["tscfg"])
        with Phase("4g the wire inventory: the sharded step's collectives, the scaling prediction"):
            t1 = [multi_summary[name]["replay"]["host_ms"]["median"]
                  for name in ("default.yaml", "in_batch_softmax.yaml")]
            summary["wire_4g"] = phase_wire(dev, mesh, cases, default, t1,
                                            dataset.item_feature_matrix.shape[1])
        del default, pod
        gc.collect()
        torch.cuda.empty_cache()
    return summary


def _profile_steps(dev, config: dict, dataset, result) -> tuple[dict, dict]:
    """Profile PROFILE_STEPS more steps of the trained state: top device
    ops, device idle share and launches per step (each sparse table: one
    forward read, gather_rows, and one fused update, sparse_adam_rows; the
    scatter never). Returns the launches per step and the step's wall ms,
    device ms, device ops and idle share."""
    import numpy as np
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.train import make_train_step

    state, data = result.state, result.data
    step = make_train_step(state.model.cfg, result.step_config)
    b = config["training"]["batch_size"]
    frame = dataset.interactions
    pick = np.random.default_rng(11).permutation(len(frame))[: (PROFILE_STEPS + 2) * b]
    users = torch.from_numpy(frame["user_idx"].to_numpy(np.int32)[pick]).to(dev)
    items = torch.from_numpy(frame["item_idx"].to_numpy(np.int32)[pick]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(11)

    def run(first, n):
        for i in range(first, first + n):
            step(state, data, users[i * b : (i + 1) * b], items[i * b : (i + 1) * b], generator=gen)

    timed = {}

    def body():
        timed["before"] = kernels.launch_counts()
        start = time.perf_counter()
        run(2, PROFILE_STEPS)
        torch.cuda.synchronize()
        timed["wall"] = time.perf_counter() - start
        timed["after"] = kernels.launch_counts()

    averages = _profiled(lambda: run(0, 2), body, cpu=True)
    wall, before, after = timed["wall"], timed["before"], timed["after"]
    per_step = {k: (after[k] - before[k]) / PROFILE_STEPS for k in after if after[k] != before[k]}
    device_ms_total = _per_call_us(averages, PROFILE_STEPS) * PROFILE_STEPS / 1e3
    check(device_ms_total > 0, "the profiler saw no device work in the training steps")
    idle = 1.0 - device_ms_total / (wall * 1e3)
    device_work = sum(e.count for e in averages if _on_card(e))
    log(f"profiled {PROFILE_STEPS} steps: wall {wall * 1e3 / PROFILE_STEPS:.3f} ms/step, device "
        f"{device_ms_total / PROFILE_STEPS:.3f} ms/step, idle share {idle:.3f}, "
        f"{device_work / PROFILE_STEPS:.1f} kernels/copies/fills per step")
    log(f"launches per step: {per_step}")
    from ttamm_torch.train.state import sparse_table_names

    tables = len(sparse_table_names(state.model.cfg))
    want = {"gather_rows": tables, "sparse_adam_rows": tables, "scatter_set_rows": 0}
    check(all(per_step.get(k, 0) == n for k, n in want.items()),
          f"launches per step {per_step}, expected {want}")
    try:
        table = averages.table(sort_by="self_device_time_total", row_limit=15)
    except (AttributeError, KeyError, ValueError):
        table = averages.table(sort_by="self_cuda_time_total", row_limit=15)
    log(table)
    stats = {"wall_ms": wall * 1e3 / PROFILE_STEPS, "device_ms": device_ms_total / PROFILE_STEPS,
             "device_ops": device_work / PROFILE_STEPS, "idle_share": idle}
    return per_step, stats


def phase_train(dev, config: dict, dataset, excluded: collections.Counter):
    import math as _math

    from ttamm_torch.pipelines.training import run_training
    from ttamm_torch.train.checkpoint import checkpoint_filename

    start = time.perf_counter()
    result = run_training(config, device=dev, dataset=dataset)  # no grid: one run
    ledger = Path(config["experiment"]["benchmark_report"]).read_text().splitlines()
    check(ledger[-1].startswith("1 | - | "), f"sweep ledger: {ledger[-1:]}")
    log(f"ledger {config['experiment']['benchmark_report']}: {ledger[-1]}")
    log(f"train: {time.perf_counter() - start:.2f} s for {result.steps} steps of "
        f"{config['training']['batch_size']} | {result.train_seconds / result.steps * 1e3:.3f} ms/step "
        f"| {result.examples_per_second:.1f} examples/s | first step loss {result.first_step_loss:.5f} "
        f"| epoch train loss {result.train_loss} | val loss {result.val_loss} "
        f"| test loss {result.test_loss}")
    losses = [result.first_step_loss, *result.train_loss, *result.val_loss, *result.test_loss]
    check(all(_math.isfinite(v) for v in losses), "non-finite loss")
    check(len(result.train_loss) == 2, f"{len(result.train_loss)} epochs trained, not 2")
    check(result.train_loss[-1] < result.first_step_loss, "the epoch's mean loss is not below the first step's")
    for epoch, (val, test, secs) in enumerate(
        zip(result.val_metrics, result.test_metrics, result.phase_seconds), start=1
    ):
        for split, m in (("val", val), ("test", test)):
            log(f"epoch {epoch} {split}: " + " | ".join(
                f"recall@{k} {m.recall[k]:.5f} ndcg@{k} {m.ndcg[k]:.5f}" for k in (5, 10, 20)
            ))
            check(m.recall[5] <= m.recall[10] <= m.recall[20], f"epoch {epoch} {split}: recall not monotone in k")
        log(f"epoch {epoch} seconds (host clock): " + " ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    best = result.best_val_metrics
    chance = 10 / result.num_items
    log(f"best epoch {result.best_epoch}: val recall@10 {best.recall[10]:.5f} = "
        f"{best.recall[10] / chance:.1f}x chance ({chance:.3e}) | serving score dtype "
        f"{result.serving_score_dtype}")
    check(best.recall[10] > 20 * chance, "val recall@10 not above 20x chance")
    ckpt = config["training"]["checkpointing"]
    want = checkpoint_filename(
        ckpt["filename_template"], experiment_name=config["experiment"]["name"],
        metric_name=config["training"]["early_stopping"]["metric"],
        metric_value=best.recall[10], epoch=result.best_epoch,
    )
    check(result.best_checkpoint_path is not None and result.best_checkpoint_path.name == want
          and _written(result.best_checkpoint_path), f"best checkpoint {result.best_checkpoint_path} != {want}")
    check(result.checkpoint_path is not None and _written(result.checkpoint_path), "no last checkpoint written")
    log(f"checkpoints: best {result.best_checkpoint_path.name}, last {result.checkpoint_path.name} "
        f"({_checkpoint_bytes(result.checkpoint_path) / 1e6:.1f} MB"
        f"{', sharded' if result.checkpoint_path.is_dir() else ''})")
    log(f"checkpoint laps (host clock): {[round(p['ckpt'], 4) for p in result.phase_seconds]} s; "
        f"train laps {[round(p['train'], 3) for p in result.phase_seconds]} s; the end-of-run wait "
        f"for the writer {result.checkpoint_wait_seconds:.4f} s")
    with uncounted(excluded):
        _eval_checks(result)
    block = _report_checks(config, dataset, result, excluded)
    return result, block


def _written(path: Path) -> bool:
    """A flat checkpoint file, or a sharded directory with its manifest."""
    return path.is_file() or (path / "manifest.json").is_file()


def _checkpoint_bytes(path: Path) -> int:
    return path.stat().st_size if path.is_file() else sum(f.stat().st_size for f in path.iterdir())


def _report_checks(config: dict, dataset, result, excluded: collections.Counter) -> dict[str, int]:
    """The run's reports: the Markdown report (its recall@k that of the best
    epoch, one entry a sampled user), the JSON summary and the loss PNG
    where matplotlib is installed; then the end-of-run block again on the
    best state (one seeded draw: the same samples and users as the run's),
    its launches counted apart, and each sample user's recommended ids
    against a host numpy search of the same embeddings (history dropped),
    equal but where scores tie within 1e-5. Returns the block's launches."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ttamm_torch.evaluation import encode_user_batch
    from ttamm_torch.ops import kernels
    from ttamm_torch.pipelines.training import run_diagnostics
    from ttamm_torch.train import encode_corpus

    diag_cfg, rec_cfg = config["diagnostics"], config["recommendations"]
    report, summary = Path(diag_cfg["report_path"]), Path(diag_cfg["embedding_summary_path"])
    check(report.is_file() and result.embedding_summary_path == summary and summary.is_file(),
          f"reports not written: {report} {result.embedding_summary_path}")
    text = report.read_text(encoding="utf-8").splitlines()
    if result.loss_plot_path is not None:
        check(result.loss_plot_path.read_bytes()[:8] == PNG_MAGIC, "the loss plot is not a PNG")
        log(f"loss plot PNG written: {result.loss_plot_path.name} "
            f"({result.loss_plot_path.stat().st_size} bytes)")
    else:
        check("## Loss Curves" not in text, "a loss section without a plot")
        log("loss plot PNG not written (no matplotlib): the report has no loss section")
    recall = "- **Recall**: " + ", ".join(
        f"@{k}={v:.4f}" for k, v in result.best_val_metrics.recall.items())
    check(recall in text, f"the report's recall is not the best epoch's {recall}")
    users = [line.split("`")[1] for line in text if line.startswith("- **User** `")]
    check(len(users) == rec_cfg["sample_users"], f"report users {users}")
    blob = json.loads(summary.read_text())
    check(blob["best_epoch"] == result.best_epoch and blob["embedding_stats"]["item_norms"]["count"]
          == diag_cfg["item_sample_size"], f"embedding summary: {list(blob)}")
    log(f"reports: {report.name} (recall line = the best epoch's: {recall[2:]}; users {users}), "
        f"{summary.name}")

    state, data = result.state, result.data
    model = state.model
    with uncounted(excluded):
        items = encode_corpus(model, "item", data.item_features)
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        start = time.perf_counter()
        diag = run_diagnostics(model, data, dataset, items, diagnostics=diag_cfg,
                               recommendations=rec_cfg, seed=config["experiment"]["seed"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        after = kernels.launch_counts()
        block = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        check([e["user_id"] for e in diag.recommendations] == users, "the rerun drew other users")
        cosine = model.cfg.similarity == "cosine"
        unit = (F.normalize(items, dim=-1) if cosine else items).cpu().numpy()
        index_of = dict(zip(dataset.items["parent_asin"], dataset.items["item_idx"]))
        for entry in diag.recommendations:
            u = torch.tensor([entry["user_idx"]], dtype=torch.int32, device=items.device)
            q = encode_user_batch(model, data, u)
            q = (F.normalize(q, dim=-1) if cosine else q).cpu().numpy()[0]
            scores = unit @ q
            scores[sorted(dataset.user_positive_items.get(entry["user_idx"], ()))] = -np.inf
            want = np.argsort(-scores, kind="stable")[: rec_cfg["top_k"]]
            got = np.asarray([index_of[r["asin"]] for r in entry["recommendations"]])
            check(len(got) == len(want) and ids_agree(got, scores[got], want, scores[want]),
                  f"user {entry['user_id']}: recommended {got}, host numpy search {want}")
    for name in ("small_k_topk", "gather_rows"):
        check(block.get(name, 0) > 0, f"the end-of-run block launched no {name}: {block}")
    log(f"end-of-run block (diagnostics of {diag_cfg['item_sample_size']} items and "
        f"{diag_cfg['user_sample_size']} users, {len(diag.recommendations)} users' recommendations): "
        f"{seconds:.3f} s, launches {block}; the recommended ids equal the host numpy search")
    return block


def _checkpoint_ab(dev, config: dict, dataset, result, work: Path) -> dict:
    """Phase 5's checkpoint A/B on the trained state: (1) one save
    synchronous and one through AsyncCheckpointer (the trainer's snapshot,
    a device clone), files equal (arrays bit for bit, meta but its
    timestamp); (2) AB_STEPS canonical train steps a turn, turns none,
    write, write, none (a save submitted just before the steps): host
    ms/step of each, the checkpoint lap (clone + submit) and the wait for
    the writer after the steps."""
    import copy

    import numpy as np
    import torch

    from ttamm_torch.train import make_train_step
    from ttamm_torch.train.checkpoint import AsyncCheckpointer, save_checkpoint

    state, data = result.state, result.data
    names = dict(experiment_name="ab", epoch=1, metric_name="last", metric_value=1.0,
                 template="{experiment}_last.pt")
    writer = AsyncCheckpointer()

    def submit(directory: str) -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        writer.submit(copy.deepcopy(state), [dict(directory=work / directory, **names)])
        torch.cuda.synchronize()  # the lap as the trainer's epoch times it
        return time.perf_counter() - start

    def waited() -> float:
        start = time.perf_counter()
        writer.wait()
        return time.perf_counter() - start

    torch.cuda.synchronize()
    start = time.perf_counter()
    sync_path = save_checkpoint(work / "ab_sync", state, **names)
    sync_s = time.perf_counter() - start
    first_lap = submit("ab_async")
    wait_s = waited()
    async_path = work / "ab_async" / sync_path.name
    with np.load(sync_path) as a, np.load(async_path) as b:
        check(a.files == b.files, "async checkpoint: other leaves")
        metas = [json.loads(bytes(x["__meta__"]).decode()) for x in (a, b)]
        for meta in metas:
            meta.pop("timestamp")
        check(metas[0] == metas[1], f"async checkpoint meta {metas}")
        for key in a.files:
            if key != "__meta__":
                check(a[key].tobytes() == b[key].tobytes(), f"async checkpoint: {key} differs")
    size = sync_path.stat().st_size
    log(f"checkpoint A/B, one state ({size / 1e6:.1f} MB): synchronous save {sync_s:.3f} s | "
        f"async lap (clone + submit) {first_lap:.4f} s, written {wait_s:.3f} s later | files equal "
        f"({len(metas[0])} meta keys but the timestamp, every array bit for bit)")
    sync_path.unlink()
    async_path.unlink()

    step = make_train_step(state.model.cfg, result.step_config)
    b = config["training"]["batch_size"]
    frame = dataset.interactions
    n = 4 * AB_STEPS + 2
    pick = np.random.default_rng(13).permutation(len(frame))[: n * b]
    users = torch.from_numpy(frame["user_idx"].to_numpy(np.int32)[pick]).to(dev)
    items = torch.from_numpy(frame["item_idx"].to_numpy(np.int32)[pick]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(13)

    def steps(first: int, count: int) -> float:
        start = time.perf_counter()
        for i in range(first, first + count):
            step(state, data, users[i * b : (i + 1) * b], items[i * b : (i + 1) * b], generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / count

    steps(0, 2)
    turns = []
    for turn, mode in enumerate(("none", "write", "write", "none")):
        lap = submit(f"ab_turn{turn}") if mode == "write" else 0.0
        ms = steps(2 + turn * AB_STEPS, AB_STEPS)
        tail = waited()
        turns.append({"mode": mode, "ms_per_step": ms, "ckpt_lap_s": lap, "wait_after_s": tail})
        log(f"checkpoint A/B turn {turn} ({mode}): {ms:.3f} host ms/step over {AB_STEPS} steps"
            + (f" | lap {lap:.4f} s | the write ended {tail:.3f} s after the steps" if lap else ""))
        for path in (work / f"ab_turn{turn}").glob("*.pt"):
            path.unlink()
    return {"sync_save_s": sync_s, "async_lap_s": first_lap, "async_written_after_s": wait_s,
            "file_mb": size / 1e6, "turns": turns}


def _eval_checks(result) -> None:
    """On the trained (best) state: one val user batch's device time, the
    first two val batches' hit matrices with the kernels and with their
    plain versions, and 256 users' masked ids against a host numpy search."""
    import numpy as np
    import torch

    from ttamm_torch.evaluation import retrieval

    model, data, plan = result.state.model, result.data, result.val_plan
    items = retrieval._corpus(model, data, None)
    wide = 0 if plan.wide is None else len(plan.wide.batches)
    ms = device_ms(lambda: retrieval.batch_hits(model, data, items, plan, 0, max_k=20), iters=5, warmup=1)
    log(f"val eval: {len(plan.batches)} batches of {plan.user_mat.shape[1]} users (+ {wide} wide-mask "
        f"batches), deep_k {plan.deep_k}: {ms:.3f} ms of device work per user batch")
    for b in range(min(2, len(plan.batches))):
        got = retrieval.batch_hits(model, data, items, plan, b, max_k=20)
        with plain_kernels():
            want = retrieval.batch_hits(model, data, items, plan, b, max_k=20)
        check(torch.equal(got, want), f"val batch {b}: kernel and plain-version hit matrices differ")
    log(f"val batches 0-{min(2, len(plan.batches)) - 1}: kernel and plain-version hit matrices equal")

    scores, idx = retrieval._search_plan_batch(model, data, items, plan, 0)
    users = plan.user_mat[0, :256]
    q = retrieval.encode_user_batch(model, data, users)
    if model.cfg.similarity == "cosine":
        q = torch.nn.functional.normalize(q, dim=-1)
    host = q.cpu().numpy() @ items.cpu().numpy().T
    for row, blocked in enumerate(plan.blocked_rows[users.long()].cpu().numpy()):
        host[row, blocked[blocked < host.shape[1]]] = -np.inf
    order = np.argsort(-host, axis=1, kind="stable")[:, : plan.deep_k]
    check(ids_agree(idx[:256].cpu(), scores[:256].cpu(), order, np.take_along_axis(host, order, 1)),
          "masked val search: ids differ from the host numpy search")
    log(f"256 users' masked top-{plan.deep_k} ids agree with the host numpy search")


def _ib_step_vs_plain(dev, ctx: dict, pool_size: int):
    """One step of the recommended configuration from the seeded state, the
    first canonical batch and an injected pool of ``pool_size`` uniform ids
    (the first one a positive), no dropout, with the kernels and with their
    plain versions on the card, held within phase 4's tolerances on every
    sparse table. Returns the kernels' state, the step's lanes by table and
    its launches."""
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.train import create_train_state, make_train_step

    cfg, data, nu, ni, b = (ctx[k] for k in ("cfg", "data", "nu", "ni", "batch"))
    tscfg = ctx["tscfg"]._replace(mixed_negatives=pool_size)
    u = torch.from_numpy(ctx["users"][:b]).to(dev)
    p = torch.from_numpy(ctx["items"][:b]).to(dev)
    pool = torch.randint(0, ni, (pool_size,), generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev, dtype=torch.int32)
    pool[: min(pool_size, 1)] = p[0]
    step = make_train_step(cfg, tscfg)
    results = []
    for plain in (False, True):
        state = create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED, device=dev)
        kernels.reset_launch_counts()
        with plain_kernels() if plain else contextlib.nullcontext():
            state, metrics = step(state, data, u, p, generator=None, negatives=pool)
        torch.cuda.synchronize()
        results.append((state, {k: float(v) for k, v in metrics.items()}, kernels.launch_counts()))
    (sk, mk, ck), (sp, mp, _) = results
    items = torch.cat([p, pool]).long()
    lanes = {"user_id": u.long(), "user_aug": u.long(), "item_id": items, "item_aug": items}
    worst = _check_steps(f"in-batch step (M = {pool_size}), kernels vs plain", sk, mk, sp, mp, lanes,
                         steps=int(tscfg.comm_dtype == "bfloat16"))
    for name in ("user_aug", "item_aug"):
        check(not sk.tables[name][-1].any(), f"in-batch step: the {name} scratch row was written")
    want = {"gather_rows": 4, "sparse_adam_rows": 4, "segment_second_moments": 1,
            "segment_second_moments_bwd": 1, "scatter_set_rows": 0}
    check(all(ck[k] == n for k, n in want.items()), f"in-batch step launches {ck}, expected {want}")
    log(f"in-batch step (M = {pool_size}, {items.numel()} item lanes), kernels vs plain on the card: "
        f"losses {mk} | max abs err {worst}")
    return sk, lanes, tscfg


def _ib_row_kernels(dev, ctx: dict, state, lanes: dict, tscfg) -> dict:
    """The row kernels on the sparse mimic tables at the recommended step's
    lanes (``_forward_reads`` and ``_sparse_adam_rows``: bit-identical to
    their plain versions, timed with a cold L2 beside their bound and
    library call) and the category moments at its N = B + M item lanes'
    real category ids (as phase 2)."""
    import torch

    mimic = {"user_aug": lanes["user_aug"], "item_aug": lanes["item_aug"]}
    reads = _forward_reads(state, mimic)
    adam = _sparse_adam_rows(state, mimic, tscfg)
    ids = ctx["data"].category_ids[lanes["item_aug"]]
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((ids.numel(), 128), generator=gen, device=dev) * 0.3
    fwd, bwd, err, _, _ = _moments(ids, x, tscfg.cal_max_categories, gen,
                                   "the in-batch step's item lanes")
    return {"reads": reads, "adam": adam, "moments": {"fwd": fwd, "bwd": bwd, "max_abs_err": err}}


def _ib_mesh_steps(dev, ctx: dict, tscfg) -> dict[str, int]:
    """The recommended configuration's sharded step on a 1x1 DeviceMesh over
    a one-rank NCCL group: MESH_STEPS steps under each routing from the
    seeded state, each against the one-device step on the same batches and
    pools, no dropout, within phase 4's tolerances. Returns the sharded
    steps' launches."""

    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.parallel import MeshConfig, build_mesh, place_data, place_state
    from ttamm_torch.parallel.step import make_sharded_train_step
    from ttamm_torch.train import create_train_state, make_train_step

    cfg, data, nu, ni, b = (ctx[k] for k in ("cfg", "data", "nu", "ni", "batch"))
    batches = []
    for s in range(1, MESH_STEPS + 1):
        u = torch.from_numpy(ctx["users"][s * b : (s + 1) * b]).to(dev)
        p = torch.from_numpy(ctx["items"][s * b : (s + 1) * b]).to(dev)
        pool = torch.randint(0, ni, (tscfg.mixed_negatives,), device=dev, dtype=torch.int32,
                             generator=torch.Generator(device=dev).manual_seed(200 + s))
        batches.append((u, p, pool))

    def run(step, state, d):
        out = []
        for u, p, pool in batches:
            _, metrics = step(state, d, u, p, generator=None, negatives=pool)
            out.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        return out

    def fresh():
        return create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED, device=dev)

    ref = fresh()
    ref_losses = run(make_train_step(cfg, tscfg), ref, data)
    lanes = {
        "user_id": torch.cat([u for u, _, _ in batches]).long(),
        "item_id": torch.cat([torch.cat([p, pool]) for _, p, pool in batches]).long(),
    }
    lanes.update(user_aug=lanes["user_id"], item_aug=lanes["item_id"])
    with one_rank_nccl():
        mesh = build_mesh(MeshConfig(1, 1), "cuda")
        mdata = place_data(mesh, data)
        kernels.reset_launch_counts()
        for routing in ("allgather", "owner"):
            state = place_state(mesh, fresh())
            step = make_sharded_train_step(cfg, tscfg._replace(update_routing=routing), mesh)
            losses = run(step, state, mdata)
            for s, (got, want) in enumerate(zip(losses, ref_losses)):
                check(all(abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-3) for k in want),
                      f"1x1 in-batch {routing} step {s}: losses {got} vs one device {want}")
            worst = _check_steps(f"1x1 in-batch {routing}, {MESH_STEPS} steps", state, losses[-1],
                                 ref, ref_losses[-1], lanes)
            log(f"1x1 sharded in-batch step ({routing}) vs one device, {MESH_STEPS} steps: max abs "
                f"err {worst}")
        counts = kernels.launch_counts()
    steps = 2 * MESH_STEPS
    for name in ("gather_rows_masked", "sparse_adam_rows"):
        check(counts[name] == 4 * steps, f"1x1 in-batch steps: {counts[name]} {name} launches")
    for name in ("gather_rows", "scatter_set_rows", "scatter_set_rows_masked"):
        check(counts[name] == 0, f"{name} launched in the 1x1 in-batch steps")
    log(f"launch counts of the 1x1 sharded in-batch steps: {counts}")
    return counts


def _ib_export_search(dev, work: Path, config: dict, dataset, result) -> None:
    """Export the best checkpoint of the recommended run at the serving
    dtype its gate chose and search 256 users of it: ids equal to the host
    numpy search but where scores tie (1e-5; 2^-6 for a bf16 index)."""
    from ttamm_torch.pipelines.export import export_bundle
    from ttamm_torch.serve import RetrievalService

    dtype = result.serving_score_dtype
    config = dict(config, serving=dict(config["serving"], score_dtype=dtype))
    start = time.perf_counter()
    out = export_bundle(config, work / "bundle", device=dev, checkpoint=result.best_checkpoint_path,
                        dataset=dataset)
    check((out.num_users, out.num_items) == (result.num_users, result.num_items),
          f"in-batch bundle: {out.num_users} x {out.num_items}")
    service = RetrievalService.from_artifacts(work / "bundle", device=dev)
    queries = service.user_embeddings[:256]
    got_s, got_i = service.index.search(queries, K)
    ref_s, ref_i = service.index.search(queries, K, backend="numpy")
    tol = TIE_TOL if dtype == "float32" else BF16_TIE_TOL
    check(ids_agree(got_i, got_s, ref_i, ref_s, tol), "in-batch bundle: ids differ from the numpy search")
    log(f"export of {result.best_checkpoint_path.name} ({dtype}) in {time.perf_counter() - start:.2f} s: "
        f"{out.num_users} users x {out.num_items} items; 256 users' top-{K} ids agree with the "
        "host numpy search")


def phase_in_batch(dev, work: Path, dataset, default_profile: dict, default_result):
    """Phase 5b: the recommended configuration (configs/in_batch_softmax.yaml,
    the logQ-corrected in-batch softmax with sparse mimic tables). Returns
    the kernel parts at its lanes and a summary (the run's launches, which
    count from zero just before its ``run_training``; launches per step;
    the profile; the 1x1 mesh steps' launches)."""
    from ttamm_torch.ops import kernels

    config = _config(work / "data", work / "in_batch", "in_batch_softmax.yaml")
    ctx = _step_inputs(dev, config, dataset)
    for pool_size in (IB_POOL, 0):  # the shipped M = 0 last: its lanes feed (b)
        state, lanes, tscfg = _ib_step_vs_plain(dev, ctx, pool_size)
    parts = _ib_row_kernels(dev, ctx, state, lanes, tscfg)
    del state
    kernels.reset_launch_counts()  # this path's launches start here
    excluded = collections.Counter()
    result, block = phase_train(dev, config, dataset, excluded)
    counts = {k: v - excluded[k] for k, v in kernels.launch_counts().items()}
    log(f"launch counts of the recommended configuration's run: {counts}")
    for name in ("gather_rows", "sparse_adam_rows", "segment_second_moments",
                 "segment_second_moments_bwd", "small_k_topk", "select_topk_from_groups"):
        check(counts[name] > 0, f"{name} never launched in the recommended configuration's run")
    check(counts["scatter_set_rows"] == 0, "scatter_set_rows launched in the recommended run")
    per_step, profile = _profile_steps(dev, config, dataset, result)
    for label, r, prof in (("default (phase 5)", default_result, default_profile),
                           ("in_batch_softmax", result, profile)):
        log(f"{label}: {r.train_seconds / r.steps * 1e3:.3f} ms/step | {r.examples_per_second:.1f} "
            f"examples/s | device {prof['device_ms']:.3f} ms/step | {prof['device_ops']:.1f} device "
            f"ops/step | idle share {prof['idle_share']:.3f} | best val recall@10 "
            f"{r.best_val_metrics.recall[10]:.5f} (epoch {r.best_epoch})")
    _ib_export_search(dev, work / "in_batch", config, dataset, result)
    mesh_counts = _ib_mesh_steps(dev, ctx, tscfg)
    summary = {
        "launches": counts, "launches_per_train_step": per_step, "profile": profile,
        "ms_per_step": result.train_seconds / result.steps * 1e3,
        "examples_per_second": result.examples_per_second,
        "best_val_recall_at_10": result.best_val_metrics.recall[10],
        "result": result,
        "mesh_1x1": {"launches": mesh_counts, "steps": 2 * MESH_STEPS},
        "end_of_run_launches": block,
        "checkpoint_laps_s": [p["ckpt"] for p in result.phase_seconds],
        "checkpoint_wait_s": result.checkpoint_wait_seconds,
    }
    return parts, summary


def _pod_mesh_steps(dev, ctx: dict, tscfg) -> dict:
    """Phase 5c (b) and (c): the pod recipe's sharded step on a 1x1
    DeviceMesh over a one-rank NCCL group, bf16 wire and bf16 features,
    MESH_STEPS steps a routing from the seeded state, no dropout. (b) The
    default lookup (masked gather_rows): each routing held to its own run
    with the plain versions and to the one-device step (allgather within
    phase 4's tolerances, owner within the bound of its second rounding;
    both allowing the bf16 flips of ``_check_steps``), the dtype of each
    tensor the sparse update all-gathers over data printed (bf16 each).
    (c) ``embedding_exchange: alltoall``: the same steps equal to (b)'s bit
    for bit, one gather_rows a table a step at the exchange. Then device
    ms, device ops and host ms a step of each beside the one-device step.
    Returns the launches, the gathers' dtypes and the timing."""

    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.parallel import MeshConfig, build_mesh, place_data, place_state
    from ttamm_torch.parallel import sparse_update
    from ttamm_torch.parallel.step import make_sharded_train_step
    from ttamm_torch.train import create_train_state, make_train_step

    cfg, data, nu, ni, b = (ctx[k] for k in ("cfg", "data", "nu", "ni", "batch"))
    pool = torch.zeros((0,), dtype=torch.int32, device=dev)  # the shipped M = 0
    batches = [(torch.from_numpy(ctx["users"][s * b : (s + 1) * b]).to(dev),
                torch.from_numpy(ctx["items"][s * b : (s + 1) * b]).to(dev), pool)
               for s in range(1, MESH_STEPS + 9)]  # the compared steps, then the timed ones

    def run(step, state, d, plain=False):
        out = []
        with plain_kernels() if plain else contextlib.nullcontext():
            for u, p, negs in batches[:MESH_STEPS]:
                _, metrics = step(state, d, u, p, generator=None, negatives=negs)
                out.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        return out

    def fresh():
        return create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED, device=dev)

    def same_losses(label, got, want, rtol=1e-5):
        for s, (g, w) in enumerate(zip(got, want)):
            check(all(abs(g[k] - w[k]) <= rtol * max(abs(w[k]), 1e-3) for k in w),
                  f"{label} step {s}: losses {g} vs {w}")

    ref, ref_step = fresh(), make_train_step(cfg, tscfg)
    ref_losses = run(ref_step, ref, data)
    lanes = {"user_id": torch.cat([u for u, _, _ in batches[:MESH_STEPS]]).long(),
             "item_id": torch.cat([p for _, p, _ in batches[:MESH_STEPS]]).long()}
    lanes.update(user_aug=lanes["user_id"], item_aug=lanes["item_id"])
    gather = sparse_update.all_gather_rows
    out = {"launches": {}, "gather_dtypes": {}, "timing": {}}
    with one_rank_nccl():
        mesh = build_mesh(MeshConfig(1, 1), "cuda")
        mdata = place_data(mesh, data)
        runs = {}
        for exchange in ("gspmd", "alltoall"):
            for routing in ("allgather", "owner"):
                label = f"{exchange} {routing}"
                step = make_sharded_train_step(
                    cfg, tscfg._replace(update_routing=routing, embedding_exchange=exchange), mesh)
                state, dtypes = place_state(mesh, fresh()), []

                def spy(t, mesh_, axis, dtypes=dtypes):
                    if axis == "data" and t.is_floating_point():
                        dtypes.append(str(t.dtype).removeprefix("torch."))
                    return gather(t, mesh_, axis)

                sparse_update.all_gather_rows = spy
                kernels.reset_launch_counts()
                try:
                    losses = run(step, state, mdata)
                finally:
                    sparse_update.all_gather_rows = gather
                runs[label] = (state, step, losses)
                out["launches"][label] = {k: v for k, v in kernels.launch_counts().items() if v}
                out["gather_dtypes"][label] = dtypes
                log(f"1x1 pod step ({label}): launches {out['launches'][label]} | the sparse "
                    f"update's all-gathers over data carry {dtypes}")
                check(dtypes and all(d == "bfloat16" for d in dtypes),
                      f"1x1 pod {label}: all-gathers over data in {dtypes}, not bfloat16")
                reads = "gather_rows" if exchange == "alltoall" else "gather_rows_masked"
                check(out["launches"][label].get(reads, 0) == len(state.tables) * MESH_STEPS,
                      f"1x1 pod {label}: not one {reads} a table a step")
        for routing in ("allgather", "owner"):  # (b)
            state, step, losses = runs[f"gspmd {routing}"]
            plain = place_state(mesh, fresh())
            plain_losses = run(step, plain, mdata, plain=True)
            same_losses(f"1x1 pod {routing} vs plain", losses, plain_losses)
            worst = _check_steps(f"1x1 pod {routing}, kernels vs plain", state, losses[-1], plain,
                                 plain_losses[-1], lanes, steps=MESH_STEPS)
            log(f"1x1 pod step ({routing}), kernels vs plain, {MESH_STEPS} steps: {worst}")
            owner = routing == "owner"
            same_losses(f"1x1 pod {routing} vs one device", losses, ref_losses)
            worst = _check_steps(f"1x1 pod {routing} vs one device", state, losses[-1], ref,
                                 ref_losses[-1], lanes, steps=MESH_STEPS, second_rounding=owner)
            log(f"1x1 pod step ({routing}) vs one device, {MESH_STEPS} steps"
                f"{' (the second rounding bound)' if owner else ''}: {worst}")
            del plain
        for routing in ("allgather", "owner"):  # (c)
            (a, _, la), (g, _, lg) = runs[f"alltoall {routing}"], runs[f"gspmd {routing}"]
            check(la == lg, f"1x1 pod alltoall {routing}: losses {la} != the default lookup's {lg}")
            pairs = [(f"{n} table", a.tables[n], g.tables[n]) for n in g.tables]
            pairs += [(f"{n} {mom}", getattr(a.opt_sparse[n], mom), getattr(st, mom))
                      for n, st in g.opt_sparse.items() for mom in ("m", "v")]
            pairs += [(k, x.detach(), y.detach()) for (k, x), (_, y) in
                      zip(a.dense_targets(), g.dense_targets())]
            for name, x, y in pairs:
                check(torch.equal(x, y), f"1x1 pod alltoall {routing} {name}: differs from the "
                      "default lookup's step")
            counts = out["launches"][f"alltoall {routing}"]
            tables = len(g.tables)
            check(counts.get("gather_rows", 0) == tables * MESH_STEPS
                  and not counts.get("gather_rows_masked", 0)
                  and counts.get("sparse_adam_rows", 0) == tables * MESH_STEPS,
                  f"1x1 pod alltoall {routing}: launches {counts}")
            log(f"1x1 pod step (alltoall {routing}): losses and {len(pairs)} state tensors "
                f"bit-identical to the default lookup's; gather_rows at the exchange "
                f"{counts.get('gather_rows', 0)} launches in {MESH_STEPS} steps")
        timed = {"one device": (ref, ref_step, data)}
        timed.update({f"1x1 {k}": (st, stp, mdata) for k, (st, stp, _) in runs.items()})
        for label, (state, step, d) in timed.items():
            it = iter(batches[MESH_STEPS:])

            def one(state=state, step=step, d=d, it=it):
                u, p, negs = next(it)
                step(state, d, u, p, generator=None, negatives=negs)

            events = _profiled(one, lambda: [one() for _ in range(4)])
            dev_ms = _per_call_us(events, 4) / 1e3
            check(dev_ms > 0, f"pod step {label}: the profiler saw no device work")
            ops = sum(e.count for e in events if _on_card(e)) / 4
            u, p, negs = batches[-1]
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(3):
                step(state, d, u, p, generator=None, negatives=negs)
            torch.cuda.synchronize()
            out["timing"][label] = {"device_ms": dev_ms, "device_ops": ops,
                                    "host_ms": (time.perf_counter() - start) / 3 * 1e3}
            log(f"pod step {label}: device {dev_ms:.3f} ms, {ops:.1f} device ops | host clock "
                f"{out['timing'][label]['host_ms']:.3f} ms")
    return out


def _pod_export(dev, work: Path, config: dict, dataset, result) -> dict:
    """Phase 5c (e): the export CLI from the best checkpoint directory (at
    the serving dtype the gate chose), against ``export_bundle`` from a flat
    ``.npz`` of the same state, loaded from that directory: every array and
    file of the two bundles equal bit for bit; then 256 users searched, ids
    equal to the host numpy search but where scores tie."""
    import numpy as np
    import yaml

    from ttamm_torch.models.convert import train_state_to_flat
    from ttamm_torch.pipelines import export
    from ttamm_torch.serve import RetrievalService
    from ttamm_torch.train import create_train_state
    from ttamm_torch.train.checkpoint import save_checkpoint
    from ttamm_torch.train.sharded_checkpoint import load_sharded_checkpoint

    dtype, best = result.serving_score_dtype, result.best_checkpoint_path
    check(best.is_dir(), f"the pod run's best checkpoint {best} is not a sharded directory")
    config = dict(config, serving=dict(config["serving"], score_dtype=dtype))
    cfg_path = work / "pod_export.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    start = time.perf_counter()
    export.main(["--config", str(cfg_path), "--out", str(work / "bundle_dir"), "--device", str(dev),
                 "--checkpoint", str(best)])
    cli_s = time.perf_counter() - start
    state = create_train_state(result.state.model.cfg, num_users=result.num_users,
                               num_items=result.num_items, seed=0, device=dev)
    state, meta = load_sharded_checkpoint(best, state)
    flat = save_checkpoint(work / "flat", train_state_to_flat(state), experiment_name="pod",
                           epoch=int(meta["epoch"]), metric_name=None, metric_value=None)
    del state
    export.export_bundle(config, work / "bundle_flat", device=dev, checkpoint=flat, dataset=dataset)
    for name in ("items.index", "vocab.json"):
        check((work / "bundle_dir" / name).read_bytes() == (work / "bundle_flat" / name).read_bytes(),
              f"pod export: {name} differs between the directory and the flat checkpoint")
    for name in ("item_embeddings.npy", "user_embeddings.npy"):
        check(np.array_equal(np.load(work / "bundle_dir" / name), np.load(work / "bundle_flat" / name)),
              f"pod export: {name} differs between the directory and the flat checkpoint")
    service = RetrievalService.from_artifacts(work / "bundle_dir", device=dev)
    queries = service.user_embeddings[:256]
    got_s, got_i = service.index.search(queries, K)
    ref_s, ref_i = service.index.search(queries, K, backend="numpy")
    tol = TIE_TOL if dtype == "float32" else BF16_TIE_TOL
    check(ids_agree(got_i, got_s, ref_i, ref_s, tol), "pod bundle: ids differ from the numpy search")
    log(f"export CLI from the sharded directory {best.name} ({dtype}) in {cli_s:.2f} s (its data prep "
        f"included): bundle equal bit for bit to the flat checkpoint's export; 256 users' top-{K} ids "
        "agree with the host numpy search")
    return {"export_cli_s": cli_s, "score_dtype": dtype}


def phase_pod(dev, work: Path, dataset, ib_summary: dict, ib_result) -> dict:
    """Phase 5c: ``configs/pod_2x4.yaml`` with its mesh set to 1x1 (the bf16
    gradient wire, bf16 feature storage, owner routing, in-batch softmax
    with sparse mimic tables) and ``checkpointing.sharded: true``. (a) one
    step from the seeded state, kernels vs plain versions; (b)-(c) the 1x1
    mesh steps (``_pod_mesh_steps``); (d) two epochs through
    ``run_training`` (its launches counted from zero just before it),
    checked as phase 5b and profiled beside it, the feature matrices' device
    bytes at float32 and bf16; (e) the export CLI from the best checkpoint
    directory (``_pod_export``). Returns the summary phase 8 prints."""
    import torch

    from ttamm_torch.ops import kernels

    config = _config(work / "data", work / "pod", "pod_2x4.yaml")
    config["mesh"] = {"data_parallel": 1, "model_parallel": 1}  # one card, as its header says
    config["training"]["checkpointing"]["sharded"] = True
    ctx = _step_inputs(dev, config, dataset)
    tscfg = ctx["tscfg"]
    check(tscfg.comm_dtype == "bfloat16" and ctx["data"].item_features.dtype == torch.bfloat16,
          "the pod recipe's wire options were not read")
    _ib_step_vs_plain(dev, ctx, tscfg.mixed_negatives)  # (a)
    mesh = _pod_mesh_steps(dev, ctx, tscfg)  # (b), (c)
    feats = (ctx["data"].user_features, ctx["data"].item_features)
    feature_bytes = {"float32": sum(4 * f.numel() for f in feats),
                     "bfloat16": sum(f.element_size() * f.numel() for f in feats)}
    del ctx, feats
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()  # (d): this run's launches start here
    excluded = collections.Counter()
    result, block = phase_train(dev, config, dataset, excluded)
    counts = {k: v - excluded[k] for k, v in kernels.launch_counts().items()}
    log(f"launch counts of the pod recipe's run: {counts}")
    for name in ("gather_rows", "sparse_adam_rows", "segment_second_moments",
                 "segment_second_moments_bwd", "small_k_topk", "select_topk_from_groups"):
        check(counts[name] > 0, f"{name} never launched in the pod recipe's run")
    check(counts["scatter_set_rows"] == 0, "scatter_set_rows launched in the pod recipe's run")
    check(result.best_checkpoint_path.is_dir() and result.checkpoint_path.is_dir(),
          "the pod run did not write sharded checkpoint directories")
    check(result.data.item_features.dtype == torch.bfloat16, "the pod run's features are not bf16")
    per_step, profile = _profile_steps(dev, config, dataset, result)
    for label, r, prof in (("in_batch_softmax (phase 5b)", ib_result, ib_summary["profile"]),
                           ("pod_2x4 at 1x1", result, profile)):
        log(f"{label}: {r.train_seconds / r.steps * 1e3:.3f} ms/step | {r.examples_per_second:.1f} "
            f"examples/s | device {prof['device_ms']:.3f} ms/step | {prof['device_ops']:.1f} device "
            f"ops/step | idle share {prof['idle_share']:.3f} | best val recall@10 "
            f"{r.best_val_metrics.recall[10]:.5f} (epoch {r.best_epoch})")
    log(f"feature matrices on the card: {feature_bytes['float32']} bytes at float32, "
        f"{feature_bytes['bfloat16']} at bf16")
    exported = _pod_export(dev, work / "pod", config, dataset, result)  # (e)
    return {
        "launches": counts, "launches_per_train_step": per_step, "profile": profile,
        "ms_per_step": result.train_seconds / result.steps * 1e3,
        "examples_per_second": result.examples_per_second,
        "best_val_recall_at_10": result.best_val_metrics.recall[10],
        "mesh_1x1": {**mesh, "steps_per_run": MESH_STEPS},
        "feature_bytes": feature_bytes,
        "end_of_run_launches": block,
        "checkpoint_laps_s": [p["ckpt"] for p in result.phase_seconds],
        "checkpoint_wait_s": result.checkpoint_wait_seconds,
        **exported,
    }


def _epoch_ms_per_step(result, epoch: int = 0) -> float:
    """ms a step of one epoch's train lap (host clock)."""
    return result.phase_seconds[epoch]["train"] / (result.steps / len(result.phase_seconds)) * 1e3


def phase_precision(dev, work: Path, dataset, default_result) -> dict:
    """Phase 5d: ``model.precision: bfloat16`` in ``configs/default.yaml``
    (every tower matmul on bf16 operands with float32 sums, its backward
    rounded as the JAX ``_dot``'s). (a) One step from the seeded state with
    injected negatives and no dropout, kernels vs plain versions within
    phase 4's tolerances but for elements a bf16 rounding flip moved (as
    phase 5c: at most FLIP_SHARE of a table's touched ones, each within
    2.5 lr); (b) one epoch through ``run_training`` with the eval (its
    launches counted from zero just before it; gather_rows,
    sparse_adam_rows, the moments, small_k_topk and the select kernel must
    run), its losses finite and falling, its val recall@10 above 20x chance,
    printed with its ms/step beside phase 5's first epoch; then 20 profiled
    steps (device ms, ops, idle share)."""
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sampling import sample_negative_items
    from ttamm_torch.pipelines.training import run_training
    from ttamm_torch.train import create_train_state, make_train_step

    config = _config(work / "data", work / "precision")
    config["model"]["precision"] = "bfloat16"
    config["training"]["num_epochs"] = 1
    ctx = _step_inputs(dev, config, dataset)
    cfg, tscfg, data, nu, ni, b = (ctx[k] for k in ("cfg", "tscfg", "data", "nu", "ni", "batch"))
    check(cfg.user_tower.compute_dtype == cfg.item_tower.compute_dtype == "bfloat16",
          "model.precision did not reach the towers")
    u = torch.from_numpy(ctx["users"][:b]).to(dev)
    p = torch.from_numpy(ctx["items"][:b]).to(dev)
    neg = sample_negative_items(
        data.positive_rows[u.long()], num_items=ni, num_negatives=tscfg.negatives_per_positive,
        generator=torch.Generator(device=dev).manual_seed(3),
    )
    step = make_train_step(cfg, tscfg)
    results = []
    for plain in (False, True):
        state = create_train_state(cfg, num_users=nu, num_items=ni, seed=STEP_SEED, device=dev)
        with plain_kernels() if plain else contextlib.nullcontext():
            state, metrics = step(state, data, u, p, generator=None, negatives=neg)
        torch.cuda.synchronize()
        results.append((state, {k: float(v) for k, v in metrics.items()}))
    (sk, mk), (sp, mp) = results
    worst = _check_steps("bf16 precision step, kernels vs plain", sk, mk, sp, mp,
                         {"user_id": u.long(), "item_id": torch.cat([p, neg.reshape(-1)]).long()},
                         steps=1)
    check(all(t.dtype == torch.float32 for _, t in sk.dense_targets()), "bf16 precision: weights not f32")
    log(f"one bf16-precision step, kernels vs plain on the card: losses {mk} | max abs err {worst}")
    del results, sk, sp, ctx
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()  # this path's launches: the epoch's run
    start = time.perf_counter()
    result = run_training(config, device=dev, dataset=dataset)
    seconds = time.perf_counter() - start
    counts = kernels.launch_counts()
    log(f"launch counts of the bf16-precision run: {counts}")
    for name in ("gather_rows", "sparse_adam_rows", "segment_second_moments",
                 "segment_second_moments_bwd", "small_k_topk", "select_topk_from_groups"):
        check(counts[name] > 0, f"{name} never launched in the bf16-precision run")
    check(counts["scatter_set_rows"] == 0, "scatter_set_rows launched in the bf16-precision run")
    losses = [result.first_step_loss, *result.train_loss, *result.val_loss, *result.test_loss]
    check(all(math.isfinite(v) for v in losses), "bf16 precision: non-finite loss")
    check(result.train_loss[-1] < result.first_step_loss, "bf16 precision: the epoch's loss did not fall")
    val = result.val_metrics[0]
    check(val.recall[5] <= val.recall[10] <= val.recall[20], "bf16 precision: recall not monotone in k")
    check(val.recall[10] > 20 * 10 / result.num_items, "bf16 precision: val recall@10 not above 20x chance")
    check(_written(result.best_checkpoint_path) and Path(config["evaluation"]["faiss"]["index_path"]).is_file(),
          "bf16 precision: no checkpoint or serving index written")
    per_step, profile = _profile_steps(dev, config, dataset, result)
    first = default_result.val_metrics[0]
    for label, r, m in (("float32 (phase 5, epoch 1)", default_result, first),
                        ("bfloat16 (epoch 1)", result, val)):
        log(f"{label}: val recall@10 {m.recall[10]:.5f} ndcg@10 {m.ndcg[10]:.5f} | "
            f"{_epoch_ms_per_step(r):.3f} ms/step (host clock)")
    log(f"bf16 precision: {seconds:.2f} s for the run | device {profile['device_ms']:.3f} ms/step | "
        f"{profile['device_ops']:.1f} device ops/step | idle share {profile['idle_share']:.3f} | "
        f"serving score dtype {result.serving_score_dtype}")
    return {
        "launches": counts, "launches_per_train_step": per_step, "profile": profile,
        "step_max_abs_err": worst,
        "ms_per_step": _epoch_ms_per_step(result),
        "float32_epoch1_ms_per_step": _epoch_ms_per_step(default_result),
        "val_recall_at_10": val.recall[10],
        "float32_epoch1_val_recall_at_10": first.recall[10],
    }


def _http(port: int, path: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _search_table(index, queries) -> None:
    """Search speed by score dtype and algorithm: batched FlatIndex.search
    queries/s on the host clock (host normalisation and copies included),
    and the device time of mips_topk alone."""
    import torch

    from ttamm_torch.ops.topk import mips_topk
    from ttamm_torch.serve import FlatIndex

    label = f"{len(index)} items"
    unit = torch.nn.functional.normalize(torch.from_numpy(queries).to(index.device), dim=1)
    for score_dtype in ("float32", "bfloat16"):
        idx = FlatIndex(index.embeddings, index.normalized, score_dtype, device=index.device)
        for algorithm in ("auto", "group_exact", "fused"):
            qps = host_qps(lambda: idx.search(queries, K, algorithm=algorithm), len(queries))
            ms = device_ms(lambda: mips_topk(
                unit, idx.corpus, k=K, num_valid_rows=len(idx), algorithm=algorithm,
                score_dtype=score_dtype,
            ))
            log(f"search {label} {score_dtype} {algorithm}: {qps:.1f} queries/s "
                f"| mips_topk {ms:.4f} ms on the device (B={len(queries)}, k={K})")
        del idx


def _serve_checks(service, dev, tol: float, label: str) -> None:
    """``service`` behind the HTTP front end (``/healthz``, GET user, POST
    user, POST embedding): every answer's ids equal the host numpy search
    but where scores tie within ``tol``."""
    from ttamm_torch.serve import start_in_thread

    check(service.index.device == dev, f"index on {service.index.device}, not {dev}")
    srv, thread = start_in_thread(service, port=0)
    port = srv.server_address[1]
    try:
        status, body = _http(port, "/healthz")
        check(status == 200 and body["items"] == len(service.index), f"/healthz: {status} {body}")
        log(f"/healthz: {body}")
        item_pos = {asin: i for i, asin in enumerate(service.item_ids)}
        requests = [
            ("GET user", service.user_ids[0], None, f"/v1/recommend?user_id={service.user_ids[0]}&k={K}"),
            ("POST user", service.user_ids[1], {"user_id": service.user_ids[1], "k": K}, "/v1/recommend"),
            ("POST user", service.user_ids[2], {"user_id": service.user_ids[2], "k": K}, "/v1/recommend"),
            ("POST embedding", service.user_ids[3],
             {"embedding": service.user_embeddings[3].tolist(), "k": K}, "/v1/recommend"),
        ]
        for what, uid, payload, path in requests:
            status, body = _http(port, path, payload)
            check(status == 200 and len(body["items"]) == K, f"{what}: {status}, {len(body.get('items', []))} items")
            query = service.user_embeddings[service.user_to_idx[uid]][None, :]
            ref_s, ref_i = service.index.search(query, K, backend="numpy")
            ids = [item_pos[it["asin"]] for it in body["items"]]
            scores = [it["score"] for it in body["items"]]
            check(ids_agree(ids, scores, ref_i[0], ref_s[0], tol), f"{what} ({label}): ids differ from the numpy search")
            log(f"{what} {uid} ({label}): 200, {K} items, ids agree with the numpy search")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "HTTP server thread did not stop")


def phase_serve(dev, work: Path, config: dict, dataset, checkpoint: Path, score_dtype: str) -> None:
    import numpy as np
    import torch

    from ttamm_torch.pipelines.export import export_bundle
    from ttamm_torch.serve import RetrievalService

    config = dict(config, serving=dict(config["serving"], score_dtype=score_dtype))
    tol = TIE_TOL if score_dtype == "float32" else BF16_TIE_TOL
    start = time.perf_counter()
    result = export_bundle(config, work / "bundle", device=dev, checkpoint=checkpoint, dataset=dataset)
    log(f"export from {checkpoint.name}: {time.perf_counter() - start:.2f} s | users "
        f"{result.num_users} items {result.num_items} dim {result.embedding_dim} "
        f"score_dtype {result.score_dtype}")
    for side, rows in (("item", result.num_items), ("user", result.num_users)):
        secs = result.encode_seconds[side]
        log(f"encode {side}s: {rows} rows in {secs * 1e3:.3f} ms = {rows / secs:.1f} rows/s")

    service = RetrievalService.from_artifacts(work / "bundle", device=dev)
    _serve_checks(service, dev, tol, "export bundle")

    # the trainer's own index directory is a bundle too: the best state's
    # user embeddings (equal to export's from the best checkpoint) and vocab
    trained_dir = Path(config["evaluation"]["faiss"]["index_path"]).parent
    trained = RetrievalService.from_artifacts(trained_dir, device=dev)
    check(trained.user_ids == service.user_ids and trained.item_ids == service.item_ids,
          "the trainer's vocab.json differs from the export's")
    diff = float(np.abs(trained.user_embeddings - service.user_embeddings).max())
    log(f"trainer's bundle {trained_dir.name}/: user embeddings within {diff:.3e} of the export's")
    check(diff <= 1e-5, f"the trainer's user embeddings differ from the export's by {diff:.3e}")
    _serve_checks(trained, dev, tol, "trainer's bundle")
    del trained

    queries = service.user_embeddings[:BATCH]
    got_s, got_i = service.index.search(queries, K)
    ref_s, ref_i = service.index.search(queries, K, backend="numpy")
    check(ids_agree(got_i, got_s, ref_i, ref_s, tol), "batched search: ids differ from the numpy search")
    log("batched FlatIndex.search: ids agree with the numpy search")
    _search_table(service.index, queries)
    del service
    torch.cuda.empty_cache()


def _cli_start(*args: str) -> tuple[subprocess.Popen, float]:
    """``python -m <args>`` from the checkout, started (with its start
    time)."""
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def _cli_wait(started: tuple[subprocess.Popen, float], label: str) -> str:
    """The stdout of a started CLI once it has exited 0; its seconds logged."""
    proc, start = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    check(proc.returncode == 0, f"{label} exited {proc.returncode}:\n{err[-4000:]}")
    log(f"{label}: exited 0 after {time.perf_counter() - start:.2f} s")
    return out


def _preprocess_config(work: Path, config: dict) -> Path:
    """Phase 3's config with ``data.cache_dir`` under ``work``."""
    import yaml

    cfg = json.loads(json.dumps(config))
    cfg["data"]["cache_dir"] = str(work / "cli" / "cache")
    path = work / "cli" / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _check_preprocess(work: Path, out: str, dataset) -> None:
    """6b (a): the preprocess CLI's arrays and vocabularies are phase 3's
    dataset."""
    import numpy as np

    from ttamm_torch.data import build_item_categories, pack_positives

    log("preprocess CLI: " + " | ".join(out.splitlines()))
    nu, ni = len(dataset.user_mapping), len(dataset.item_mapping)
    packed = pack_positives(dataset.user_positive_items, num_users=nu, num_items=ni)
    want = {
        "item_features": dataset.item_feature_matrix,
        "user_features": dataset.user_feature_matrix,
        "positive_rows": packed.rows,
        "positive_counts": packed.counts,
        "user_idx": dataset.interactions["user_idx"].to_numpy(np.int32),
        "item_idx": dataset.interactions["item_idx"].to_numpy(np.int32),
        "category_ids": build_item_categories(dataset.items, num_items=ni).category_ids,
    }
    with np.load(work / "cli" / "cache" / "training_arrays.npz") as got:
        check(sorted(got.files) == sorted(want), f"training_arrays.npz holds {sorted(got.files)}")
        for key, value in want.items():
            check(got[key].dtype == value.dtype and np.array_equal(got[key], value),
                  f"preprocess CLI: {key} differs from phase 3's dataset")
    vocab = json.loads((work / "cli" / "cache" / "vocab.json").read_text())
    check(vocab["user_ids"] == list(dataset.user_mapping.index_to_id)
          and vocab["item_ids"] == list(dataset.item_mapping.index_to_id),
          "preprocess CLI: vocab.json's ids differ from phase 3's index maps")
    log(f"preprocess CLI: the 7 arrays equal phase 3's dataset ({nu} users, {ni} items), "
        "vocab ids equal its index maps")


def _true_scores(index, queries, ids):
    """The float32 scores of ``ids`` for each normalised query row."""
    import numpy as np

    q = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    return np.einsum("bd,bkd->bk", q, index.embeddings[ids])


def _query_ids(text: str):
    import numpy as np

    return np.asarray([[int(p.split(":")[0]) for p in line.split(": ", 1)[1].split(", ")]
                       for line in text.strip().splitlines()])


def _profile_run(dev, work: Path, config: dict, dataset) -> dict:
    """6b (d): ``run_training`` with ``diagnostics.profile_dir`` over
    PROFILE_STEPS steps: one trace, which names the row and moments
    kernels by their CUDA names."""
    from ttamm_torch.pipelines.training import run_training

    cfg = json.loads(json.dumps(config))
    run_dir = work / "profile_run"
    cfg["training"]["num_epochs"] = 1
    cfg["training"]["checkpointing"]["enabled"] = False
    cfg["experiment"]["benchmark_report"] = None
    cfg["evaluation"]["faiss"].update(index_path=str(run_dir / "faiss" / "items.index"),
                                      embedding_path=str(run_dir / "faiss" / "item_embeddings.npy"))
    for key in ("report_path", "loss_plot_path", "embedding_summary_path"):
        cfg["diagnostics"][key] = str(run_dir / "reports" / Path(cfg["diagnostics"][key]).name)
    cfg["diagnostics"]["profile_dir"] = str(work / "profile")
    start = time.perf_counter()
    result = run_training(cfg, device=dev, max_steps=PROFILE_STEPS, dataset=dataset)
    traces = sorted((work / "profile").glob("*.json"))
    check(result.steps == PROFILE_STEPS and len(traces) == 1, f"profile_dir holds {traces}")
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    found = {k: sorted(n for n in names if k in n)[:1]
             for k in ("sparse_adam_rows_kernel", "m2_chunk_kernel", "gather_rows_kernel")}
    log(f"profile trace {traces[0].name}: {traces[0].stat().st_size / 1e6:.1f} MB, "
        f"{len(names)} names, {time.perf_counter() - start:.2f} s with the run | kernels {found}")
    check(all(found.values()), f"the trace does not name {[k for k, v in found.items() if not v]}")
    return found


def phase_cli(dev, work: Path, config: dict, dataset) -> dict:
    """Phase 6b: the port's command lines and host backends on phase 6's
    bundle and phase 3's corpus. The CLIs run side by side, each in a
    process of its own, while this process runs (d); the host backends are
    timed after, alone. Returns the summary (host ms of each backend, the
    trace's kernels) and this phase's launches."""
    import numpy as np
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.serve import RetrievalService

    bundle = work / "bundle"
    service = RetrievalService.from_artifacts(bundle, device=dev)
    index = service.index
    score_dtype = index.score_dtype
    tol = TIE_TOL if score_dtype == "float32" else BF16_TIE_TOL
    queries = service.user_embeddings[:BATCH]
    users = service.user_ids[:8]
    (work / "cli").mkdir(parents=True, exist_ok=True)
    np.save(work / "cli" / "queries.npy", queries)
    # (a) preprocess on phase 3's CSVs and config; (b) the query CLI on the
    # bundle's index and its first 1,024 users; (c) the serve CLI for 8 users
    procs = {"preprocess CLI": _cli_start(
        "ttamm_torch.pipelines.preprocess", "--config", str(_preprocess_config(work, config)))}
    for backend in ("numpy", "native", "device"):
        procs[f"query CLI --backend {backend}"] = _cli_start(
            "ttamm_torch.serve.query", "--index", str(bundle / "items.index"), "--queries",
            str(work / "cli" / "queries.npy"), "--k", str(K), "--backend", backend)
    for backend in ("native", "device"):
        args = ["ttamm_torch.serve", "--artifacts", str(bundle), "--k", str(K), "--backend", backend]
        for uid in users:
            args += ["--user-id", uid]
        procs[f"serve CLI --backend {backend}"] = _cli_start(*args)
    try:
        found = _profile_run(dev, work, config, dataset)  # (d), meanwhile
    except BaseException:
        for proc, _ in procs.values():  # (d) failed: stop the CLIs, keep its error
            proc.kill()
            proc.communicate()
        raise
    outs = {label: _cli_wait(proc, label) for label, proc in procs.items()}

    _check_preprocess(work, outs["preprocess CLI"], dataset)
    ref = _query_ids(outs["query CLI --backend numpy"])
    check(ref.shape == (BATCH, K), f"query CLI printed {ref.shape} ids")
    for backend in ("native", "device"):
        ids = _query_ids(outs[f"query CLI --backend {backend}"])
        check(ids.shape == ref.shape and ids_agree(
            ids, _true_scores(index, queries, ids), ref, _true_scores(index, queries, ref),
            TIE_TOL if backend == "native" else tol),
            f"query CLI --backend {backend}: ids differ from --backend numpy beyond ties")
        log(f"query CLI --backend {backend}: ids agree with --backend numpy ({score_dtype} index)")
    lines = {b: outs[f"serve CLI --backend {b}"].strip().splitlines() for b in ("native", "device")}
    check(all(len(v) == len(users) for v in lines.values()), f"serve CLI printed {lines}")
    item_pos = {asin: i for i, asin in enumerate(service.item_ids)}
    for got, want in zip(lines["device"], lines["native"]):
        (uid, g), (_, w) = got.split("\t"), want.split("\t")
        ids = np.asarray([[item_pos[p.rsplit(":", 1)[0]] for p in g.split(", ")]])
        ref_ids = np.asarray([[item_pos[p.rsplit(":", 1)[0]] for p in w.split(", ")]])
        q = service.user_embeddings[service.user_to_idx[uid]][None, :]
        check(ids_agree(ids, _true_scores(index, q, ids), ref_ids, _true_scores(index, q, ref_ids), tol),
              f"serve CLI: user {uid}'s asins differ between --backend device and native")
    log(f"serve CLI: {len(users)} users, the same asins under --backend device and native (ties aside)")

    host_ms = {}
    for backend, iters in (("device", 15), ("native", 5), ("numpy", 3)):
        qps = host_qps(lambda: index.search(queries, K, backend=backend), BATCH, iters=iters)
        host_ms[backend] = BATCH / qps * 1e3
        log(f"FlatIndex.search --backend {backend}: {host_ms[backend]:.3f} host ms for {BATCH} "
            f"queries ({qps:.1f} queries/s), {len(index)} items, {score_dtype}")
    del service, index
    torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    for name in ("small_k_topk", "select_topk_from_groups", "gather_rows", "sparse_adam_rows",
                 "segment_second_moments"):
        check(launches[name] > 0, f"{name} not launched in phase 6b")
    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    cpu = ", ".join(line.split(":", 1)[1].strip() for line in lscpu.splitlines()
                    if line.startswith(("Vendor ID", "Model name", "CPU family", "Model:")))
    log(f"host CPU (lscpu: vendor, model name, family, model): {cpu}; {os.cpu_count()} cores")
    return {"host_ms_1024_queries": host_ms, "score_dtype": score_dtype, "trace_kernels": found,
            "host_cpu": cpu, "launches": launches}


def phase_corpus_scale(dev) -> None:
    import numpy as np
    import torch

    from ttamm_torch.ops import topk
    from ttamm_torch.serve import build_flat_index

    rng = np.random.default_rng(2024)
    rows = rng.standard_normal((CORPUS_ROWS, CORPUS_DIM), dtype=np.float32)
    queries = rng.standard_normal((BATCH, CORPUS_DIM), dtype=np.float32)
    index = build_flat_index(rows, normalize=True, score_dtype="bfloat16", device=dev)
    del rows
    log(f"index: {len(index)} x {index.dim} bf16-scored on {index.device}")

    fused_s, fused_i = index.search(queries, K, algorithm="fused")
    # the plain versions on the same inputs (normalised as FlatIndex.search does)
    unit = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    q = torch.from_numpy(unit).to(dev).to(torch.bfloat16)
    plain_s, plain_i = topk._fused_groupmax_topk(q, index.corpus, K, len(index), plain=True)
    check(ids_agree(fused_i, fused_s, plain_i.cpu().numpy(), plain_s.cpu().numpy()),
          "fused kernels' ids differ from the plain-version fused ids")
    log("fused ids agree with the plain-version fused ids")

    # A masked bf16 search: 32 blocked ids per query, half of them the
    # query's own top ids. auto must take fused (M <= 32, >= 500k items).
    from ttamm_torch.ops import kernels

    mask = np.random.default_rng(32).integers(0, CORPUS_ROWS, (BATCH, 32)).astype(np.int32)
    mask[:, :16] = fused_i[:, :16]
    mask_t = torch.from_numpy(mask).to(dev)
    before = kernels.launch_counts()["groupmax_matmul"]
    got_s, got_i = topk.mips_topk(
        torch.from_numpy(unit).to(dev), index.corpus, k=K, num_valid_rows=len(index),
        mask_rows=mask_t, score_dtype="bfloat16",
    )
    check(kernels.launch_counts()["groupmax_matmul"] == before + 1,
          "auto did not route the masked bf16 search to fused")
    plain_s, plain_i = topk._fused_groupmax_topk(
        q, index.corpus, K, len(index), mask_rows=mask_t, plain=True
    )
    got_i, got_s = got_i.cpu().numpy(), got_s.cpu().numpy()
    check(ids_agree(got_i, got_s, plain_i.cpu().numpy(), plain_s.cpu().numpy()),
          "masked fused ids differ from the plain-version masked fused ids")
    check(not (got_i[:, :, None] == mask[:, None, :]).any(), "a blocked id came back")
    log("masked bf16 fused (auto, M = 32): ids agree with the plain version, no blocked id returned")
    _search_table(index, queries)
    # bf16 crossover sweep (logged, not acted on): mips_topk device ms of
    # group_exact and fused over the first n rows of the index (a whole-group
    # slice, the rows past n masked by num_valid_rows, so no per-call pad)
    unit_t = torch.from_numpy(unit).to(dev)
    for n in (500_000, 1_000_000, CORPUS_ROWS):
        rows_n = index.corpus[: -(-n // kernels.GROUP) * kernels.GROUP]
        ms = {alg: device_ms(lambda alg=alg: topk.mips_topk(
            unit_t, rows_n, k=K, num_valid_rows=n, algorithm=alg, score_dtype="bfloat16"), iters=5)
            for alg in ("group_exact", "fused")}
        log(f"bf16 sweep {n} items: group_exact {ms['group_exact']:.4f} ms | fused "
            f"{ms['fused']:.4f} ms on the device (B={BATCH}, k={K})")
    del index, q, mask_t
    torch.cuda.empty_cache()


def phase_chunked(dev) -> dict:
    """Phase 7b: the chunked search past the float32 slab ceiling. A seeded
    10,000,000 x 128 float32 cosine index (unit rows drawn on the card);
    B = 1024 queries at k = 20 through ``FlatIndex.search`` (``auto``, which
    must scan in chunks of ``chunk_items(1024)``), then a masked search (M = 32, half of each
    row the query's own top ids): the launches of these two searches,
    counted from zero just before them, are this path's (small_k_topk twice
    a chunk: the chunk's top k and the merge, nothing else). Then, outside
    the counts: the ids and scores equal the chunk scan with small_k_topk's
    plain version (ties included); 32 queries' ids equal a host numpy search
    but where scores tie within 1e-5; no blocked id comes back; at 2M items
    an explicit chunked search equals group_exact's ids (ties within 1e-5
    aside); then device ms and host ms a search."""
    import numpy as np
    import torch

    from ttamm_torch.ops import kernels, topk
    from ttamm_torch.serve import FlatIndex

    chunk = topk.chunk_items(BATCH)
    n = CHUNKED_ROWS
    check(64 * n * 4 > topk.SCORES_BYTES_CEILING, "the corpus is within the slab ceiling")
    gen = torch.Generator(device=dev).manual_seed(2026)
    rows = torch.nn.functional.normalize(torch.randn((n, CORPUS_DIM), generator=gen, device=dev), dim=1)
    queries = torch.randn((BATCH, CORPUS_DIM), generator=gen, device=dev).cpu().numpy()
    start = time.perf_counter()
    index = FlatIndex(rows.cpu().numpy(), normalized=True, score_dtype="float32", device=dev)
    del rows
    log(f"index: {len(index)} x {index.dim} float32 on {index.device} "
        f"({index.corpus.numel() * 4 / 1e9:.2f} GB on the card, built in {time.perf_counter() - start:.2f} s)")
    unit = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    q = torch.from_numpy(unit).to(dev)
    rng = np.random.default_rng(33)

    scans, scan = [], topk._chunked_topk
    topk._chunked_topk = (
        lambda *a, **kw: scans.append(kw.get("chunk_size") or topk.chunk_items(a[0].shape[0]))
        or scan(*a, **kw)
    )
    try:
        kernels.reset_launch_counts()  # this path's launches: the two searches
        got_s, got_i = index.search(queries, K)
        mask = rng.integers(0, n, (BATCH, 32)).astype(np.int32)
        mask[:, :16] = got_i[:, :16]
        mask_t = torch.from_numpy(mask).to(dev)
        masked_s, masked_i = topk.mips_topk(q, index.corpus, k=K, num_valid_rows=n, mask_rows=mask_t)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        topk._chunked_topk = scan
    chunks = -(-n // chunk)
    check(scans == [chunk, chunk], f"auto took {scans} chunk scans, not the chunked search twice")
    check(counts["small_k_topk"] == 4 * chunks
          and all(v == 0 for k, v in counts.items() if k != "small_k_topk"),
          f"launches of two chunked searches: {counts}")
    log(f"auto routed both searches to chunked: {chunks} chunks of {chunk} items a search, small_k_topk "
        f"{counts['small_k_topk'] // 2} launches a search (a chunk's top k and its merge)")

    plain_s, plain_i = topk._chunked_topk(q, index.corpus, K, n, chunk_size=chunk, plain=True)
    check(np.array_equal(got_i, plain_i.cpu().numpy()) and np.array_equal(got_s, plain_s.cpu().numpy()),
          "chunked ids or scores differ from the scan with small_k_topk's plain version")
    log("chunked ids and scores equal the scan with small_k_topk's plain version (ties included)")
    host = index.embeddings
    ref_scores = unit[:32] @ host.T
    ref_i = np.argpartition(-ref_scores, K, axis=1)[:, :K]
    ref_s = np.take_along_axis(ref_scores, ref_i, axis=1)
    order = np.argsort(-ref_s, axis=1, kind="stable")
    ref_i, ref_s = np.take_along_axis(ref_i, order, 1), np.take_along_axis(ref_s, order, 1)
    del ref_scores
    check(ids_agree(got_i[:32], got_s[:32], ref_i, ref_s), "chunked ids differ from the host numpy search")
    log("32 queries' ids agree with a host numpy search (ties within 1e-5 aside)")
    masked_i = masked_i.cpu().numpy()
    check(not (masked_i[:, :, None] == mask[:, None, :]).any(), "the masked chunked search returned a blocked id")
    check(bool((masked_s > topk.NEG_INF).all()), "the masked chunked search ran short of items")
    log("masked chunked search (M = 32, half each query's own top ids): no blocked id returned")
    two_m = index.corpus[:CORPUS_ROWS]
    ge_s, ge_i = topk.mips_topk(q, two_m, k=K, algorithm="group_exact")
    ch_s, ch_i = topk.mips_topk(q, two_m, k=K, algorithm="chunked")
    check(ids_agree(ch_i.cpu().numpy(), ch_s.cpu().numpy(), ge_i.cpu().numpy(), ge_s.cpu().numpy()),
          "chunked ids at 2M items differ from group_exact's")
    log(f"explicit chunked at {CORPUS_ROWS} items: ids agree with group_exact (ties within 1e-5 aside)")

    dev_ms = device_ms(lambda: topk.mips_topk(q, index.corpus, k=K, num_valid_rows=n), iters=3,
                       warmup=1)
    dev_ms_2m = {alg: device_ms(lambda alg=alg: topk.mips_topk(q, two_m, k=K, algorithm=alg), iters=3,
                                warmup=1) for alg in ("chunked", "group_exact")}
    times = []
    for _ in range(3):
        start = time.perf_counter()
        index.search(queries, K)
        times.append(time.perf_counter() - start)
    host_ms = sorted(times)[1] * 1e3
    log(f"chunked search of {n} items (B={BATCH}, k={K}): device {dev_ms:.3f} ms | host clock "
        f"{host_ms:.3f} ms ({BATCH / host_ms * 1e3:.1f} queries/s) | {counts['small_k_topk'] // 2} "
        f"small_k_topk launches a search")
    log(f"at {CORPUS_ROWS} items: chunked {dev_ms_2m['chunked']:.3f} ms | group_exact "
        f"{dev_ms_2m['group_exact']:.3f} ms on the device")
    del index, q, mask_t, two_m
    torch.cuda.empty_cache()
    return {"launches": counts, "chunk_items": chunk, "chunks_per_search": chunks,
            "small_k_topk_launches_per_search": counts["small_k_topk"] // 2,
            "device_ms": dev_ms, "host_ms": host_ms, "device_ms_2m": dev_ms_2m}


def main() -> int:
    if not (REPO / "ttamm_torch" / "csrc").is_dir():
        print("chip_smoke: ttamm_torch/ not found beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from ttamm_torch.device import resolve_device
    from ttamm_torch.ops import kernels

    dev = resolve_device("cuda")
    try:
        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_") as tmp:
            work = Path(tmp)
            with Phase("1 build and device"):
                smi = phase_build(dev)
            with Phase("2 kernels vs plain versions"):
                kernel_rows = _search_kernels(dev)
                kernel_rows.update(_select_kernel(dev))
                kernel_rows.update(_training_kernels(dev, 199_449, 99_880, 2048, 5, 64))
                for name, row in kernel_rows.items():
                    _log_row(name, row)
                torch.cuda.empty_cache()
            with Phase("3 canonical corpus and data prep"):
                config, dataset = phase_corpus(work)
            with Phase("4 one train step, kernels vs plain versions"):
                rows, step_ctx = phase_step_vs_plain(dev, config, dataset)
                canonical = rows.pop("segment_second_moments_canonical")
                m2_row = kernel_rows["segment_second_moments"]
                m2_row["max_abs_err"] = max(m2_row["max_abs_err"], canonical.pop("max_abs_err"))
                m2_row["parts"].update({f"{k}_canonical": v for k, v in canonical.items()})
                kernel_rows.update(rows)
            with Phase("4b the multi-device layer on one card"):
                # compared: the launches of phases 2-4b's comparisons (the
                # sharded steps count from zero)
                rows, compared, mesh_counts, mesh_timing = phase_mesh(dev, step_ctx)
                kernel_rows.update(rows)
                kernel_rows["sparse_adam_rows"]["parts"].update(mesh_timing.pop("sparse_adam_rows"))
                torch.cuda.empty_cache()
            with Phase("4c packed sparse-Adam moments"):
                packed_summary = phase_packed(dev, step_ctx, work)
                torch.cuda.empty_cache()
            with Phase("4d tensor parallel at 1x1"):
                tp_summary = phase_tensor_parallel(dev, work, step_ctx, config, dataset)
                del step_ctx
                torch.cuda.empty_cache()
            with Phase("4e steps_per_call: the step as CUDA-graph replays"):
                multi_summary = phase_multi_step(dev, work, config, dataset)
            with Phase("4f the mesh's multi-step: sharded steps as CUDA-graph replays"):
                mesh_multi_summary = phase_mesh_multi_step(dev, work, config, dataset,
                                                           multi_summary)
            kernels.reset_launch_counts()  # the main path's launches start here
            excluded = collections.Counter()
            with Phase("5 train two epochs with the eval at the canonical scale"):
                result, block = phase_train(dev, config, dataset, excluded)
                per_step, profile = _profile_steps(dev, config, dataset, result)
                with uncounted(excluded):
                    checkpoint_ab = _checkpoint_ab(dev, config, dataset, result, work)
                torch.cuda.empty_cache()
            path_counts = collections.Counter(kernels.launch_counts())  # phase 5's launches
            with Phase("5b the recommended configuration: in-batch softmax, sparse mimic tables"):
                ib_parts, ib_summary = phase_in_batch(dev, work, dataset, profile, result)
                kernel_rows["gather_rows"]["parts"].update(
                    {f"in_batch_{k}": v for k, v in ib_parts["reads"].items()})
                kernel_rows["sparse_adam_rows"]["parts"].update(
                    {f"in_batch_{k}": v for k, v in ib_parts["adam"].items()})
                m2_row = kernel_rows["segment_second_moments"]
                m2_row["max_abs_err"] = max(m2_row["max_abs_err"], ib_parts["moments"]["max_abs_err"])
                m2_row["parts"].update(fwd_in_batch=ib_parts["moments"]["fwd"],
                                       bwd_in_batch=ib_parts["moments"]["bwd"])
                torch.cuda.empty_cache()
            with Phase("5c the pod recipe at 1x1: bf16 wire and features, sharded checkpoints, "
                       "the all-to-all exchange"):
                ib_result = ib_summary.pop("result")
                pod_summary = phase_pod(dev, work, dataset, ib_summary, ib_result)
                del ib_result
                torch.cuda.empty_cache()
            with Phase("5d model.precision: bfloat16"):
                precision_summary = phase_precision(dev, work, dataset, result)
                torch.cuda.empty_cache()
            kernels.reset_launch_counts()  # phase 6's launches start here
            with Phase("6 export from the best checkpoint and serve"):
                phase_serve(dev, work, config, dataset, result.best_checkpoint_path,
                            result.serving_score_dtype)
            path_counts.update(kernels.launch_counts())  # phase 6's launches
            kernels.reset_launch_counts()  # phase 6b's start here
            with Phase("6b the port's CLIs and host backends"):
                cli_summary = phase_cli(dev, work, config, dataset)
                path_counts.update(cli_summary.pop("launches"))
                torch.cuda.empty_cache()
            kernels.reset_launch_counts()  # phase 7's start here
            with Phase("7 corpus scale"):
                phase_corpus_scale(dev)
            path_counts.update(kernels.launch_counts())  # phase 7's launches
            with Phase("7b the chunked search past the slab ceiling"):
                chunked_summary = phase_chunked(dev)
                path_counts.update(chunked_summary["launches"])
            with Phase("8 launch counts"):
                counts = {k: v - excluded[k] for k, v in path_counts.items()}
                log(f"launch counts (phases 5-7b): {counts} | left out (comparisons): {dict(excluded)}")
                counts.update({k: mesh_counts[k] for k in MESH_KERNELS})
                for name, n in counts.items():
                    if name in COMPARED_ONLY:
                        check(compared[name] > 0, f"{name} never held to its plain version")
                    else:
                        check(n > 0, f"{name} never launched on its path")
                leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "ttamm_tpu")))
                check(not leaked, f"imported {leaked[:5]}")
    except Exception:
        traceback.print_exc()
        return 1

    launches = dict(counts)
    launches["segment_second_moments"] += launches.pop("segment_second_moments_bwd")
    summary = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": KERNEL_INFO[name][0],
                "replaces": KERNEL_INFO[name][1],
                "launches": launches[name],
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "shape": row["shape"],
                **({"parts": row["parts"]} if "parts" in row else {}),
            }
            for name, row in ((n, kernel_rows[n]) for n in KERNEL_INFO)
        ],
        "launches_per_train_step": per_step,
        "end_of_run_launches": block,
        "checkpoint_laps_s": [p["ckpt"] for p in result.phase_seconds],
        "checkpoint_wait_s": result.checkpoint_wait_seconds,
        "checkpoint_ab": checkpoint_ab,
        "mesh_1x1": {"launches": mesh_counts, "steps": 2 * MESH_STEPS, **mesh_timing},
        "in_batch_softmax": ib_summary,
        "pod_2x4": pod_summary,
        "packed_moments": packed_summary,
        "tensor_parallel_1x1": tp_summary,
        "multi_step_4e": multi_summary,
        "mesh_multi_step_4f": mesh_multi_summary,
        "precision_bf16": precision_summary,
        "chunked_10m": chunked_summary,
        "cli_6b": cli_summary,
    }
    log(json.dumps(summary))
    log(smi)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
