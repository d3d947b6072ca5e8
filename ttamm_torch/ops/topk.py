"""Exact brute-force MIPS top-k over the item corpus (FAISS ``IndexFlatIP``
replacement), the port of ``ttamm_tpu/ops/topk.py``.

Three algorithms, each exact with respect to the scores it computes:

- ``group_exact``: one ``[qb, D] x [D, N]`` score slab per query block
  (``torch.matmul``), per-128-item group maxima, the top-k groups by maximum
  (which provably hold the top-k items), then the final top-k over those
  groups' scores. Float32 scoring is full float32 (TF32 is off, see
  ``ttamm_torch.device``); bfloat16 scoring keeps the slab in bf16. For a
  float32 slab with ``k <= 32`` the selection and the final top-k are one
  kernel, ``select_topk_from_groups``; otherwise the groups' rows are
  gathered and go through ``small_k_topk``.
- ``chunked``: the corpus in chunks of items (the last one narrower;
  nothing is copied), each chunk's ``[B, chunk]`` scores (``torch.matmul``;
  bf16 scores rounded to bf16, then widened), its top k by
  ``small_k_topk``, merged into the running top k by ``small_k_topk`` over
  ``[running, local]``. A chunk is as wide as ``SCORES_BYTES_BUDGET``
  allows for ``B`` float32 rows (:func:`chunk_items`), for corpora where
  even a 64-query slab exceeds the slab ceiling. Ties go to the lowest item
  id, as in the JAX package's scan (the running set holds the lower ids and
  comes first), so the answer does not depend on the chunk: the JAX
  package's chunk setting (``evaluation.faiss.batch_size``) has no
  counterpart.
- ``fused``: no slab. ``groupmax_matmul`` writes only the group maxima,
  ``rescore_groups`` re-scores the selected groups, and the final top-k
  runs over those candidates. Both kernels round their operands to bf16
  and sum in f32, in either score mode (the TPU kernels' semantics).

The group top-k goes through the ``small_k_topk`` kernel.

``mask_rows`` (int32 ``[B, M]``, padded with ids >= N) excludes items per
query, as the retrieval eval excludes each user's train positives:
``group_exact`` writes ``finfo(slab dtype).min`` at the blocked columns of
the slab before the group maxima, ``chunked`` the float32 minimum at the
blocked columns of each widened chunk (both by a scatter of the blocked
ids); ``fused`` selects ``M`` more groups and masks blocked candidates
after the rescore.

Routing (``algorithm="auto"``): float32 searches take ``group_exact`` at
every size up to the slab ceiling and ``chunked`` beyond it, because on the
card ``group_exact`` is full float32 while the fused kernels round to bf16.
bfloat16 searches take ``fused`` from ``BF16_FUSED_MIN_ITEMS`` items and
masks at most ``FUSED_MASK_WIDTH_MAX`` wide (and past the slab ceiling at
any mask width), and ``group_exact`` otherwise. (So the JAX eval's switch
of a float32 fused search to a bf16-stored corpus, a TPU bandwidth trick,
has no counterpart: float32 never routes to ``fused``.) ``fused``, chosen
or asked for, is rerouted where ``groupmax_matmul`` would refuse the shape
(``kernels.groupmax_matmul_fits``: D > 640, or rows beyond its TMA
coordinates), as the JAX package reroutes a fused search its kernels cannot
take, on every device alike: to ``group_exact`` within the slab ceiling,
to ``chunked`` past it. An explicit ``group_exact`` or ``chunked`` runs as
asked at any size.
"""

from __future__ import annotations

import torch

from . import kernels

NEG_INF = torch.finfo(torch.float32).min
GROUP = kernels.GROUP

# Query blocks of group_exact, and the chunks of 'chunked', are sized so one
# float32 score slab stays within this.
SCORES_BYTES_BUDGET = 1 << 30
# Slab ceiling of the auto chooser: group_exact stays eligible until even a
# 64-query float32 slab would exceed it (8,388,608 items). Beyond it the
# corpus is scanned in chunks ('chunked'), as in the JAX package.
SCORES_BYTES_CEILING = 2 << 30
# bfloat16 searches of at least this many items route to 'fused'. The
# current kernels' sweep (chip_smoke.py phases 6-7, NVIDIA H100 80GB HBM3 at
# a 700 W power limit, B=1024, k=20, D=128; device ms of fused vs
# group_exact; PERF.md) has fused ahead at every size it ran: 0.409 vs
# 0.466-0.468 at 99,880 items, 0.598 vs 1.953 at 500k, 0.810 vs 3.930 at 1M,
# 1.214 vs 8.176 at 2M. So the crossover lies below 100k items. This value
# was set against an earlier, slower group-max kernel; moving it waits for a
# sweep below 100k items.
BF16_FUSED_MIN_ITEMS = 500_000
SAFETY_GROUPS = 4  # extra groups selected by the fused path
# Widest per-query mask that auto routes to 'fused': each blocked id costs
# one more rescored group per query there. Also the eval plan's bucket width
# (ttamm_torch/evaluation/retrieval.py).
FUSED_MASK_WIDTH_MAX = 32


def _row_topk(
    x: torch.Tensor, k: int, *, plain: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of f32 rows (values, int64 positions)."""
    x = x.contiguous()
    fn = kernels.small_k_topk_plain if plain else kernels.small_k_topk
    vals, idx = fn(x, k)
    return vals, idx.long()


def _fit_rows(items: torch.Tensor, rows: int) -> torch.Tensor:
    """Slice or zero-pad ``items`` to exactly ``rows`` leading rows (a slice
    of a pre-padded corpus is a view; padding copies)."""
    if items.shape[0] == rows:
        return items
    if items.shape[0] > rows:
        return items[:rows]
    pad = items.new_zeros(rows - items.shape[0], items.shape[1])
    return torch.cat([items, pad])


def mips_topk(
    queries: torch.Tensor,
    item_embeddings: torch.Tensor,
    *,
    k: int,
    num_valid_rows: int | None = None,
    mask_rows: torch.Tensor | None = None,
    algorithm: str = "auto",
    score_dtype: str = "float32",
    chunk_size: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search.

    queries: float [B, D]; item_embeddings: [N, D] on the same device
    (pre-normalised for cosine). ``num_valid_rows`` treats only the first
    rows as items (the rest is padding, never returned), so a corpus padded
    once to a multiple of 128 is searched without a per-call copy.
    ``mask_rows``: optional int [B, M] item ids each query must not return
    (padded with ids >= N; ids outside the corpus are ignored). A blocked
    item scores the finite minimum of the slab dtype, so it comes back only
    when fewer than k items are left; the eval drops such entries by score.
    ``algorithm``: 'auto' | 'group_exact' | 'chunked' | 'fused' (see the
    module docstring). ``score_dtype``: 'float32' (exact, FAISS parity) or
    'bfloat16' (queries and items cast to bf16; normalise cosine queries
    before, as ``FlatIndex.search`` does, so the norms stay f32-accurate).
    ``chunk_size``: items a step of ``chunked`` scores (``None``:
    :func:`chunk_items`); the answer is the same at any chunk.

    Returns (scores f32 [B, k], indices int64 [B, k]), descending per row,
    ties as in the JAX package: ``group_exact`` and ``fused`` to the lower
    item id within a group and to the higher-ranked group across groups,
    ``chunked`` to the lower item id.
    """
    num_items = item_embeddings.shape[0] if num_valid_rows is None else num_valid_rows
    if not 0 < num_items <= item_embeddings.shape[0]:
        raise ValueError(
            f"num_valid_rows={num_items} for {item_embeddings.shape[0]} rows"
        )
    if score_dtype not in {"float32", "bfloat16"}:
        raise ValueError(f"Unknown mips_topk score_dtype: {score_dtype}")
    if algorithm not in {"auto", "group_exact", "chunked", "fused"}:
        raise ValueError(f"Unknown mips_topk algorithm: {algorithm}")
    if mask_rows is not None and (
        mask_rows.dim() != 2 or mask_rows.shape[0] != queries.shape[0]
        or mask_rows.dtype not in (torch.int32, torch.int64)
    ):
        raise ValueError(
            f"mask_rows must be int [{queries.shape[0]}, M], got "
            f"{mask_rows.dtype} {tuple(mask_rows.shape)}"
        )
    queries = queries.float()
    if score_dtype == "bfloat16":
        queries = queries.to(torch.bfloat16)
        item_embeddings = item_embeddings.to(torch.bfloat16)
    else:
        item_embeddings = item_embeddings.float()
    k_eff = min(k, num_items)

    fits = 64 * num_items * 4 <= SCORES_BYTES_CEILING
    requested = algorithm
    if algorithm == "auto":
        narrow = mask_rows is None or mask_rows.shape[1] <= FUSED_MASK_WIDTH_MAX
        big = (num_items >= BF16_FUSED_MIN_ITEMS and narrow) or not fits
        algorithm = "fused" if score_dtype == "bfloat16" and big else "group_exact"
    if algorithm == "fused" and not kernels.groupmax_matmul_fits(
        queries.shape[0], -(-num_items // GROUP) * GROUP, queries.shape[1]
    ):
        algorithm = "group_exact"  # a shape the fused kernels refuse
    if algorithm == "group_exact" != requested and not fits:
        algorithm = "chunked"  # past the slab ceiling
    if algorithm == "fused":
        return _fused_groupmax_topk(
            queries, item_embeddings, k_eff, num_items, mask_rows=mask_rows
        )
    if algorithm == "chunked":
        return _chunked_topk(
            queries, item_embeddings, k_eff, num_items, mask_rows=mask_rows,
            chunk_size=chunk_size,
        )
    return _group_exact_topk(queries, item_embeddings, k_eff, num_items, mask_rows=mask_rows)


def topk_with_mask(
    queries: torch.Tensor,
    item_embeddings: torch.Tensor,
    *,
    k: int,
    mask_rows: torch.Tensor,
    normalize_queries: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked float32 search, queries L2-normalised first when asked (the
    cosine mode; ``ttamm_tpu/ops/topk.py topk_with_mask``)."""
    if normalize_queries:  # x / max(||x||, 1e-12), as the JAX package
        queries = torch.nn.functional.normalize(queries.float(), dim=-1)
    return mips_topk(queries, item_embeddings, k=k, mask_rows=mask_rows)


def _fused_groupmax_topk(
    queries: torch.Tensor,
    item_embeddings: torch.Tensor,
    k_eff: int,
    num_items: int,
    *,
    mask_rows: torch.Tensor | None = None,
    safety_groups: int = SAFETY_GROUPS,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """No-slab exact top-k (``ttamm_tpu/ops/topk.py _fused_groupmax_topk``).

    Phase 1 writes per-group maxima only; phase 2 takes the top ``k_eff +
    M + safety_groups`` groups (maxima and re-scores come from differently
    ordered f32 sums and can disagree by ULPs — the safety groups keep the
    pruning bound robust; the bound itself needs only ``k_eff + M``: at most
    ``k_eff`` unblocked and ``M`` blocked items score at least the
    ``k_eff``-th best unblocked one); phase 3 re-scores exactly those
    groups; phase 4 is the final top-k, with the tail group's pad rows and
    the blocked items masked to ``NEG_INF``. ``plain`` runs the kernels'
    plain versions (to check the kernels on the card).
    """
    batch, dim = queries.shape
    ng = -(-num_items // GROUP)
    items = _fit_rows(item_embeddings, ng * GROUP).contiguous()
    queries = queries.contiguous()
    groupmax = kernels.groupmax_matmul_plain if plain else kernels.groupmax_matmul
    rescore = kernels.rescore_groups_plain if plain else kernels.rescore_groups

    gmax = groupmax(queries, items, num_items)  # [B, ng] f32
    mask_extra = 0 if mask_rows is None else mask_rows.shape[1]
    kg = min(k_eff + mask_extra + safety_groups, ng)
    _, gi = _row_topk(gmax, kg, plain=plain)
    cand = rescore(queries, items.view(ng, GROUP, dim), gi.to(torch.int32))
    lane = torch.arange(GROUP, device=gi.device)
    cand_ids = (gi[:, :, None] * GROUP + lane).reshape(batch, kg * GROUP)
    invalid = cand_ids >= num_items
    if mask_rows is not None:
        invalid |= (cand_ids[:, :, None] == mask_rows[:, None, :]).any(dim=-1)
    cand = cand.masked_fill_(invalid, NEG_INF)
    cv, ci = _row_topk(cand, k_eff, plain=plain)
    return cv, torch.gather(cand_ids, 1, ci)


def _mask_scatter(
    scores: torch.Tensor, mask_rows: torch.Tensor, first: int = 0
) -> torch.Tensor:
    """Write the finite minimum of the slab dtype at each row's blocked
    columns, in place (``ttamm_tpu/ops/topk.py _mask_scatter``): column
    ``j`` holds item ``first + j``, and ids outside the slab are dropped. A
    min-scatter, so a dropped id can aim at column 0 with +inf and change
    nothing, with no host sync and no race."""
    cols = mask_rows.long() - first
    inside = (cols >= 0) & (cols < scores.shape[1])
    src = torch.where(inside, torch.finfo(scores.dtype).min, torch.inf).to(scores.dtype)
    return scores.scatter_reduce_(1, torch.where(inside, cols, 0), src, reduce="amin")


def chunk_items(batch: int) -> int:
    """Items a chunk of the ``chunked`` scan scores for ``batch`` queries:
    the widest whose float32 scores fit ``SCORES_BYTES_BUDGET`` (262,144 at
    1,024 queries)."""
    return max(1, SCORES_BYTES_BUDGET // (4 * max(batch, 1)))


def _chunked_topk(
    queries: torch.Tensor,
    item_embeddings: torch.Tensor,
    k_eff: int,
    num_items: int,
    *,
    mask_rows: torch.Tensor | None = None,
    chunk_size: int | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk scan with a running top-k (the JAX ``mips_topk`` scan body).

    Per chunk of ``min(chunk_size, num_items)`` items (``chunk_size``
    ``None``: :func:`chunk_items` of the batch): the ``[B, chunk]``
    scores in the slab dtype, widened to f32; the blocked ids scattered to
    ``NEG_INF`` (the JAX package compares every chunk id with every blocked
    id, which sets the same entries); the chunk's top ``min(k_eff, chunk)``;
    then the top ``k_eff`` of ``[running, local]``. The running set starts
    as ``k_eff`` entries of ``NEG_INF`` at id 0 and always comes first, so
    ties go to the lower id, as in JAX. The JAX package zero-pads the corpus
    to whole chunks and scores the pad ids ``NEG_INF``; here the last chunk
    is narrower instead. The answer is the same: a local entry at
    ``NEG_INF`` can never displace one of the ``k_eff`` running entries.
    ``plain`` runs ``small_k_topk``'s plain version (to check the kernel on
    the card).
    """
    batch = queries.shape[0]
    if chunk_size is None:
        chunk_size = chunk_items(batch)
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    chunk = min(chunk_size, num_items)
    run_scores = torch.full((batch, k_eff), NEG_INF, dtype=torch.float32, device=queries.device)
    run_idx = torch.zeros((batch, k_eff), dtype=torch.int64, device=queries.device)
    for start in range(0, num_items, chunk):
        block = item_embeddings[start : min(start + chunk, num_items)]
        scores = (queries @ block.T).float()  # bf16 scores rounded, then widened
        if mask_rows is not None:
            _mask_scatter(scores, mask_rows, start)
        local_scores, local_pos = _row_topk(scores, min(k_eff, block.shape[0]), plain=plain)
        merged_scores = torch.cat([run_scores, local_scores], dim=1)
        merged_idx = torch.cat([run_idx, local_pos + start], dim=1)
        run_scores, pos = _row_topk(merged_scores, k_eff, plain=plain)
        run_idx = torch.gather(merged_idx, 1, pos)
    return run_scores, run_idx


def _group_exact_topk(
    queries: torch.Tensor,
    item_embeddings: torch.Tensor,
    k_eff: int,
    num_items: int,
    *,
    mask_rows: torch.Tensor | None = None,
    scores_bytes_budget: int = SCORES_BYTES_BUDGET,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-max-pruned exact top-k, blocked over queries
    (``ttamm_tpu/ops/topk.py _group_exact_topk``).

    Per query block: the [qb, NG*128] slab against the zero-padded corpus;
    the block's blocked columns set to ``finfo(slab dtype).min``; per-group
    maxima (the tail group's recomputed over its real columns, so zero pad
    scores cannot inflate an all-negative tail); the top-k groups by maximum
    — every top-k item's group has max >= s_k and at most k groups do; then
    the final top-k over those groups. A float32 slab with ``k_eff <= 32``
    does both in ``select_topk_from_groups`` (the JAX gate); otherwise the
    groups' rows are gathered, pad candidates masked to ``NEG_INF`` and
    ``small_k_topk`` takes the top k. Exact with respect to the computed
    scores, ties included.
    """
    batch = queries.shape[0]
    ng = -(-num_items // GROUP)
    padded_n = ng * GROUP
    items_t = _fit_rows(item_embeddings, padded_n).T
    k_groups = min(k_eff, ng)
    tail = padded_n != num_items
    lane = torch.arange(GROUP, device=queries.device)
    select = queries.dtype == torch.float32 and k_eff <= kernels.MAX_SELECT_GROUPS

    slab_bytes = padded_n * queries.element_size()
    qb = max(1, min(batch, scores_bytes_budget // slab_bytes))
    out_scores, out_idx = [], []
    for start in range(0, batch, qb):
        s = queries[start : start + qb] @ items_t  # [qb, padded_n], slab dtype
        if mask_rows is not None:
            _mask_scatter(s, mask_rows[start : start + qb])
        sg = s.view(s.shape[0], ng, GROUP)
        gmax = sg.amax(dim=-1)
        if tail:
            gmax[:, -1] = s[:, (ng - 1) * GROUP : num_items].amax(dim=-1)
        _, gi = _row_topk(gmax.float(), k_groups)
        if select:
            cv, ids = kernels.select_topk_from_groups(
                s, gi.to(torch.int32), k=k_eff, num_items=num_items
            )
            out_scores.append(cv)
            out_idx.append(ids.long())
            continue
        cand = torch.gather(sg, 1, gi[:, :, None].expand(-1, -1, GROUP)).float()
        if tail:
            ids = gi[:, :, None] * GROUP + lane
            cand = cand.masked_fill_(ids >= num_items, NEG_INF)
        cv, ci = _row_topk(cand.view(cand.shape[0], k_groups * GROUP), k_eff)
        group_of = torch.gather(gi, 1, ci // GROUP)
        out_scores.append(cv)
        out_idx.append(group_of * GROUP + ci % GROUP)
    return torch.cat(out_scores), torch.cat(out_idx)
