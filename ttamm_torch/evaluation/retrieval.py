"""Batched retrieval evaluation on the card: the masked MIPS path and the
sampled path (port of ``ttamm_tpu/evaluation/retrieval.py``).

- **MIPS path** (default): encode the whole item corpus, batch the eval
  users, run the exact top-k with each user's train positives masked out
  (``mips_topk(mask_rows=...)``), then apply the reference's
  post-processing: the non-blocked candidates, cut to ``max_k + |GT|`` (its
  ``search_limit``), every missed ground-truth item appended, cut to
  ``max_k`` (the "GT-append quirk", ref ``training.py:944-972``).
  :func:`evaluate_retrieval_metrics` does that post-processing on the
  device as position arithmetic and reads back one hit matrix per bucket;
  :func:`evaluate_retrieval` returns the per-user prediction lists.
- **Sampled path** (``use_mips=False``): candidates = GT plus
  ``candidate_samples`` items drawn by ``numpy.random.Generator.choice``
  outside the user's train positives, scored by a gather and row dots (ref
  ``:974-1009``). The draws are the JAX package's, so both packages score
  the same candidates.

Masking instead of filtering: the reference searches ``search_limit +
|blocked|`` deep and skips blocked items; a blocked item scores the slab's
finite minimum here, which gives the same candidate sequence at a search
depth of ``max_k + gt_cap``. Under cosine both sides are normalised as
``x / max(||x||, 1e-12)``.

Under a mesh whose model axis is > 1 (``mesh``), the state holds this
rank's row shard of every table: the corpus is encoded shard by shard, the
users through the sharded row lookups, and each batch is searched by the
sharded top-k (``ttamm_torch/parallel/step.py``); every rank computes the
same metrics. A data-only mesh holds whole tables and takes the plain local
search. The JAX eval's switch of a float32 ``fused`` search to a
bf16-stored corpus is not carried: the port never routes float32 to
``fused`` (``ttamm_torch/ops/topk.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F

from ..data import pack_positives, positives_from_frame
from ..device import resolve_device
from ..models.two_tower import TwoTower
from ..ops import kernels
from ..ops.topk import FUSED_MASK_WIDTH_MAX, NEG_INF, mips_topk
from ..train.state import BatchData
from ..train.step import encode_corpus
from ..utils.logging import get_logger
from .metrics import RankingMetrics, metrics_from_hit_matrix

logger = get_logger("evaluation")

_VALID_THRESHOLD = NEG_INF / 2


def _pad_rows(values: list[list[int]], width: int, fill: int) -> np.ndarray:
    out = np.full((len(values), width), fill, dtype=np.int32)
    for i, row in enumerate(values):
        row = row[:width]
        out[i, : len(row)] = row
    return out


def _model_device(model: TwoTower) -> torch.device:
    return model.user_tower.id_embedding.weight.device


def model_mesh(mesh):
    """``mesh`` when its model axis shards the tables, else None."""
    if mesh is None:
        return None
    from ..parallel.mesh import MODEL_AXIS, axis_size

    return mesh if axis_size(mesh, MODEL_AXIS) > 1 else None


@torch.no_grad()
def side_rows(
    model: TwoTower, data: BatchData, side: str, idx: torch.Tensor, mesh=None
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """``(ID rows, feature rows, mimic rows)`` of the ``side`` rows at int32
    ids ``idx`` (None for absent features or mimic tables). The tables are
    read by ``gather_rows``; under ``mesh`` (row-sharded tables, see the
    module docstring) by its zero-filling masked form, summed over
    ``model``."""
    tower = model.tower(side)
    features = data.user_features if side == "user" else data.item_features
    aug = None if model.mimic is None else model.mimic.table(side).weight
    if mesh is None:
        feats = None if features is None else torch.index_select(features, 0, idx)
        rows = [None if t is None else kernels.gather_rows(t, idx)
                for t in (tower.id_embedding.weight, aug)]
    else:
        from ..parallel.embedding_lookup import sharded_rows, sharded_table_rows

        feats = sharded_rows(features, idx, mesh)
        rows = [None if t is None else sharded_table_rows(t, idx, mesh)
                for t in (tower.id_embedding.weight, aug)]
    return rows[0], feats, rows[1]


@torch.no_grad()
def encode_rows(
    model: TwoTower, data: BatchData, side: str, idx: torch.Tensor, mesh=None
) -> torch.Tensor:
    """Tower + mimic augmentation of the ``side`` rows at int32 ids ``idx``,
    without dropout (rows read by :func:`side_rows`)."""
    id_rows, feats, aug = side_rows(model, data, side, idx, mesh)
    emb = model.tower(side).forward_rows(id_rows, feats)
    return emb if aug is None else emb + aug


def encode_user_batch(
    model: TwoTower, data: BatchData, user_idx: torch.Tensor, mesh=None
) -> torch.Tensor:
    """:func:`encode_rows` of a batch of users."""
    return encode_rows(model, data, "user", user_idx, mesh)


def _corpus(
    model: TwoTower, data: BatchData, item_embeddings: torch.Tensor | None, mesh=None
) -> torch.Tensor:
    """The item corpus to search (under ``mesh``, this shard's rows):
    encoded when not given, unit rows under cosine."""
    if item_embeddings is None:
        rows = None if mesh is None else model.item_tower.id_embedding.weight.shape[0]
        item_embeddings = encode_corpus(model, "item", data.item_features, num_rows=rows)
    if model.cfg.similarity == "cosine":
        item_embeddings = F.normalize(item_embeddings, dim=-1)
    return item_embeddings


def full_corpus(model: TwoTower, rows: torch.Tensor, mesh=None, side: str = "item") -> torch.Tensor:
    """The whole ``[num_items, D]`` corpus (``[num_users, D]`` for
    ``side="user"``) from this shard's rows (gathered over ``model``), or
    ``rows`` itself without a mesh."""
    if mesh is None:
        return rows
    from ..parallel.mesh import MODEL_AXIS, all_gather_rows

    count = model.num_items if side == "item" else model.num_users
    return all_gather_rows(rows, mesh, MODEL_AXIS)[:count]


def _search(
    model: TwoTower,
    data: BatchData,
    items: torch.Tensor,
    user_idx: torch.Tensor,
    mask_rows: torch.Tensor,
    *,
    deep_k: int,
    score_dtype: str = "float32",
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode a user batch and search ``items`` with ``mask_rows`` (one row
    of blocked item ids per user) masked."""
    queries = encode_user_batch(model, data, user_idx, mesh)
    if model.cfg.similarity == "cosine":
        queries = F.normalize(queries, dim=-1)
    if mesh is not None:
        from ..parallel.step import sharded_mips_topk

        return sharded_mips_topk(
            queries, items, k=deep_k, mesh=mesh, num_valid_rows=model.num_items,
            mask_rows=mask_rows, score_dtype=score_dtype,
        )
    return mips_topk(queries, items, k=deep_k, mask_rows=mask_rows, score_dtype=score_dtype)


def _search_plan_batch(
    model: TwoTower, data: BatchData, items: torch.Tensor, plan: EvalPlan, batch: int,
    score_dtype: str = "float32", mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    u_idx = plan.user_mat[batch]
    return _search(
        model, data, items, u_idx, torch.index_select(plan.blocked_rows, 0, u_idx),
        deep_k=plan.deep_k, score_dtype=score_dtype, mesh=mesh,
    )


@dataclass(frozen=True)
class EvalPlan:
    """The per-epoch-invariant inputs of the MIPS eval, on the device.

    Built once per run (:func:`build_eval_plan`) and used every epoch. When
    the packed blocked matrix is wider than ``FUSED_MASK_WIDTH_MAX``, the
    plan is bucketed by each user's blocked count: this plan holds the users
    whose train-positive count fits that width (their mask rows sliced to
    it), and ``wide`` a sub-plan for the heavy tail at full width. The
    buckets keep the narrow majority's masks narrow, as in the JAX package,
    whose fused search takes masks up to that width.
    """

    batches: tuple[tuple[int, ...], ...]  # eval users, one tuple per batch
    gt_per_user: dict[int, set[int]]
    user_mat: torch.Tensor  # int32 [nb, bs]; a short last batch repeats its last user
    blocked_rows: torch.Tensor  # int32 [num_users, W] train positives, fill >= N
    deep_k: int
    num_items: int
    gt_mat: torch.Tensor  # int32 [nb, bs, gt_cap] ground truth, -1 padded
    gt_sizes: np.ndarray  # int32 [nb, bs] |GT| per (padded) user row
    wide: "EvalPlan | None" = None  # heavy-tail bucket (full mask width)


def _plan_buckets(plan: EvalPlan) -> list[EvalPlan]:
    return [plan] + ([plan.wide] if plan.wide is not None else [])


def _plan_for_users(
    users: list[int],
    gt_per_user: dict[int, set[int]],
    blocked_rows: torch.Tensor,
    *,
    num_items: int,
    k_values: Iterable[int],
    user_batch_size: int,
    wide: EvalPlan | None = None,
) -> EvalPlan:
    max_k = max(k_values)
    gt_cap = max(len(gt_per_user[u]) for u in users)
    n = len(users)
    bs = min(user_batch_size, n)
    nb = -(-n // bs)
    user_arr = np.asarray(users, np.int32)
    padded = np.concatenate([user_arr, np.full(nb * bs - n, user_arr[-1], np.int32)])
    gt_rows = _pad_rows([sorted(gt_per_user[int(u)]) for u in padded], gt_cap, -1)
    gt_sizes = np.asarray([len(gt_per_user[int(u)]) for u in padded], np.int32).reshape(nb, bs)
    dev = blocked_rows.device
    return EvalPlan(
        batches=tuple(tuple(users[start : start + bs]) for start in range(0, n, bs)),
        gt_per_user=gt_per_user,
        user_mat=torch.from_numpy(padded.reshape(nb, bs)).to(dev),
        blocked_rows=blocked_rows,
        deep_k=min(max_k + gt_cap, num_items),
        num_items=num_items,
        gt_mat=torch.from_numpy(gt_rows.reshape(nb, bs, gt_cap)).to(dev),
        gt_sizes=gt_sizes,
        wide=wide,
    )


def build_eval_plan(
    val_interactions: pd.DataFrame,
    train_positive_map: Mapping[int, set[int]],
    *,
    num_users: int,
    num_items: int,
    k_values: Iterable[int],
    user_batch_size: int = 1024,
    blocked_rows: torch.Tensor | None = None,
    device: torch.device | str | None = None,
) -> EvalPlan | None:
    """The eval inputs of one split (see :class:`EvalPlan`), or None when it
    has no users with ground truth.

    ``blocked_rows`` lets callers share one packed train-positives matrix,
    already on the device, between several plans (the trainer's val and
    test plans). It must cover every eval user's whole train-positive list:
    a matrix packed with a ``positives_cap`` that cut an eval user's list is
    rebuilt uncapped here (with a warning), since a cut row would let the
    eval recommend that user's own train positives and inflate recall.
    Without it the matrix is packed here and moved to ``device`` (``None``:
    the CUDA card).
    """
    if val_interactions.empty:
        return None
    gt_per_user = positives_from_frame(val_interactions)
    users = [u for u, gt in gt_per_user.items() if gt]
    if not users:
        return None
    dev = blocked_rows.device if blocked_rows is not None else resolve_device(device)
    counts = {u: len(train_positive_map.get(u, ())) for u in users}
    max_blocked = max(counts.values(), default=0)
    if blocked_rows is not None and blocked_rows.shape[1] < max_blocked:
        logger.warning(
            "eval blocked matrix width %d < max eval-user positive count %d "
            "(built with a positives_cap?); rebuilding uncapped — truncated "
            "blocked rows would leak train positives into eval predictions.",
            blocked_rows.shape[1],
            max_blocked,
        )
        blocked_rows = None
    if blocked_rows is None:
        packed = pack_positives(train_positive_map, num_users=num_users, num_items=num_items)
        blocked_rows = torch.from_numpy(packed.rows).to(dev)
    kwargs = dict(num_items=num_items, k_values=k_values, user_batch_size=user_batch_size)
    if blocked_rows.shape[1] > FUSED_MASK_WIDTH_MAX:
        narrow = [u for u in users if counts[u] <= FUSED_MASK_WIDTH_MAX]
        wide = [u for u in users if counts[u] > FUSED_MASK_WIDTH_MAX]
        if narrow:
            logger.info(
                "eval plan: blocked width %d exceeds %d; bucketing %d narrow / %d wide users.",
                blocked_rows.shape[1], FUSED_MASK_WIDTH_MAX, len(narrow), len(wide),
            )
            wide_plan = (
                _plan_for_users(wide, gt_per_user, blocked_rows, **kwargs) if wide else None
            )
            return _plan_for_users(
                narrow, gt_per_user, blocked_rows[:, :FUSED_MASK_WIDTH_MAX].contiguous(),
                wide=wide_plan, **kwargs,
            )
    return _plan_for_users(users, gt_per_user, blocked_rows, **kwargs)


def batch_hits(
    model: TwoTower,
    data: BatchData,
    items: torch.Tensor,
    plan: EvalPlan,
    batch: int,
    *,
    max_k: int,
    score_dtype: str = "float32",
    mesh=None,
) -> torch.Tensor:
    """The hit matrix bool ``[bs, max_k]`` of user batch ``batch`` of one
    bucket ``plan``, on the device (``items`` as :func:`_corpus` returns
    it). The reference's post-processing as position arithmetic:

    - blocked and pad entries score below ``_VALID_THRESHOLD`` and the top-k
      orders the ``nvalid`` real candidates first, so the filter is a prefix;
    - the cut keeps the first ``limit = min(max_k + |GT|, nvalid)`` entries;
    - appended missed GT items are hits by construction, at positions
      ``limit .. limit + missing - 1`` whichever item lands where.
    """
    gt_b = plan.gt_mat[batch]
    scores, idx = _search_plan_batch(model, data, items, plan, batch, score_dtype, model_mesh(mesh))
    deep_k = plan.deep_k
    valid = scores > _VALID_THRESHOLD  # [bs, deep_k]
    nvalid = valid.sum(dim=-1)
    gt_size = (gt_b >= 0).sum(dim=-1)
    limit = torch.minimum(max_k + gt_size, nvalid)  # [bs]
    jpos = torch.arange(deep_k, device=idx.device)
    pre = (idx[:, :, None] == gt_b[:, None, :]) & (
        jpos[None, :, None] < limit[:, None, None]
    )  # [bs, deep_k, gt_cap]
    missing = gt_size - pre.any(dim=1).sum(dim=-1)
    w = min(deep_k, max_k)
    direct = F.pad(pre.any(dim=-1)[:, :w], (0, max_k - w))
    kpos = torch.arange(max_k, device=idx.device)[None, :]
    appended = (kpos >= limit[:, None]) & (kpos < (limit + missing)[:, None])
    return direct | appended


def evaluate_retrieval_metrics(
    model: TwoTower,
    data: BatchData,
    *,
    plan: EvalPlan,
    k_values: Iterable[int],
    item_embeddings: torch.Tensor | None = None,
    score_dtype: str = "float32",
    mesh=None,
) -> RankingMetrics:
    """The MIPS eval straight to :class:`RankingMetrics`: one hit matrix per
    bucket on the device, one read back per bucket, the pad rows of each
    short last batch dropped before the metrics.

    ``item_embeddings``: the encoded corpus (encoded here when None).
    ``score_dtype="bfloat16"`` scores in bf16, the serving mode, for the
    trainer's serving-precision gate; the reported metrics use float32.
    Metric-identical to ``compute_ranking_metrics(*evaluate_retrieval(...))``.
    ``mesh``: see the module docstring (``item_embeddings`` is then this
    shard's rows).
    """
    mesh = model_mesh(mesh)
    k_list = list(k_values)
    max_k = max(k_list)
    items = _corpus(model, data, item_embeddings, mesh)
    rows: list[np.ndarray] = []
    sizes: list[np.ndarray] = []
    for bucket in _plan_buckets(plan):
        hits = torch.stack([
            batch_hits(
                model, data, items, bucket, b, max_k=max_k, score_dtype=score_dtype, mesh=mesh
            )
            for b in range(len(bucket.batches))
        ]).cpu().numpy()  # [nb, bs, max_k]
        for b, chunk_users in enumerate(bucket.batches):
            rows.append(hits[b, : len(chunk_users)])
            sizes.append(bucket.gt_sizes[b, : len(chunk_users)])
    return metrics_from_hit_matrix(np.concatenate(rows), np.concatenate(sizes), k_list)


def _postprocess_mips_rows(
    predictions: dict[int, list[int]],
    chunk_users: Iterable[int],
    idx_np: np.ndarray,
    valid_np: np.ndarray,
    gt_per_user: Mapping[int, set[int]],
    max_k: int,
) -> None:
    """Reference post-processing: filter -> cap -> GT-append -> truncate
    (ref ``training.py:944-972``)."""
    for row, user in enumerate(chunk_users):
        gt = gt_per_user[user]
        filtered = [int(i) for i in idx_np[row][valid_np[row]]]
        search_limit = max(max_k + len(gt), 1)
        filtered = filtered[:search_limit]
        seen = set(filtered)
        for item in gt:  # GT-append quirk (ref :969-972)
            if item not in seen:
                filtered.append(item)
        predictions[user] = filtered[:max_k]


def evaluate_retrieval(
    model: TwoTower,
    data: BatchData,
    *,
    val_interactions: pd.DataFrame,
    train_positive_map: Mapping[int, set[int]],
    num_items: int,
    k_values: Iterable[int],
    use_mips: bool = True,
    candidate_samples: int = 50,
    rng: np.random.Generator | None = None,
    user_batch_size: int = 1024,
    item_embeddings: torch.Tensor | None = None,
    plan: EvalPlan | None = None,
    mesh=None,
) -> tuple[dict[int, list[int]], dict[int, set[int]]]:
    """Per-user top-``max_k`` predictions and ground truth, for
    ``compute_ranking_metrics``. With ``plan`` the MIPS path searches the
    plan's buckets; without it, the users of ``val_interactions`` in batches
    of ``user_batch_size``, each batch's mask as wide as its widest user.
    ``mesh``: see the module docstring (``item_embeddings`` is then this
    shard's rows)."""
    mesh = model_mesh(mesh)
    k_list = list(k_values)
    max_k = max(k_list) if k_list else 0
    dev = _model_device(model)

    if plan is not None and use_mips:
        items = _corpus(model, data, item_embeddings, mesh)
        predictions: dict[int, list[int]] = {}
        plan_users: list[int] = []
        for bucket in _plan_buckets(plan):
            found = [
                _search_plan_batch(model, data, items, bucket, b, mesh=mesh)
                for b in range(len(bucket.batches))
            ]
            for (scores, idx), chunk_users in zip(found, bucket.batches):
                _postprocess_mips_rows(
                    predictions, chunk_users, idx.cpu().numpy(),
                    (scores > _VALID_THRESHOLD).cpu().numpy(), plan.gt_per_user, max_k,
                )
            plan_users.extend(u for batch in bucket.batches for u in batch)
        return predictions, {u: plan.gt_per_user[u] for u in plan_users}

    if val_interactions.empty:
        return {}, {}
    # Ground truth per user, in ascending user order (the reference's
    # groupby order).
    gt_per_user = positives_from_frame(val_interactions)
    users = [u for u, gt in gt_per_user.items() if gt]
    if not users:
        return {}, {}
    gt_cap = max(len(gt_per_user[u]) for u in users)
    items = _corpus(model, data, item_embeddings, mesh)
    predictions = {}

    if use_mips:
        deep_k = min(max_k + gt_cap, num_items)
        blocked_lists = [sorted(train_positive_map.get(u, ())) for u in users]
        found = []
        for start in range(0, len(users), user_batch_size):
            batch_blocked = blocked_lists[start : start + user_batch_size]
            width = max(1, max(len(b) for b in batch_blocked))
            mask = torch.from_numpy(_pad_rows(batch_blocked, width, num_items)).to(dev)
            u_idx = torch.tensor(users[start : start + user_batch_size], dtype=torch.int32, device=dev)
            found.append(_search(model, data, items, u_idx, mask, deep_k=deep_k, mesh=mesh))
        for i, (scores, idx) in enumerate(found):
            _postprocess_mips_rows(
                predictions, users[i * user_batch_size : (i + 1) * user_batch_size],
                idx.cpu().numpy(), (scores > _VALID_THRESHOLD).cpu().numpy(),
                gt_per_user, max_k,
            )
        return predictions, {u: gt_per_user[u] for u in users}

    rng = rng or np.random.default_rng(0)
    items = full_corpus(model, items, mesh)
    cand_rows: list[list[int]] = []
    for user in users:
        gt = gt_per_user[user]
        blocked = set(train_positive_map.get(user, ()))
        candidates = set(gt)
        available = list(set(range(num_items)) - blocked)
        if available:
            budget = max(0, min(candidate_samples, len(available)))
            if budget > 0:
                sampled = rng.choice(available, size=budget, replace=False)
                candidates.update(int(s) for s in sampled)
        cand_rows.append(list(candidates))
    cand_cap = max(len(c) for c in cand_rows)
    cand_mat = _pad_rows(cand_rows, cand_cap, 0)
    pad_mask = np.zeros(cand_mat.shape, dtype=bool)
    for i, c in enumerate(cand_rows):
        pad_mask[i, len(c):] = True
    cosine = model.cfg.similarity == "cosine"
    for start in range(0, len(users), user_batch_size):
        chunk_users = users[start : start + user_batch_size]
        u_idx = torch.tensor(chunk_users, dtype=torch.int32, device=dev)
        queries = encode_user_batch(model, data, u_idx, mesh)
        if cosine:
            queries = F.normalize(queries, dim=-1)
        cands = torch.from_numpy(cand_mat[start : start + len(chunk_users)]).to(dev)
        scores_np = torch.einsum("bd,bcd->bc", queries, items[cands.long()]).cpu().numpy()
        scores_np[pad_mask[start : start + len(chunk_users)]] = -np.inf
        order = np.argsort(-scores_np, axis=1)
        for row, user in enumerate(chunk_users):
            n_cand = len(cand_rows[start + row])
            top = order[row][: min(max_k, n_cand)]
            predictions[user] = [int(cand_mat[start + row, t]) for t in top]
    return predictions, {u: gt_per_user[u] for u in users}
