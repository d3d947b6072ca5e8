"""The plain reference of a search cell: exact top-k by inner product in
float64, and the numbers that hold an answer to it. It imports nothing of
the program.

The queries are normalised as the served index normalises a cosine query
(numpy float32: each row over the larger of its norm and 1e-12). Under
bf16 scores the index stores its rows in bf16 and casts the queries to
bf16, so the reference rounds both the same way before it multiplies in
float64 (a product of two bf16 numbers is exact there).

Numbers (each over the compared answers):

- ``score_err``: the largest distance between a returned score and the
  float64 inner product of its query and the returned row;
- ``rank_gap``: the largest distance between the j-th best true score and
  the true score of the answer's j-th row, both lists sorted, so a wrong,
  missing or repeated row shows and a tie does not;
- ``bad_ids``: rows outside the catalogue, or returned twice for one query.
"""

from __future__ import annotations

import numpy as np
import torch

ITEM_CHUNK = 1 << 20
QUERY_BLOCK = 256


def normalize_queries(queries: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(queries, dtype=np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)


def _rounded(x: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    elif dtype == "float8":
        x = x.to(torch.float8_e4m3fn)
    return x.double()


def exact_topk(items: torch.Tensor, queries: np.ndarray, k: int, dtype: str):
    """``(true scores [B, k], ids [B, k])``, best first, in float64 over
    ``items`` (float32 ``[N, D]`` on the device)."""
    q = _rounded(torch.from_numpy(normalize_queries(queries)).to(items.device), dtype)
    best_s, best_i = [], []
    for qs in range(0, q.shape[0], QUERY_BLOCK):
        qb = q[qs : qs + QUERY_BLOCK]
        run_s = torch.full((qb.shape[0], 0), -np.inf, dtype=torch.float64, device=items.device)
        run_i = torch.zeros((qb.shape[0], 0), dtype=torch.int64, device=items.device)
        for start in range(0, items.shape[0], ITEM_CHUNK):
            chunk = _rounded(items[start : start + ITEM_CHUNK], dtype)
            s, i = torch.topk(qb @ chunk.T, min(k, chunk.shape[0]), dim=1)
            s, order = torch.topk(torch.cat([run_s, s], 1), min(k, run_s.shape[1] + s.shape[1]), dim=1)
            run_i = torch.gather(torch.cat([run_i, i + start], 1), 1, order)
            run_s = s
        best_s.append(run_s)
        best_i.append(run_i)
    return torch.cat(best_s), torch.cat(best_i)


def true_scores(items: torch.Tensor, queries: np.ndarray, ids: np.ndarray, dtype: str) -> torch.Tensor:
    """float64 inner products of each query with its answer's rows (ids
    outside the catalogue score -inf)."""
    q = _rounded(torch.from_numpy(normalize_queries(queries)).to(items.device), dtype)
    idx = torch.from_numpy(np.asarray(ids, np.int64)).to(items.device)
    inside = (idx >= 0) & (idx < items.shape[0])
    rows = _rounded(items[idx.clamp(0, items.shape[0] - 1)], dtype)
    out = torch.einsum("bd,bkd->bk", q, rows)
    return torch.where(inside, out, -np.inf)


def numbers(items: torch.Tensor, queries: np.ndarray, scores: np.ndarray, ids: np.ndarray,
            k: int, dtype: str) -> dict[str, float]:
    """The three numbers of one answered batch (see the module docstring)."""
    ids = np.asarray(ids, np.int64)
    bad = int(((ids < 0) | (ids >= items.shape[0])).sum())
    srt = np.sort(ids, axis=1)
    bad += int((srt[:, 1:] == srt[:, :-1]).sum())
    got = true_scores(items, queries, ids, dtype)
    want, _ = exact_topk(items, queries, k, dtype)
    score = torch.from_numpy(np.asarray(scores, np.float64)).to(got.device)
    finite = torch.isfinite(got)
    score_err = float(torch.where(finite, (score - got).abs(), np.inf).max())
    ranked, _ = torch.sort(got, dim=1, descending=True)
    rank_gap = float((want - ranked).abs().max())
    return {"score_err": score_err, "rank_gap": rank_gap, "bad_ids": float(bad)}


def control_search(items: torch.Tensor, queries: np.ndarray, k: int, dtype: str):
    """The reference in the program's place one precision below the
    configuration's: TF32 products for float32 scores, float8 (e4m3) rows
    and queries for bf16 scores. Returns ``(scores, ids)`` as numpy."""
    from .train_step import matmul_precision

    q = torch.from_numpy(normalize_queries(queries)).to(items.device)
    best_s, best_i = [], []
    with matmul_precision(dtype == "float32"):
        for qs in range(0, q.shape[0], QUERY_BLOCK):
            qb = q[qs : qs + QUERY_BLOCK]
            if dtype != "float32":
                qb = qb.to(torch.float8_e4m3fn).float()
            parts_s, parts_i = [], []
            for start in range(0, items.shape[0], ITEM_CHUNK):
                chunk = items[start : start + ITEM_CHUNK]
                if dtype != "float32":
                    chunk = chunk.to(torch.float8_e4m3fn).float()
                s, i = torch.topk(qb @ chunk.T, min(k, chunk.shape[0]), dim=1)
                parts_s.append(s)
                parts_i.append(i + start)
            s, order = torch.topk(torch.cat(parts_s, 1), k, dim=1)
            best_s.append(s)
            best_i.append(torch.gather(torch.cat(parts_i, 1), 1, order))
    return torch.cat(best_s).cpu().numpy(), torch.cat(best_i).cpu().numpy()
