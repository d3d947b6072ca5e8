"""Metadata feature engineering: independent feature blocks + a composer.

Each feature family is built by its own block function returning a
:class:`FeatureBlock` (matrix column-slab + the metadata fields it
contributes); ``build_item_feature_matrix`` concatenates the slabs in the
fixed block order [category, author, numeric, text] and assembles
:class:`FeatureMetadata` from the block outputs. Host-side numpy/scipy
only — this feeds the device arrays, it never runs under jit.

Semantics are pinned by ``tests/test_features.py`` to exact parity with
the reference feature builders (``src/data/features.py:58-315``):

- category tokens are hierarchical prefixes of the " > "-joined path with
  the "Books" root dropped; a cell's value for a token of depth ``d``
  (`` > `` count) is ``1 / (d + 1)`` — 1.0 for mains, 0.5 one level down;
- author one-hot over the ``author_top_k`` most frequent, NaN -> Unknown;
- numerics coerced to float, NaN imputed with the column mean, z-scored
  (zero-std columns use std=1); title word/char counts likewise;
- user features pool interacted items' rows (mean / sum / max).

The reference builds these with per-row Python loops
(``features.py:155-180,300-315``); here the category/author slabs are
deduped index scatters and the user pooling is one sparse-incidence
matmul, so 2M-interaction preprocessing stays off the critical path.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import pandas as pd


def default_feature_config(config: dict | None) -> dict:
    cfg = dict(config) if config else {}
    cfg.setdefault("numeric_columns", ["average_rating", "price", "rating_number"])
    cfg.setdefault("category_top_k", 500)
    cfg.setdefault("author_top_k", 500)
    cfg.setdefault("user_aggregation", "mean")
    cfg.setdefault("text_features", {"title": True})
    return cfg


@dataclass(frozen=True)
class FeatureMetadata:
    """Describes the engineered feature space for reproducibility."""

    numeric_columns: list[str]
    numeric_mean: list[float]
    numeric_std: list[float]
    text_columns: list[str]
    text_mean: list[float]
    text_std: list[float]
    category_vocab: list[str]
    category_depths: list[int]
    author_vocab: list[str]
    feature_dim: int

    def feature_names(self) -> list[str]:
        """Feature names in item/user matrix column order."""
        names: list[str] = []
        names.extend(f"category:{cat}" for cat in self.category_vocab)
        names.extend(f"author:{author}" for author in self.author_vocab)
        names.extend(f"numeric:{col}" for col in self.numeric_columns)
        names.extend(f"text:{col}" for col in self.text_columns)
        return names


@dataclass
class FeatureBlock:
    """One feature family's column slab + its metadata contribution."""

    matrix: np.ndarray  # [num_items, width] float32
    meta: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Category block
# ---------------------------------------------------------------------------


def _cell_to_paths(cell) -> list[list[str]]:
    """A raw category cell -> list of token paths.

    CSV cells are usually stringified Python lists; also accepted: plain
    comma-separated strings, already-parsed (nested) lists, scalars.
    """
    if cell is None or (isinstance(cell, float) and pd.isna(cell)):
        return []
    if isinstance(cell, str):
        text = cell.strip()
        if not text:
            return []
        try:
            cell = ast.literal_eval(text)
        except (ValueError, SyntaxError):
            cell = text.split(",")
    if not isinstance(cell, list):
        token = str(cell).strip()
        return [[token]] if token else []

    def clean(seq) -> list[str]:
        return [s for s in (str(x).strip() for x in seq) if s]

    if cell and all(isinstance(x, (list, tuple)) for x in cell):
        return [p for p in (clean(x) for x in cell) if p]
    flat = clean(cell)
    return [flat] if flat else []


def parse_category_tokens(raw_value) -> list[str]:
    """Hierarchical root-stripped tokens for one cell, deduped in order.

    Every path contributes its " > "-joined prefixes after dropping the
    "Books" root: ``["Books", "History", "Classic"]`` ->
    ``["History", "History > Classic"]``.
    """
    out: dict[str, None] = {}  # insertion-ordered set
    for path in _cell_to_paths(raw_value):
        kept = [t for t in path if t.lower() != "books"]
        for depth in range(len(kept)):
            out.setdefault(" > ".join(kept[: depth + 1]))
    return list(out)


def category_block(cells: Sequence, *, top_k: int) -> FeatureBlock:
    """Depth-weighted multi-hot over the ``top_k`` most frequent tokens.

    A token's weight is a pure function of the token (``1/(depth+1)``), so
    duplicate (row, token) pairs are deduped and assigned directly — no
    max-combine pass needed.
    """
    token_lists = [parse_category_tokens(c) for c in cells]
    row_ids = np.fromiter(
        (r for r, toks in enumerate(token_lists) for _ in toks),
        dtype=np.int64,
        count=sum(len(t) for t in token_lists),
    )
    flat = [t for toks in token_lists for t in toks]

    meta = {"category_vocab": [], "category_depths": []}
    if not flat:
        return FeatureBlock(np.zeros((len(cells), 0), np.float32), meta)

    codes, uniques = pd.factorize(pd.Series(flat), sort=False)
    counts = np.bincount(codes, minlength=len(uniques))
    keep = np.argsort(-counts, kind="stable")[:top_k]  # most_common order
    vocab = [str(uniques[i]) for i in keep]
    col_of = np.full(len(uniques), -1, dtype=np.int64)
    col_of[keep] = np.arange(len(keep))

    cols = col_of[codes]
    hit = cols >= 0
    pair = row_ids[hit] * len(vocab) + cols[hit]
    pair = np.unique(pair)

    depths = np.asarray([t.count(" > ") for t in vocab], dtype=np.float32)
    matrix = np.zeros((len(cells) * len(vocab),), dtype=np.float32)
    matrix[pair] = (1.0 / (depths + 1.0))[pair % len(vocab)]
    meta["category_vocab"] = vocab
    meta["category_depths"] = [int(d) for d in depths]
    return FeatureBlock(matrix.reshape(len(cells), len(vocab)), meta)


# ---------------------------------------------------------------------------
# Author block
# ---------------------------------------------------------------------------


def author_block(cells: Sequence, *, top_k: int) -> FeatureBlock:
    """One-hot over the ``top_k`` most frequent authors (NaN -> Unknown)."""
    series = pd.Series(cells).fillna("Unknown").astype(str)
    codes, uniques = pd.factorize(series, sort=False)
    if len(uniques) == 0:
        return FeatureBlock(
            np.zeros((len(series), 0), np.float32), {"author_vocab": []}
        )
    counts = np.bincount(codes, minlength=len(uniques))
    keep = np.argsort(-counts, kind="stable")[:top_k]
    vocab = [str(uniques[i]) for i in keep]
    col_of = np.full(len(uniques), -1, dtype=np.int64)
    col_of[keep] = np.arange(len(keep))

    matrix = np.zeros((len(series), len(vocab)), dtype=np.float32)
    cols = col_of[codes]
    rows = np.nonzero(cols >= 0)[0]
    matrix[rows, cols[rows]] = 1.0
    return FeatureBlock(matrix, {"author_vocab": vocab})


# ---------------------------------------------------------------------------
# Numeric + text blocks (shared standardiser)
# ---------------------------------------------------------------------------


def _standardise(matrix: np.ndarray) -> tuple[np.ndarray, list[float], list[float]]:
    """NaN-aware z-score: impute with the column mean; zero stds become 1."""
    mean = np.nanmean(matrix, axis=0)
    std = np.where(np.nanstd(matrix, axis=0) == 0, 1.0, np.nanstd(matrix, axis=0))
    filled = np.where(np.isnan(matrix), mean, matrix)
    z = ((filled - mean) / std).astype(np.float32)
    return z, [float(m) for m in mean], [float(s) for s in std]


def numeric_block(books: pd.DataFrame, columns: Sequence[str]) -> FeatureBlock:
    present = [c for c in columns if c in books]
    if not present:
        return FeatureBlock(
            np.zeros((len(books), 0), np.float32),
            {"numeric_columns": [], "numeric_mean": [], "numeric_std": []},
        )
    raw = books[present].apply(pd.to_numeric, errors="coerce")
    z, mean, std = _standardise(raw.to_numpy(dtype=np.float32, copy=True))
    return FeatureBlock(
        z,
        {"numeric_columns": present, "numeric_mean": mean, "numeric_std": std},
    )


def text_block(titles: Iterable[str]) -> FeatureBlock:
    """Z-scored title word/char counts."""
    text = pd.Series(list(titles))
    text = text.where(~text.isna(), "").astype(str)
    stacked = np.stack(
        [
            text.str.split().str.len().to_numpy(dtype=np.float32),
            text.str.len().to_numpy(dtype=np.float32),
        ],
        axis=1,
    )
    z, mean, std = _standardise(stacked)
    return FeatureBlock(
        z,
        {
            "text_columns": ["title_word_count", "title_char_count"],
            "text_mean": mean,
            "text_std": std,
        },
    )


# ---------------------------------------------------------------------------
# Composer
# ---------------------------------------------------------------------------


def build_item_feature_matrix(
    books: pd.DataFrame,
    feature_config: dict | None = None,
) -> tuple[np.ndarray, FeatureMetadata]:
    """Build the (num_items, feature_dim) float32 item feature matrix."""
    cfg = default_feature_config(feature_config)
    n = len(books)

    def col(name, default):
        return books[name] if name in books else pd.Series([default] * n)

    blocks = [
        category_block(
            col("categories", []).tolist(),
            top_k=int(cfg.get("category_top_k", 500)),
        ),
        author_block(
            col("author", "Unknown").tolist(),
            top_k=int(cfg.get("author_top_k", 500)),
        ),
        numeric_block(books, cfg.get("numeric_columns", [])),
        text_block(col("title", "")),
    ]

    slabs = [b.matrix for b in blocks if b.matrix.shape[1] > 0]
    features = (
        np.concatenate(slabs, axis=1).astype(np.float32, copy=False)
        if slabs
        else np.zeros((n, 0), dtype=np.float32)
    )
    merged: dict = {}
    for b in blocks:
        merged.update(b.meta)
    metadata = FeatureMetadata(feature_dim=int(features.shape[1]), **merged)
    return features, metadata


def build_user_feature_matrix(
    interactions: pd.DataFrame,
    item_features: np.ndarray,
    *,
    num_users: int,
    aggregation: str = "mean",
) -> np.ndarray:
    """Pool interacted items' feature rows into per-user features.

    mean/sum run as ONE sparse user-x-item incidence matmul (BLAS-speed;
    the reference loops users, ``features.py:300-315``, and ``np.add.at``
    is ~1000x slower at 2M interactions); max is a scatter-max.
    """
    if item_features.size == 0:
        return np.zeros((num_users, 0), dtype=np.float32)

    agg = aggregation.lower()
    if agg not in {"mean", "sum", "max"}:
        raise ValueError("aggregation must be one of {'mean', 'sum', 'max'}")

    dim = item_features.shape[1]
    user_features = np.zeros((num_users, dim), dtype=np.float32)
    if interactions.empty:
        return user_features

    user_idx = interactions["user_idx"].to_numpy(dtype=np.int64)
    item_idx = interactions["item_idx"].to_numpy(dtype=np.int64)

    if agg in {"mean", "sum"}:
        from scipy import sparse

        incidence = sparse.csr_matrix(
            (
                np.ones(len(user_idx), dtype=np.float32),
                (user_idx, item_idx),
            ),
            shape=(num_users, item_features.shape[0]),
        )
        pooled = incidence @ item_features
        if agg == "mean":
            counts = np.asarray(incidence.sum(axis=1)).reshape(-1)
            nonzero = counts > 0
            pooled[nonzero] /= counts[nonzero, None]
        user_features = np.asarray(pooled, dtype=np.float32)
    else:  # max
        rows = item_features[item_idx]
        pooled = np.full((num_users, dim), -np.inf, dtype=np.float32)
        np.maximum.at(pooled, user_idx, rows)
        touched = np.zeros((num_users,), dtype=bool)
        touched[user_idx] = True
        user_features[touched] = pooled[touched]

    return user_features
