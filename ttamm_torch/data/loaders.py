"""Host-side CSV ingestion.

Spec-driven design: each corpus table is described by a ``TableSpec``
(default filename, trimmed-sample fallback, column dtypes) and loaded by
one generic routine. Behavioral parity with the reference loaders
(``src/data/loaders.py:24-118``):

- books default to ``books.csv``, interactions to ``users.csv``;
- when the default file is missing and no explicit filename was given,
  fall back to the bundled 10-row ``*_trimmed.csv`` samples;
- interactions carry stable ``string``/``Int64`` dtypes for
  ``parent_asin`` / ``userId`` / ``timestamp``;
- ``nrows`` limits apply at read time;
- ``load_dataset`` drops interactions referencing ASINs absent from the
  books frame (vectorized isin, not a Python set).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import pandas as pd

from ..utils.logging import get_logger

logger = get_logger("data")


@dataclass(frozen=True)
class TableSpec:
    """How to locate and type one corpus table on disk."""

    default_filename: str
    sample_filename: str
    dtypes: dict[str, str] | None = None


BOOKS_SPEC = TableSpec("books.csv", "books_trimmed.csv")
INTERACTIONS_SPEC = TableSpec(
    "users.csv",
    "users_trimmed.csv",
    dtypes={"parent_asin": "string", "userId": "string", "timestamp": "Int64"},
)

# Back-compat aliases (older call sites / tests import the constants).
DEFAULT_BOOKS_FILENAME = BOOKS_SPEC.default_filename
DEFAULT_INTERACTIONS_FILENAME = INTERACTIONS_SPEC.default_filename
SAMPLE_BOOKS_FILENAME = BOOKS_SPEC.sample_filename
SAMPLE_INTERACTIONS_FILENAME = INTERACTIONS_SPEC.sample_filename


@dataclass(frozen=True)
class DatasetArtifacts:
    """Raw frames as loaded from disk."""

    books: pd.DataFrame
    interactions: pd.DataFrame


def _load_table(
    spec: TableSpec,
    data_dir: Path | str,
    filename: str | None,
    limit: int | None,
) -> pd.DataFrame:
    """Resolve ``spec`` under ``data_dir`` and read it.

    An explicitly requested ``filename`` must exist; only the *default*
    location may silently degrade to the trimmed sample (the reference's
    graceful-fallback rule).
    """
    data_dir = Path(data_dir)
    candidates = [data_dir / (filename or spec.default_filename)]
    if filename is None:
        candidates.append(data_dir / spec.sample_filename)

    for i, path in enumerate(candidates):
        if not path.exists():
            continue
        if i > 0:
            logger.warning("Falling back to %s", path.name)
        return pd.read_csv(path, dtype=spec.dtypes, nrows=limit)
    raise FileNotFoundError(
        f"Expected CSV at {candidates[0]} but file was not found."
    )


def load_books(
    data_dir: Path | str,
    *,
    filename: str | None = None,
    limit: int | None = None,
) -> pd.DataFrame:
    """Books metadata frame (title/author/rating/price/categories/ASIN)."""
    return _load_table(BOOKS_SPEC, data_dir, filename, limit)


def load_interactions(
    data_dir: Path | str,
    *,
    filename: str | None = None,
    limit: int | None = None,
) -> pd.DataFrame:
    """User-item interaction frame with pinned dtypes."""
    return _load_table(INTERACTIONS_SPEC, data_dir, filename, limit)


def _restrict_to_known_items(
    interactions: pd.DataFrame, books: pd.DataFrame
) -> pd.DataFrame:
    """Drop interaction rows whose ASIN is not in the books frame."""
    known = interactions["parent_asin"].astype(str).isin(
        books["parent_asin"].astype(str).unique()
    )
    if known.all():
        return interactions
    logger.info(
        "Filtered %d interaction rows referencing ASINs outside the books"
        " subset.",
        int((~known).sum()),
    )
    return interactions[known].reset_index(drop=True)


def load_dataset(
    data_dir: Path | str,
    *,
    books_file: str | None = None,
    interactions_file: str | None = None,
    books_limit: int | None = None,
    interactions_limit: int | None = None,
) -> DatasetArtifacts:
    """Load both frames; interactions are restricted to the books subset."""
    books = load_books(data_dir, filename=books_file, limit=books_limit)
    interactions = load_interactions(
        data_dir, filename=interactions_file, limit=interactions_limit
    )
    if not books.empty and {"parent_asin"} <= set(books) & set(interactions):
        interactions = _restrict_to_known_items(interactions, books)
    return DatasetArtifacts(books=books, interactions=interactions)
