"""The prepared-dataset cache (the port's own copy of
``ttamm_tpu/data/cache.py``): ``data.use_cache: true`` keeps a pickle of the
:class:`~ttamm_torch.data.preprocessing.TrainingDataset` in
``data.cache_dir``, keyed by the input files' (size, mtime) and every data
setting that changes the preparation, so reruns and sweeps over model or
training settings skip the CSV -> prune -> index -> feature work.

The key also names this package, so the JAX package's cache files in the
same directory (which hold its own classes) are never read here. A file is
only ever one this program wrote.
"""

from __future__ import annotations

import hashlib
import json
import pickle
from pathlib import Path
from typing import Any, Mapping

from ..utils import get_logger
from .preprocessing import TrainingDataset

logger = get_logger("data")

_CACHE_VERSION = 1


def dataset_cache_key(
    data_dir: Path,
    *,
    books_file: str | None,
    users_file: str | None,
    books_limit: int | None,
    interactions_limit: int | None,
    min_user_interactions: int,
    min_item_interactions: int,
    feature_config: Mapping[str, Any] | None,
) -> str | None:
    """A stable key over the input files and the preparation settings; None
    when an input file is missing."""
    parts: dict[str, Any] = {
        "package": "ttamm_torch",
        "version": _CACHE_VERSION,
        "books_limit": books_limit,
        "interactions_limit": interactions_limit,
        "min_user": min_user_interactions,
        "min_item": min_item_interactions,
        "features": dict(feature_config or {}),
    }
    for label, name in (("books", books_file or "books.csv"), ("users", users_file or "users.csv")):
        path = Path(data_dir) / name
        if not path.exists():
            return None
        stat = path.stat()
        parts[label] = [name, stat.st_size, int(stat.st_mtime)]
    blob = json.dumps(parts, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:24]


def cache_path(cache_dir: Path | str, key: str) -> Path:
    return Path(cache_dir) / f"dataset_{key}.pkl"


def save_training_dataset(dataset: TrainingDataset, path: Path) -> None:
    """Write ``dataset`` to ``path`` through a temporary file and a rename,
    so a reader never sees a part-written cache."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as handle:
        pickle.dump(dataset, handle, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    logger.info("Cached the prepared dataset -> %s", path)


def load_training_dataset(path: Path) -> TrainingDataset | None:
    """The cached dataset at ``path``; None when it is missing or unreadable
    (the caller prepares the data again)."""
    if not path.is_file():
        return None
    try:
        with open(path, "rb") as handle:
            dataset = pickle.load(handle)
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError, ImportError) as exc:
        logger.warning("Ignoring unreadable dataset cache %s (%s)", path, exc)
        return None
    if not isinstance(dataset, TrainingDataset):
        logger.warning("Ignoring dataset cache %s: it holds a %s", path, type(dataset).__name__)
        return None
    logger.info("Loaded the prepared dataset from cache %s", path)
    return dataset
