"""The training corpus both sides read: made once a checkout, then loaded.

The corpus is the port's synthetic generator at the configuration's
``corpus`` parameters (a frozen copy of ``CANONICAL_CORPUS``), through the
configuration's ``data`` section as the trainer prepares it: the data prep,
the train / validation / test split at ``experiment.seed``, the padded
per-user positives of every interaction (what negative sampling rejects),
the frequency-ordered primary categories, and the train split's log item
frequencies (the logQ correction). The arrays are written to one ``.npz``
under ``portbench/.cache/`` (named by a hash of those parameters) and read
from there by every later run; the CSVs are deleted once it is written.
The program and the reference are handed the same arrays.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parent / ".cache"
KEYS = ("user_features", "item_features", "positive_rows", "category_ids", "item_log_q",
        "train_users", "train_items")


def _key(config: dict) -> str:
    cfg = config["config"]
    blob = json.dumps({"corpus": config["corpus"], "data": cfg.get("data", {}),
                       "seed": cfg.get("experiment", {}).get("seed")}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _make(config: dict, path: Path, cache: Path) -> None:
    import pandas as pd  # noqa: F401  (the port's data prep needs it)

    from ttamm_torch.data import (
        build_item_categories, interaction_arrays, pack_positives, split_train_validation_test,
        write_synthetic_csvs,
    )
    from ttamm_torch.pipelines.export import prepare_data

    cfg = config["config"]
    data_cfg = dict(cfg.get("data", {}))
    csv_dir = cache / f"csv_{path.stem}"
    write_synthetic_csvs(csv_dir, books_file=data_cfg.get("books_file", "books.csv"),
                         users_file=data_cfg.get("users_file", "users.csv"), **config["corpus"])
    try:
        dataset = prepare_data({**cfg, "data": {**data_cfg, "root": str(csv_dir)}})
    finally:
        shutil.rmtree(csv_dir, ignore_errors=True)
    num_users, num_items = len(dataset.user_mapping), len(dataset.item_mapping)
    train_df, _, _ = split_train_validation_test(
        dataset.interactions, train_fraction=data_cfg.get("train_fraction"),
        test_fraction=data_cfg.get("test_fraction"), seed=int(cfg["experiment"]["seed"]))
    cap = data_cfg.get("positives_cap")
    positives = pack_positives(dataset.user_positive_items, num_users=num_users, num_items=num_items,
                               cap=int(cap) if cap else None)
    categories = build_item_categories(dataset.items, num_items=num_items)
    users, items = interaction_arrays(train_df)
    counts = np.bincount(items, minlength=num_items).astype(np.float64)
    log_q = np.log(np.maximum(counts, 1.0) / max(counts.sum(), 1.0)).astype(np.float32)
    arrays = dict(
        user_features=np.ascontiguousarray(dataset.user_feature_matrix, np.float32),
        item_features=np.ascontiguousarray(dataset.item_feature_matrix, np.float32),
        positive_rows=positives.rows, category_ids=categories.category_ids, item_log_q=log_q,
        train_users=users, train_items=items,
        num_categories=np.int64(len(categories.category_names)),
    )
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load(config: dict, cache: Path = CACHE) -> dict[str, np.ndarray]:
    """The corpus arrays of ``config`` (a ``portbench/configs`` file as a
    dict), made first where ``cache`` has none yet."""
    cache.mkdir(parents=True, exist_ok=True)
    path = cache / f"corpus_{_key(config)}.npz"
    if not path.is_file():
        _make(config, path, cache)
    with np.load(path) as npz:
        out = {k: npz[k] for k in KEYS}
        out["num_categories"] = int(npz["num_categories"])
    return out
