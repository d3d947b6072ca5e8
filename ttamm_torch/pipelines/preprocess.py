"""Preprocess the raw CSVs and cache the packed training arrays, with the
PyTorch port (the port of ``scripts/preprocess.py``):

    python -m ttamm_torch.pipelines.preprocess --config configs/default.yaml

Loads, prunes and featurises per ``data.*`` (``prepare_data``), prints the
user / item / interaction counts and the feature widths, and writes to
``data.cache_dir``: ``training_arrays.npz`` (``item_features``,
``user_features``, ``positive_rows``, ``positive_counts``, ``user_idx``,
``item_idx``, ``category_ids``) and ``vocab.json`` (``user_ids``,
``item_ids``, ``feature_metadata``, ``category_names``), the files the JAX
package's script writes. Host code: it touches no device.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import asdict
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from ..data import build_item_categories, pack_positives
from ..utils import load_config
from .export import prepare_data


def write_training_arrays(config: Mapping[str, Any]) -> Path:
    """Prepare ``config``'s data and write its arrays and vocabularies to
    ``data.cache_dir``, which is returned."""
    training = prepare_data(config)
    num_users = len(training.user_mapping)
    num_items = len(training.item_mapping)
    print(f"users={num_users} items={num_items} interactions={len(training.interactions)}")
    print(
        f"item_feature_dim={training.item_feature_matrix.shape[1]} "
        f"user_feature_dim={training.user_feature_matrix.shape[1]}"
    )
    cache_dir = Path(dict(config.get("data", {})).get("cache_dir", "artifacts/cache"))
    cache_dir.mkdir(parents=True, exist_ok=True)
    packed = pack_positives(training.user_positive_items, num_users=num_users, num_items=num_items)
    categories = build_item_categories(training.items, num_items=num_items)
    np.savez_compressed(
        cache_dir / "training_arrays.npz",
        item_features=training.item_feature_matrix,
        user_features=training.user_feature_matrix,
        positive_rows=packed.rows,
        positive_counts=packed.counts,
        user_idx=training.interactions["user_idx"].to_numpy(np.int32),
        item_idx=training.interactions["item_idx"].to_numpy(np.int32),
        category_ids=categories.category_ids if categories is not None else np.empty(0),
    )
    (cache_dir / "vocab.json").write_text(
        json.dumps({
            "user_ids": training.user_mapping.index_to_id,
            "item_ids": training.item_mapping.index_to_id,
            "feature_metadata": asdict(training.feature_metadata),
            "category_names": categories.category_names if categories is not None else [],
        }),
        encoding="utf-8",
    )
    return cache_dir


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Preprocess the dataset (PyTorch port).")
    parser.add_argument("--config", type=Path, default=Path("configs/default.yaml"))
    args = parser.parse_args(argv)
    cache_dir = write_training_arrays(load_config(args.config))
    print(f"cached arrays -> {cache_dir}")


if __name__ == "__main__":
    main()
