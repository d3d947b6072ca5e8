"""Host -> device packing: fixed-shape arrays for the compiled TPU path.

XLA requires static shapes, so the reference's Python dict-of-sets state
(``user_positive_items``, ``train_positive_map``) becomes padded int32
matrices here, and the per-item primary-category lookup
(``src/pipelines/training.py:582-610``, an iterrows loop) becomes a
vectorised int32 array with categories ordered by descending frequency
(so category id 0 is always the majority category).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import pandas as pd

from .features import parse_category_tokens
from ..utils.logging import get_logger

logger = get_logger("data")


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class PaddedPositives:
    """Per-user positive item ids, padded to a fixed width.

    ``rows[u, :]`` holds user u's positive item indices, padded with
    ``fill_value`` (= num_items, an id no real item uses). ``counts[u]`` is
    the true positive count. Users whose positives exceed ``cap`` keep only
    their first ``cap`` entries — with a corpus of >=10^5 items the chance a
    uniform negative draw hits one of the dropped tail positives is
    negligible, and the train-time semantics ("exclude the user's
    positives", ``src/data/samplers.py:64-76``) are preserved to within
    run-to-run variance.
    """

    rows: np.ndarray  # int32 [num_users, cap]
    counts: np.ndarray  # int32 [num_users]
    fill_value: int
    truncated_users: int


def pack_positives(
    positives: Mapping[int, set[int]],
    *,
    num_users: int,
    num_items: int,
    cap: int | None = None,
    pad_multiple: int = 8,
) -> PaddedPositives:
    """Pack a dict of per-user positive sets into a padded int32 matrix."""
    lengths = np.zeros((num_users,), dtype=np.int64)
    for user_idx, items in positives.items():
        lengths[user_idx] = len(items)
    max_len = int(lengths.max()) if num_users else 0
    width = max_len if cap is None else min(max_len, int(cap))
    width = max(_round_up(max(width, 1), pad_multiple), pad_multiple)

    rows = np.full((num_users, width), num_items, dtype=np.int32)
    counts = np.zeros((num_users,), dtype=np.int32)
    truncated = 0
    for user_idx, items in positives.items():
        vals = sorted(items)
        if len(vals) > width:
            truncated += 1
            vals = vals[:width]
        rows[user_idx, : len(vals)] = np.asarray(vals, dtype=np.int32)
        counts[user_idx] = len(vals)

    if truncated:
        logger.warning(
            "pack_positives: %d users exceeded the positives cap (%d); "
            "tail positives are ignored for negative-sampling rejection.",
            truncated,
            width,
        )
    return PaddedPositives(
        rows=rows, counts=counts, fill_value=num_items, truncated_users=truncated
    )


def positives_from_frame(
    interactions: pd.DataFrame,
) -> dict[int, set[int]]:
    """Per-user positive sets from an interaction frame (user_idx, item_idx).

    Vectorized sort+split (a per-group ``groupby`` iteration costs ~20 s at
    200k users on this host); insertion order stays ascending by user_idx,
    matching ``groupby``'s sorted keys.
    """
    if interactions.empty:
        return {}
    users = interactions["user_idx"].to_numpy(dtype=np.int64)
    items = interactions["item_idx"].to_numpy(dtype=np.int64)
    order = np.argsort(users, kind="stable")
    users_sorted = users[order]
    items_sorted = items[order]
    bounds = np.flatnonzero(np.diff(users_sorted)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(users_sorted)]])
    return {
        int(users_sorted[s]): set(map(int, items_sorted[s:e]))
        for s, e in zip(starts, ends)
    }


def interaction_arrays(interactions: pd.DataFrame) -> tuple[np.ndarray, np.ndarray]:
    """(user_idx, item_idx) int32 arrays from an interaction frame."""
    users = interactions["user_idx"].to_numpy(dtype=np.int32)
    items = interactions["item_idx"].to_numpy(dtype=np.int32)
    return users, items


@dataclass(frozen=True)
class ItemCategories:
    """Per-item primary-category ids, frequency-ordered.

    ``category_ids[i]`` is item i's primary category; id 0 is the majority
    category (the reference's ``major_category_id``). Items with no parsed
    category share the ``<unknown>`` id.
    """

    category_ids: np.ndarray  # int32 [num_items]
    category_names: list[str]  # id -> name, ordered by descending frequency
    major_category_id: int  # always 0 by construction (kept for clarity)


def build_item_categories(
    items: pd.DataFrame, *, num_items: int
) -> ItemCategories | None:
    """Vectorised equivalent of ``_build_item_category_tensor`` (ref
    ``training.py:582-610``): primary category = first parsed token."""
    if num_items == 0 or "item_idx" not in items:
        return None

    primaries = np.array(["<unknown>"] * num_items, dtype=object)
    idx_arr = items["item_idx"].to_numpy(dtype=np.int64)
    cats_raw = (
        items["categories"].tolist()
        if "categories" in items
        else [None] * len(items)
    )
    for idx, raw in zip(idx_arr, cats_raw):
        tokens = parse_category_tokens(raw)
        primaries[idx] = tokens[0] if tokens else "<unknown>"

    names, counts = np.unique(primaries, return_counts=True)
    if names.size == 0:
        return None
    # Order by descending frequency (stable) so the majority category is id 0.
    order = np.argsort(-counts, kind="stable")
    ordered_names = [str(n) for n in names[order]]
    name_to_id = {name: i for i, name in enumerate(ordered_names)}
    ids = np.asarray([name_to_id[str(p)] for p in primaries], dtype=np.int32)
    return ItemCategories(
        category_ids=ids, category_names=ordered_names, major_category_id=0
    )
