"""Train / validation / test interaction splits.

Parity with ``src/pipelines/training.py:193-257``:

- validation = the latest-timestamp interaction per user, holding out only
  for users with >1 interaction and at least one valid timestamp;
- test = a seeded random ``test_fraction`` of the remaining training rows
  (when ``train_fraction`` is given without ``test_fraction``, test takes
  the complement);
- no timestamp column => everything stays train and val/test are empty.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..utils.logging import get_logger

logger = get_logger("data")


def split_train_validation(
    interactions: pd.DataFrame,
) -> tuple[pd.DataFrame, pd.DataFrame]:
    """Hold out the latest-timestamp record per user as validation."""
    df = interactions.copy()
    if "timestamp" not in df.columns:
        logger.warning(
            "No timestamp column detected; skipping hold-out split and using "
            "all interactions for training."
        )
        return df, df.iloc[0:0]

    df = df.sort_values("timestamp").reset_index(drop=True)

    # Vectorized "latest valid timestamp per user, only for users with >1
    # interaction" — exact replica of the reference's per-group
    # ``dropna().idxmax()`` (first positional max on ties, ref
    # ``training.py:205-212``), without iterating 200k groups.
    users = df["user_idx"].to_numpy()
    ts = pd.to_numeric(df["timestamp"], errors="coerce").to_numpy(dtype=np.float64)
    valid = ~np.isnan(ts)
    codes, uniques = pd.factorize(users, use_na_sentinel=False)
    num_users = len(uniques)
    counts = np.bincount(codes, minlength=num_users)
    # max valid timestamp per user (users with no valid ts keep -inf)
    max_ts = np.full(num_users, -np.inf)
    valid_pos = np.flatnonzero(valid)
    # df is timestamp-sorted ascending with NaNs last, so a forward pass of
    # positional assignment leaves each user's LAST (= max) valid row.
    max_ts[codes[valid_pos]] = ts[valid_pos]
    eligible = (counts > 1) & (max_ts > -np.inf)
    # idxmax = FIRST position attaining the max; reverse assignment keeps it
    cand = valid & eligible[codes] & (ts == max_ts[codes])
    first_max = np.full(num_users, -1, dtype=np.int64)
    cand_pos = np.flatnonzero(cand)[::-1]
    first_max[codes[cand_pos]] = cand_pos
    # groupby iterates users in ascending user_idx order
    holdout = first_max[first_max >= 0]
    user_of_holdout = users[holdout]
    val_indices = [int(i) for i in holdout[np.argsort(user_of_holdout, kind="stable")]]

    if not val_indices:
        logger.warning(
            "Validation split empty after hold-out; training will proceed "
            "without evaluation."
        )
        return df, df.iloc[0:0]

    val_df = df.loc[val_indices].reset_index(drop=True)
    train_df = df.drop(index=val_indices).reset_index(drop=True)
    return train_df, val_df


def split_train_validation_test(
    interactions: pd.DataFrame,
    *,
    train_fraction: float | None,
    test_fraction: float | None,
    seed: int | None = None,
) -> tuple[pd.DataFrame, pd.DataFrame, pd.DataFrame]:
    """Latest-per-user validation holdout plus a seeded random test split."""
    train_df, val_df = split_train_validation(interactions)

    if train_fraction is not None and test_fraction is None:
        test_fraction = max(0.0, 1.0 - float(train_fraction))

    test_fraction = float(test_fraction or 0.0)
    if test_fraction <= 0.0 or train_df.empty:
        return train_df, val_df, train_df.iloc[0:0]

    rng = np.random.default_rng(seed)
    test_size = max(1, int(round(len(train_df) * min(test_fraction, 1.0))))
    if test_size >= len(train_df):
        test_df = train_df.copy()
        train_df = train_df.iloc[0:0]
        return train_df.reset_index(drop=True), val_df, test_df.reset_index(drop=True)

    indices = train_df.index.to_numpy()
    sampled = rng.choice(indices, size=test_size, replace=False)
    test_df = train_df.loc[sampled].copy().reset_index(drop=True)
    train_df = train_df.drop(index=sampled).reset_index(drop=True)
    return train_df, val_df, test_df
