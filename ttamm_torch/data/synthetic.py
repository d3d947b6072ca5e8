"""Synthetic Amazon-books-like dataset generation.

The reference repo ships only 10-row trimmed CSV samples whose books and
interactions do not overlap (no trainable smoke data); the full Amazon
dataset is not distributed. This generator produces schema-identical frames
(books: ``title,author,average_rating,rating_number,price,categories,
parent_asin``; users: ``parent_asin,userId,timestamp``) with a latent-factor
preference structure so recall metrics are learnable, at any scale — used
by the end-to-end tests and the throughput benchmarks.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .loaders import DatasetArtifacts

# The canonical full-scale corpus (the parameters of scripts/make_corpus.py):
# 200k users x 100k items x 2M interactions, 30 authors, seed 0.
CANONICAL_CORPUS = dict(
    num_users=200_000,
    num_items=100_000,
    num_interactions=2_000_000,
    num_authors=30,
    seed=0,
)

_CATEGORY_POOL = [
    "Literature & Fiction",
    "Mystery, Thriller & Suspense",
    "Science Fiction & Fantasy",
    "History",
    "Romance",
    "Biographies & Memoirs",
    "Children's Books",
    "Business & Money",
    "Science & Math",
    "Self-Help",
]
_SUBCATEGORY_POOL = [
    "Classics",
    "Contemporary",
    "Anthologies",
    "Short Stories",
    "Essays",
    "Reference",
]


def generate_synthetic_dataset(
    *,
    num_users: int = 200,
    num_items: int = 120,
    num_interactions: int = 2000,
    num_authors: int = 30,
    latent_dim: int = 8,
    seed: int = 0,
    start_timestamp_ms: int = 1_600_000_000_000,
) -> DatasetArtifacts:
    """Generate (books, interactions) frames with learnable structure.

    Users and items get latent factors; interaction probabilities follow
    softmax(user . item), so a trained two-tower model can beat random
    recall. Timestamps are strictly increasing per draw so the
    latest-per-user holdout split is deterministic.
    """
    rng = np.random.default_rng(seed)

    asins = [f"B{idx:09d}" for idx in range(num_items)]
    authors = [f"Author {idx}" for idx in range(num_authors)]
    item_authors = rng.choice(authors, size=num_items)
    cat_main = rng.choice(_CATEGORY_POOL, size=num_items)
    cat_sub = rng.choice(_SUBCATEGORY_POOL, size=num_items)

    books = pd.DataFrame(
        {
            "title": [
                " ".join(
                    rng.choice(
                        ["The", "A", "Silent", "Lost", "Hidden", "Last", "First",
                         "Garden", "River", "Night", "Winter", "Story", "House"],
                        size=rng.integers(2, 6),
                    )
                )
                for _ in range(num_items)
            ],
            "author": item_authors,
            "average_rating": np.round(rng.uniform(1.0, 5.0, num_items), 1),
            "rating_number": rng.integers(1, 5000, num_items),
            "price": np.round(rng.uniform(2.0, 60.0, num_items), 2),
            "categories": [
                str(["Books", str(main), str(sub)])
                for main, sub in zip(cat_main, cat_sub)
            ],
            "parent_asin": asins,
        }
    )

    # Learnable structure, fully vectorised (scales to benchmark sizes):
    # each user prefers one category; 80% of their interactions come from
    # that category's items, the rest are popularity-skewed uniform draws.
    cat_ids = pd.Series(cat_main).astype("category").cat.codes.to_numpy()
    num_cats = int(cat_ids.max()) + 1
    cat_counts = np.bincount(cat_ids, minlength=num_cats)
    max_len = int(cat_counts.max())
    cat_items = np.zeros((num_cats, max_len), dtype=np.int64)
    fill = np.zeros(num_cats, dtype=np.int64)
    for item, cat in enumerate(cat_ids):
        cat_items[cat, fill[cat]] = item
        fill[cat] += 1

    user_pref = rng.integers(0, num_cats, num_users)
    user_col = rng.integers(0, num_users, num_interactions)
    pref_cats = user_pref[user_col]
    in_pref = rng.random(num_interactions) < 0.8
    slot = (rng.random(num_interactions) * cat_counts[pref_cats]).astype(np.int64)
    pref_items = cat_items[pref_cats, np.minimum(slot, cat_counts[pref_cats] - 1)]
    zipf_ranks = rng.zipf(1.3, num_interactions) % num_items
    item_col = np.where(in_pref, pref_items, zipf_ranks).astype(np.int64)
    del latent_dim  # retained in the signature for config compatibility

    interactions = pd.DataFrame(
        {
            "parent_asin": [asins[i] for i in item_col],
            "userId": [f"U{u:08d}" for u in user_col],
            "timestamp": start_timestamp_ms + np.arange(num_interactions) * 1000,
        }
    )
    return DatasetArtifacts(books=books, interactions=interactions)


def write_synthetic_csvs(
    out_dir, *, books_file: str = "books.csv", users_file: str = "users.csv", **kwargs
) -> None:
    """Write the synthetic frames as reference-schema CSVs."""
    from pathlib import Path

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dataset = generate_synthetic_dataset(**kwargs)
    dataset.books.to_csv(out_dir / books_file, index=False)
    dataset.interactions.to_csv(out_dir / users_file, index=False)
