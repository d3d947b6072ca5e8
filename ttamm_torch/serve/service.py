"""RetrievalService: userId -> top-K item ASINs over the serving bundle.

The bundle is the one the JAX training pipeline and the port's export
write: ``items.index`` (TTFLAT1) + ``user_embeddings.npy`` + ``vocab.json``.
The index is uploaded to the device once, at load; searches run the port's
``mips_topk`` there (``backend="numpy"`` asks for the exact host search).
The HTTP front end (``ttamm_torch.serve.http_server``) takes this object.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .flat_index import FlatIndex


@dataclass
class RetrievalService:
    index: FlatIndex
    user_embeddings: np.ndarray
    user_ids: list[str]
    item_ids: list[str]
    user_to_idx: dict[str, int]
    similarity: str = "cosine"

    @classmethod
    def from_artifacts(
        cls,
        artifacts_dir: Path | str,
        *,
        device: torch.device | str | None = None,
        score_dtype: str | None = None,
    ) -> "RetrievalService":
        """Load the bundle and upload the index to ``device`` (``None``: the
        CUDA card); ``score_dtype`` overrides the index header's."""
        artifacts_dir = Path(artifacts_dir)
        index = FlatIndex.load(
            artifacts_dir / "items.index", device=device, score_dtype=score_dtype
        )
        user_embeddings = np.load(artifacts_dir / "user_embeddings.npy")
        vocab = json.loads((artifacts_dir / "vocab.json").read_text("utf-8"))
        user_ids = list(vocab["user_ids"])
        return cls(
            index=index,
            user_embeddings=np.asarray(user_embeddings, np.float32),
            user_ids=user_ids,
            item_ids=list(vocab["item_ids"]),
            user_to_idx={uid: i for i, uid in enumerate(user_ids)},
            similarity=str(vocab.get("similarity", "cosine")),
        )

    def recommend_for_user(
        self,
        user_id: str,
        k: int = 10,
        *,
        exclude: set[int] | None = None,
        backend: str = "auto",
    ) -> list[tuple[str, float]]:
        """Top-k (asin, score) for a known userId, skipping the item
        indices in ``exclude``."""
        if user_id not in self.user_to_idx:
            raise KeyError(f"Unknown userId: {user_id}")
        query = self.user_embeddings[self.user_to_idx[user_id]]
        extra = len(exclude) if exclude else 0
        scores, idx = self.index.search(
            query[None, :], min(k + extra, len(self.index)), backend=backend
        )
        out: list[tuple[str, float]] = []
        for item, score in zip(idx[0], scores[0]):
            if exclude and int(item) in exclude:
                continue
            out.append((self.item_ids[int(item)], float(score)))
            if len(out) >= k:
                break
        return out

    def recommend_for_embedding(
        self, embedding: np.ndarray, k: int = 10, *, backend: str = "auto"
    ) -> list[tuple[str, float]]:
        """Top-k for an arbitrary user embedding (cold-start path)."""
        scores, idx = self.index.search(
            np.asarray(embedding, np.float32)[None, :], k, backend=backend
        )
        return [
            (self.item_ids[int(i)], float(s)) for i, s in zip(idx[0], scores[0])
        ]
