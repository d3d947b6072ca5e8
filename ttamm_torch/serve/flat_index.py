"""Flat MIPS index whose device backend is the port's ``mips_topk``.

The artifact format is the JAX package's TTFLAT1 file, byte for byte: this
class subclasses ``ttamm_tpu.serve.flat_index.FlatIndex`` and keeps its
``save``, its header and its host backends ('native', 'numpy').

The corpus is uploaded once, when the index is built or loaded, padded with
zero rows to a multiple of 128 (searches pass ``num_valid_rows``, so no
per-call copy) and stored in the index's scoring dtype. Nothing is cached
lazily afterwards, so concurrent searches from the threaded HTTP server
only read shared state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ttamm_tpu.serve import flat_index as _host

from ..device import resolve_device
from ..ops.topk import GROUP, mips_topk

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(eq=False)
class FlatIndex(_host.FlatIndex):
    """An exact inner-product index over a row matrix, searched on
    ``device`` (``None``: CUDA when available, else the CPU, where the
    kernels' plain versions run)."""

    device: torch.device | str | None = None

    def __post_init__(self) -> None:
        if self.score_dtype not in _DTYPES:
            raise ValueError(f"Unknown score_dtype: {self.score_dtype}")
        self.device = resolve_device(self.device)
        n, dim = self.embeddings.shape
        corpus = torch.zeros(
            (-(-n // GROUP) * GROUP, dim), dtype=_DTYPES[self.score_dtype],
            device=self.device,
        )
        host = torch.from_numpy(np.ascontiguousarray(self.embeddings, np.float32))
        corpus[:n] = host.to(self.device)
        self.corpus = corpus  # the padded device copy every search reads

    @classmethod
    def from_host(
        cls,
        index: _host.FlatIndex,
        *,
        device: torch.device | str | None = None,
        score_dtype: str | None = None,
    ) -> "FlatIndex":
        """Upload a host index (``ttamm_tpu.serve.flat_index.FlatIndex``, as
        its ``load`` returns it); ``score_dtype`` overrides its own."""
        return cls(
            embeddings=index.embeddings,
            normalized=index.normalized,
            score_dtype=score_dtype or index.score_dtype,
            device=device,
        )

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        backend: str = "device",
        algorithm: str = "auto",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k by inner product: (scores f32 [B, k], indices int64 [B, k]).

        backend: 'device' (and 'auto', its alias here) runs the port's
        ``mips_topk`` with ``algorithm`` on the index's device; 'native' and
        'numpy' are the JAX package's host searchers.
        """
        if backend in ("native", "numpy"):
            return super().search(queries, k, backend=backend)
        if backend not in ("auto", "device"):
            raise ValueError(f"Unknown backend: {backend}")
        if self.corpus.dtype != _DTYPES[self.score_dtype]:
            raise ValueError(
                f"index uploaded for {self.corpus.dtype} scoring, asked for "
                f"{self.score_dtype}; load it again with score_dtype="
            )
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.normalized:
            norms = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(norms, 1e-12)
        scores, idx = mips_topk(
            torch.from_numpy(queries).to(self.device),
            self.corpus,
            k=min(k, len(self)),
            num_valid_rows=len(self),
            algorithm=algorithm,
            score_dtype=self.score_dtype,
        )
        return scores.cpu().numpy(), idx.cpu().numpy()


def build_flat_index(
    embeddings: np.ndarray,
    *,
    normalize: bool = False,
    score_dtype: str = "float32",
    device: torch.device | str | None = None,
) -> FlatIndex:
    """Build an index (rows L2-normalised when ``normalize``, the cosine
    mode) and upload it to ``device``."""
    host = _host.build_flat_index(embeddings, normalize=normalize, score_dtype=score_dtype)
    return FlatIndex.from_host(host, device=device)
