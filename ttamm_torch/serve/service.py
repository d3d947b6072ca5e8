"""RetrievalService over the port's ``FlatIndex``: userId -> top-K item ids.

Subclasses ``ttamm_tpu.serve.service.RetrievalService`` (bundle layout,
vocabularies, exclusion logic) and swaps in an index searched by the port's
device backend; its default ``backend="auto"`` is that device backend (see
``FlatIndex.search``). The HTTP front end is the JAX package's, reused as it is:
``ttamm_tpu.serve.http_server.make_server`` / ``start_in_thread`` /
``serve_forever`` take any object with this interface.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from ttamm_tpu.serve import service as _host

from .flat_index import FlatIndex


@dataclass
class RetrievalService(_host.RetrievalService):
    @classmethod
    def from_artifacts(
        cls,
        artifacts_dir: Path | str,
        *,
        device: torch.device | str | None = None,
        score_dtype: str | None = None,
    ) -> "RetrievalService":
        """Load ``items.index`` + ``user_embeddings.npy`` + ``vocab.json``
        and upload the index to ``device`` once."""
        service = super().from_artifacts(artifacts_dir)
        service.index = FlatIndex.from_host(
            service.index, device=device, score_dtype=score_dtype
        )
        return service
