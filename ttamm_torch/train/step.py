"""Corpus encoding (port of ``encode_corpus`` in ``ttamm_tpu/train/step.py``).

Only the inference piece of the training step module is ported so far: the
training and eval steps are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from ..models.two_tower import TwoTower


@torch.no_grad()
def encode_corpus(
    model: TwoTower,
    side: str,
    features: torch.Tensor | None = None,
    *,
    chunk_size: int = 65536,
) -> torch.Tensor:
    """Encode every user or item through its tower (+ mimic augmentation).

    Walks the rows in contiguous chunks of ``chunk_size`` on the model's
    device and returns f32 ``[num_rows, D]`` there. ``features`` is the
    side's ``[num_rows, F]`` feature matrix (or None / empty for an ID-only
    tower); chunks of it are moved to the model's device as they are used.
    """
    tower = model.tower(side)
    table = tower.id_embedding.weight
    dev = table.device
    n = table.shape[0]
    if features is not None and features.numel() == 0:
        features = None
    aug = model.mimic.table(side).weight if model.mimic is not None else None
    out = torch.empty((n, tower.cfg.output_dim), dtype=torch.float32, device=dev)
    for start in range(0, n, chunk_size):
        end = min(start + chunk_size, n)
        feats = None if features is None else features[start:end].to(dev)
        emb = tower.forward_rows(table[start:end], feats)
        if aug is not None:
            emb = emb + aug[start:end]
        out[start:end] = emb
    return out
