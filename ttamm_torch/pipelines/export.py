"""Build the serving bundle with the port.

config -> data (``ttamm_torch.data``, host-side) -> model (seeded init, or a
checkpoint of the port's trainer or of the JAX package: a flat ``.npz``
through ``ttamm_torch.models.convert``, or a sharded checkpoint directory,
every rank's pieces assembled in this one process by
``load_sharded_checkpoint``) ->
``encode_corpus`` for items and users on the device -> ``items.index`` +
``item_embeddings.npy`` + ``user_embeddings.npy`` + ``vocab.json``: the
layout the JAX training pipeline writes (``ttamm_tpu/pipelines/training.py``,
serving-bundle export), read by either package's ``RetrievalService``.

    python -m ttamm_torch.pipelines.export --config configs/default.yaml --out DIR \
        [--checkpoint artifacts/checkpoints/baseline_two_tower_last.pt]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU. The
features go to the towers in float32 whatever ``data.features_dtype`` says,
as the JAX package's export does.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..data import TrainingDataset, build_training_dataset, load_dataset
from ..device import resolve_device
from ..models.convert import from_jax_checkpoint
from ..models.two_tower import TwoTower, parse_model_config
from ..serve.flat_index import build_flat_index
from ..train.sharded_checkpoint import MANIFEST, load_sharded_checkpoint
from ..train.state import create_train_state
from ..train.step import encode_corpus
from ..utils import get_logger, load_config

logger = get_logger("export")


@dataclass
class ExportResult:
    out_dir: Path
    num_users: int
    num_items: int
    embedding_dim: int
    score_dtype: str
    encode_seconds: dict[str, float]  # per side, device-synchronised


def prepare_data(config: Mapping[str, Any]) -> TrainingDataset:
    """Load and preprocess the ``data:`` section, as the JAX pipeline does."""
    data_cfg = dict(config.get("data", {}))
    dataset = load_dataset(
        Path(data_cfg.get("root", "data")),
        books_file=data_cfg.get("books_file"),
        interactions_file=data_cfg.get("users_file"),
        books_limit=data_cfg.get("books_limit"),
        interactions_limit=data_cfg.get("interactions_limit"),
    )
    return build_training_dataset(
        dataset,
        stage="train",
        feature_config=data_cfg.get("feature_params", {}),
        min_user_interactions=int(data_cfg.get("min_user_interactions", 0)),
        min_item_interactions=int(data_cfg.get("min_item_interactions", 0)),
    )


def _features(matrix: np.ndarray, device: torch.device) -> torch.Tensor | None:
    if matrix.size == 0:
        return None
    return torch.from_numpy(np.ascontiguousarray(matrix, np.float32)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sharded_model(path: Path, cfg, num_users: int, num_items: int,
                   device: torch.device) -> TwoTower:
    """The model of a sharded checkpoint directory (any number of shard
    files, the port's or the JAX package's), assembled on one device."""
    if not (path / MANIFEST).is_file():
        raise FileNotFoundError(f"{path} is a directory without {MANIFEST}: not a sharded checkpoint")
    template = create_train_state(cfg, num_users=num_users, num_items=num_items, seed=0,
                                  device=device)
    state, _ = load_sharded_checkpoint(path, template)
    return state.model.eval()


def export_bundle(
    config: Mapping[str, Any],
    out_dir: Path | str,
    *,
    device: torch.device | str | None = None,
    checkpoint: Path | str | None = None,
    dataset: TrainingDataset | None = None,
) -> ExportResult:
    """Encode both sides and write the serving bundle to ``out_dir``.

    Runs on ``device`` (``None``: the CUDA card). The model is the
    checkpoint at ``checkpoint`` (the port's trainer and the JAX package
    write the same formats: a flat ``.npz`` or a sharded directory) when
    given, otherwise a seeded init from ``experiment.seed``. The index scores in
    ``serving.score_dtype``. 'auto' exports float32 and says so: the bf16
    recall gate runs in the trainer, on its final val eval
    (``TrainingResult.serving_score_dtype``, and the dtype in the header of
    the index it writes), so a caller that wants the gate's choice passes
    it here. ``dataset`` skips the data prep when the caller already holds
    it.
    """
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    dataset = dataset if dataset is not None else prepare_data(config)
    num_users = len(dataset.user_mapping)
    num_items = len(dataset.item_mapping)
    model_cfg = parse_model_config(
        config.get("model", {}),
        user_feature_dim=dataset.user_feature_matrix.shape[1],
        item_feature_dim=dataset.item_feature_matrix.shape[1],
    )
    if checkpoint is not None:
        if Path(checkpoint).is_dir():
            model = _sharded_model(Path(checkpoint), model_cfg, num_users, num_items, dev)
        else:
            model = from_jax_checkpoint(checkpoint, model_cfg, device=dev)
        if (model.num_users, model.num_items) != (num_users, num_items):
            raise ValueError(
                f"checkpoint has {model.num_users} users x {model.num_items} items, "
                f"the data {num_users} x {num_items}"
            )
    else:
        seed = int((config.get("experiment") or {}).get("seed", 0))
        model = TwoTower(
            model_cfg, num_users=num_users, num_items=num_items, seed=seed, device=dev
        )

    embeddings, encode_seconds = {}, {}
    for side, matrix in (
        ("item", dataset.item_feature_matrix),
        ("user", dataset.user_feature_matrix),
    ):
        feats = _features(matrix, dev)
        _sync(dev)
        start = time.perf_counter()
        emb = encode_corpus(model, side, feats)
        _sync(dev)
        encode_seconds[side] = time.perf_counter() - start
        embeddings[side] = emb.cpu().numpy()

    score_dtype = str((config.get("serving") or {}).get("score_dtype", "auto"))
    if score_dtype == "auto":
        logger.info(
            "serving.score_dtype auto: the bf16 recall gate runs in the trainer; "
            "exporting float32"
        )
        score_dtype = "float32"
    index = build_flat_index(
        embeddings["item"],
        normalize=model_cfg.similarity == "cosine",
        score_dtype=score_dtype,
        device="cpu",  # only written out here
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    index.save(out_dir / "items.index")
    np.save(out_dir / "item_embeddings.npy", index.embeddings)
    np.save(out_dir / "user_embeddings.npy", embeddings["user"])
    (out_dir / "vocab.json").write_text(
        json.dumps(
            {
                "user_ids": dataset.user_mapping.index_to_id,
                "item_ids": dataset.item_mapping.index_to_id,
                "similarity": model_cfg.similarity,
            }
        ),
        encoding="utf-8",
    )
    return ExportResult(
        out_dir=out_dir,
        num_users=num_users,
        num_items=num_items,
        embedding_dim=int(index.dim),
        score_dtype=score_dtype,
        encode_seconds=encode_seconds,
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Write the serving bundle with the PyTorch port.")
    parser.add_argument("--config", type=Path, default=Path("configs/default.yaml"))
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--data-root", type=Path, default=None, help="override data.root")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument(
        "--checkpoint", type=Path, default=None,
        help="training checkpoint: a flat .npz or a sharded directory (the port's or the "
             "JAX package's)",
    )
    args = parser.parse_args(argv)

    config = load_config(args.config)
    if args.data_root is not None:
        config.setdefault("data", {})["root"] = str(args.data_root)
    result = export_bundle(config, args.out, device=args.device, checkpoint=args.checkpoint)
    print(json.dumps({
        "out_dir": str(result.out_dir),
        "users": result.num_users,
        "items": result.num_items,
        "dim": result.embedding_dim,
        "score_dtype": result.score_dtype,
        "encode_seconds": result.encode_seconds,
    }))


if __name__ == "__main__":
    main()
