"""Train with the PyTorch port:

    python -m ttamm_torch.train --config configs/default.yaml \\
        [--data-root DIR] [--max-steps N] [--device cuda|cpu]

and, for a config with ``mesh: {data_parallel: dp, model_parallel: mp}``,
one process per device:

    torchrun --nproc_per_node dp*mp -m ttamm_torch.train --config <config> \\
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` asks for the CPU (a mesh then
runs over gloo, on cards over NCCL). Runs once, or once per point of
``experiment.grid``, then writes the sweep ledger at
``experiment.benchmark_report`` when the config names one. Logs each
epoch's losses and val metrics, writes the checkpoints under
``training.checkpointing.dir`` and the serving bundle (item index and
embeddings, user embeddings, ``vocab.json``) beside
``evaluation.faiss.index_path``, and prints one JSON line of results per
run: its grid overrides, losses, the best epoch with its val recall and
ndcg at each k, the best and the last checkpoint, and the serving score
dtype. Under a mesh only rank 0 logs and prints.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch.distributed as dist

from ..parallel import is_primary_host
from ..pipelines.training import run_training
from ..utils import load_config


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Training CLI (PyTorch port).")
    parser.add_argument("--config", type=Path, default=Path("configs/default.yaml"))
    parser.add_argument("--data-root", type=Path, default=None, help="override data.root")
    parser.add_argument("--max-steps", type=int, default=None, help="stop after N steps")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    if args.data_root is not None:
        config.setdefault("data", {})["root"] = str(args.data_root)
    results = run_training(config, device=args.device, max_steps=args.max_steps)
    primary = is_primary_host()
    if dist.is_initialized():
        dist.barrier()  # every rank's files are written
        dist.destroy_process_group()
    if not primary:
        return
    for result in results if isinstance(results, list) else [results]:
        print(json.dumps(_summary(result)))


def _summary(result) -> dict:
    best = result.best_val_metrics
    return {
        "experiment": (result.config.get("experiment") or {}).get("name"),
        "overrides": dict(result.overrides or {}),
        "users": result.num_users,
        "items": result.num_items,
        "steps": result.steps,
        "train_loss": result.train_loss,
        "val_loss": result.val_loss,
        "test_loss": result.test_loss,
        "first_step_loss": result.first_step_loss,
        "examples_per_second": result.examples_per_second,
        "best_epoch": result.best_epoch,
        "best_val_recall": None if best is None else best.recall,
        "best_val_ndcg": None if best is None else best.ndcg,
        "best_checkpoint": _path(result.best_checkpoint_path),
        "checkpoint": _path(result.checkpoint_path),
        "serving_score_dtype": result.serving_score_dtype,
    }


def _path(path: Path | None) -> str | None:
    return None if path is None else str(path)


if __name__ == "__main__":
    main()
