"""Train with the PyTorch port:

    python -m ttamm_torch.train --config configs/default.yaml \\
        [--data-root DIR] [--max-steps N] [--device cuda|cpu]

Runs on the CUDA card unless ``--device cpu`` asks for the CPU. Logs each
epoch, writes ``{experiment}_last.pt`` under
``training.checkpointing.dir`` and prints one JSON line of the results.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..pipelines.training import run_single_experiment
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
    result = run_single_experiment(config, device=args.device, max_steps=args.max_steps)
    print(json.dumps({
        "users": result.num_users,
        "items": result.num_items,
        "steps": result.steps,
        "train_loss": result.train_loss,
        "val_loss": result.val_loss,
        "first_step_loss": result.first_step_loss,
        "examples_per_second": result.examples_per_second,
        "checkpoint": None if result.checkpoint_path is None else str(result.checkpoint_path),
    }))


if __name__ == "__main__":
    main()
