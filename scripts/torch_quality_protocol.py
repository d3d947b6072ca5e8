#!/usr/bin/env python3
"""The 3-seed quality protocol of the PyTorch port on one card.

For each corpus seed: the canonical corpus from the port's generator at the
``scripts/make_corpus.py`` parameters (``ttamm_torch.data.CANONICAL_CORPUS``
with that seed), then up to ``--epochs`` epochs of a config through the
port's trainer (``run_training``) with the config's early stopping, on the
card (the config's mesh set to 1x1: ``configs/pod_2x4.yaml``'s 2x4 runs
on one card as its header says, its bf16 gradient wire and bf16 features
as shipped). Records each epoch's val and test recall@10 and NDCG@10, the peak
epoch and its values, and the train loop's ms/step and examples/s (host
clock). Checkpoints are not written (the runs' numbers do not depend on
them); the eval, the serving gate, the bundle and the reports run as
configured (the bundle and the reports under ``--work``).

    python3 scripts/torch_quality_protocol.py                      # configs/in_batch_softmax.yaml, seeds 0 11 23
    python3 scripts/torch_quality_protocol.py --dense-mimic --seeds 0 11 13
    python3 scripts/torch_quality_protocol.py --config configs/default.yaml
    python3 scripts/torch_quality_protocol.py --config configs/pod_2x4.yaml

Prints one JSON line per seed and, last, the summary (mean and spread of the
peak recall@10 and NDCG@10); writes both to ``<out>/quality_<name>.json``.
The corpora (~0.1 GB each, reused across runs) and each run's serving
bundle go under ``--work``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _run(config: dict, seed: int, corpus: Path, work: Path, epochs: int, device: str) -> dict:
    from ttamm_torch.pipelines.training import run_training

    config = json.loads(json.dumps(config))  # a copy
    config["data"]["root"] = str(corpus)
    config["training"]["num_epochs"] = epochs
    config["training"]["checkpointing"]["enabled"] = False
    config["mesh"] = {"data_parallel": 1, "model_parallel": 1}  # one card
    config["experiment"]["benchmark_report"] = None
    faiss = config["evaluation"]["faiss"]
    faiss.update(index_path=str(work / "faiss" / "items.index"),
                 embedding_path=str(work / "faiss" / "item_embeddings.npy"))
    config["diagnostics"].update(
        report_path=str(work / "reports" / "recommendation_report.md"),
        loss_plot_path=str(work / "reports" / "loss_curve.png"),
        embedding_summary_path=str(work / "reports" / "embedding_diagnostics.json"),
    )
    config["logging"]["level"] = "WARNING"
    start = time.perf_counter()
    result = run_training(config, device=device)
    curve = [
        {
            "epoch": e,
            "train_loss": result.train_loss[e - 1],
            "val_recall@10": val.recall[10], "val_ndcg@10": val.ndcg[10],
            "test_recall@10": test.recall[10], "test_ndcg@10": test.ndcg[10],
        }
        for e, (val, test) in enumerate(zip(result.val_metrics, result.test_metrics), start=1)
    ]
    peak = max(curve, key=lambda row: row["val_recall@10"])
    return {
        "corpus_seed": seed, "users": result.num_users, "items": result.num_items,
        "epochs_run": len(curve), "peak_epoch": peak["epoch"],
        "peak_val_recall@10": peak["val_recall@10"], "peak_val_ndcg@10": peak["val_ndcg@10"],
        "best_epoch": result.best_epoch, "curve": curve,
        "ms_per_step": result.train_seconds / result.steps * 1e3,
        "examples_per_second": result.examples_per_second,
        "seconds": time.perf_counter() - start,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(REPO / "configs" / "in_batch_softmax.yaml"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 11, 23])
    ap.add_argument("--epochs", type=int, default=7)
    ap.add_argument("--dense-mimic", action="store_true",
                    help="the mimic tables on dense AdamW (adaptive_mimic.sparse: false)")
    ap.add_argument("--out", default=str(REPO / "artifacts" / "quality"),
                    help="where the JSON goes")
    ap.add_argument("--work", default=str(REPO / "build" / "quality"),
                    help="where the corpora and the runs' bundles go")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import yaml

    from ttamm_torch.data import CANONICAL_CORPUS, write_synthetic_csvs

    config = yaml.safe_load(Path(args.config).read_text())
    if args.dense_mimic:
        config["model"]["adaptive_mimic"]["sparse"] = False
    name = Path(args.config).stem + ("_dense_mimic" if args.dense_mimic else "")
    out, work = Path(args.out), Path(args.work)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in args.seeds:
        corpus = work / f"corpus{seed}"
        if not (corpus / "users.csv").is_file():
            write_synthetic_csvs(corpus, **dict(CANONICAL_CORPUS, seed=seed))
        row = _run(config, seed, corpus, work / f"{name}_seed{seed}", args.epochs, args.device)
        print(json.dumps(row), flush=True)
        rows.append(row)
    recall = np.array([r["peak_val_recall@10"] for r in rows])
    ndcg = np.array([r["peak_val_ndcg@10"] for r in rows])
    summary = {
        "config": name, "seeds": args.seeds, "epochs": args.epochs,
        "peak_val_recall@10_mean": float(recall.mean()),
        "peak_val_recall@10_spread": float((recall.max() - recall.min()) / 2),
        "peak_val_ndcg@10_mean": float(ndcg.mean()),
        "peak_epochs": [r["peak_epoch"] for r in rows],
    }
    (out / f"quality_{name}.json").write_text(json.dumps({"runs": rows, "summary": summary}, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
