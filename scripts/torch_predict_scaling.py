#!/usr/bin/env python
"""Weak-scaling prediction for the port on NVLink, from recorded collectives
(the counterpart of ``scripts/predict_scaling.py``).

A step's collectives are fixed by the code and the shapes, so CPU ranks
can record them exactly: for each mesh shape this script starts ``dp * mp``
gloo ranks on the CPU (its own launcher: torchrun's variables, one thread a
rank), runs one training step of each configuration under
``ttamm_torch.parallel.collective_inspect.record_collectives`` at the
configuration's widths (the batch per data shard, the negatives, D, the
MLP and gate widths, the mimic setting) and the corpus's feature width F
(``--features``, no default: it is the prepared data's, not the config's;
``ttamm_torch.data.CANONICAL_CORPUS`` prepared under configs/default.yaml
has 105; ``chip_smoke.py`` passes its corpus's), and
turns the record into wire bytes per device with the ring model
(all-gather and all-to-all move ``result * (n - 1) / n`` a device,
all-reduce twice that), then

    t_comm = wire_bytes_per_device / link_bandwidth
    predicted_efficiency = t1 / (t1 + t_comm)

with ``t1`` the one-card step time measured on the card (``--t1-ms``, no
default) and the link bandwidth of H100 SXM's NVLink 4 (450 GB/s a
direction; NVIDIA's data sheet gives 900 GB/s bidirectional). Bandwidth
only and no overlap of compute and communication, as the JAX script; it
leaves out NCCL's latency a collective, whose count each line gives.

The tables hold ``ROWS`` rows each instead of the corpus's: the step's
collectives and their bytes do not depend on table rows
(``tests/test_torch_port_collectives.py``, property (b)). Under the owner
routing a second step at capacity factor 1e-4 records the overflow
branch (the full-width fallback), listed apart and not counted as paid.

    python scripts/torch_predict_scaling.py --config configs/default.yaml \\
        --meshes 2x4,8x1 --t1-ms 3.43 --features 105

prints one JSON line for each (configuration, loss, mesh). Imports
``ttamm_torch`` and no ``jax``; needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

LINK_GBPS = 450.0
LINK_SOURCE = ("NVLink 4 of an H100 SXM: 900 GB/s bidirectional a GPU (NVIDIA H100 data sheet), "
               "450 GB/s a direction")
WALL_SECONDS = 900
ROWS = 8192  # rows of each table


def _cases(args) -> list[dict]:
    from ttamm_torch.utils.config import load_config

    if len(args.t1_ms) not in (1, len(args.config)):
        raise SystemExit("--t1-ms takes one value, or one for each --config")
    meshes = [tuple(int(x) for x in tok.lower().split("x")) for tok in args.meshes.split(",")]
    cases = []
    for i, path in enumerate(args.config):
        config = load_config(path)
        training = config.setdefault("training", {})
        mesh_cfg = config.setdefault("mesh", {}) or {}
        config["mesh"] = mesh_cfg
        for key, value in (("update_routing", args.update_routing), ("comm_dtype", args.comm_dtype)):
            if value is not None:
                training[key] = value
        if args.exchange is not None:
            mesh_cfg["embedding_exchange"] = args.exchange
        if args.tensor_parallel:
            mesh_cfg["tensor_parallel"] = True
        if args.mimic_sparse:
            config["model"].setdefault("adaptive_mimic", {})["sparse"] = True
        losses = ([training.get("loss", "bce")] if args.loss is None else
                  ["bce", "in_batch_softmax"] if args.loss == "both" else [args.loss])
        t1 = args.t1_ms[i if len(args.t1_ms) > 1 else 0]
        for loss in losses:
            for dp, mp in meshes:
                cases.append(dict(config=dict(config, training=dict(training, loss=loss)),
                                  path=str(path), dp=dp, mp=mp, features=args.features, t1_ms=t1))
    return cases


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


def _record_step(case: dict, capacity_factor: float | None = None) -> list:
    """One sharded step of ``case`` on its mesh under ``record_collectives``:
    this rank's record."""
    import numpy as np
    import torch

    from ttamm_torch.models.two_tower import parse_model_config
    from ttamm_torch.parallel import (
        MeshConfig, build_mesh, pad_batch_data, pad_state_rows, place_data, place_state,
    )
    from ttamm_torch.parallel.collective_inspect import record_collectives
    from ttamm_torch.parallel.step import make_sharded_train_step
    from ttamm_torch.pipelines.training import features_dtype, train_step_config
    from ttamm_torch.train import BatchData, create_train_state

    config, rows, f = case["config"], ROWS, case["features"]
    dp, mp = case["dp"], case["mp"]
    mesh = build_mesh(MeshConfig(dp, mp), "cpu")
    cfg = parse_model_config(config["model"], user_feature_dim=f, item_feature_dim=f)
    tscfg = train_step_config(config, num_items=rows, num_categories=64, total_steps=1000)
    if capacity_factor is not None:
        tscfg = tscfg._replace(update_capacity_factor=capacity_factor)
    tp = bool(config["mesh"].get("tensor_parallel", False))
    state = create_train_state(cfg, num_users=rows, num_items=rows, seed=0, device="cpu")
    state = place_state(mesh, pad_state_rows(state, mp), tensor_parallel=tp)
    rng = np.random.default_rng(0)
    feats = features_dtype(config.get("data", {}))
    data = place_data(mesh, pad_batch_data(BatchData(
        user_features=torch.from_numpy(rng.normal(0, 1, (rows, f)).astype(np.float32)).to(feats),
        item_features=torch.from_numpy(rng.normal(0, 1, (rows, f)).astype(np.float32)).to(feats),
        positive_rows=torch.from_numpy(rng.integers(0, rows, (rows, 8)).astype(np.int32)),
        category_ids=torch.from_numpy(rng.integers(0, 64, rows).astype(np.int32)),
        item_log_q=(torch.from_numpy(np.full(rows, -np.log(rows), np.float32))
                    if tscfg.loss_type == "in_batch_softmax" else None)), mp))
    batch = int(config["training"]["batch_size"]) * dp
    u, p = (torch.from_numpy(rng.integers(0, rows, batch).astype(np.int32)) for _ in range(2))
    step = make_sharded_train_step(cfg, tscfg, mesh)
    with record_collectives(mesh) as records:
        step(state, data, u, p, generator=torch.Generator().manual_seed(1))
    return [[c.op, c.axis, c.dtype, list(c.shape), c.branch, c.bytes, c.group_size] for c in records]


def _worker(spec_path: str) -> int:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", timeout=timedelta(seconds=WALL_SECONDS))
    rank = dist.get_rank()
    spec = json.loads(Path(spec_path).read_text())
    out = {}
    for i, case in enumerate(spec["cases"]):
        entry = {"records": _record_step(case)}
        if case["config"]["training"].get("update_routing") == "owner":
            entry["overflow"] = [r for r in _record_step(case, capacity_factor=1e-4)
                                 if r[4] == "overflow"]
        out[i] = entry
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(cases: list[dict], world: int, work: Path) -> list[dict]:
    """Run ``cases`` (all of one world size) on ``world`` gloo ranks; every
    rank's records."""
    spec = work / f"spec{world}.json"
    out = work / f"out{world}"
    out.mkdir()
    spec.write_text(json.dumps({"cases": cases, "out": str(out)}))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO_ROOT), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world), CUDA_VISIBLE_DEVICES="")
    logs = [work / f"rank{world}_{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker", str(spec)],
                cwd=REPO_ROOT, stdout=log, stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
    deadline = time.monotonic() + WALL_SECONDS
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise SystemExit(f"rank {r} of {world} exited {p.returncode}:\n"
                             f"{logs[r].read_text()[-4000:]}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def _tally(records: list, link_bytes_per_s: float) -> dict:
    from ttamm_torch.parallel.collective_inspect import wire_bytes_per_device

    per_op: dict[str, dict[str, dict]] = {}
    by_axis: dict[str, float] = {}
    wire_total = 0.0
    for op, axis, _, _, _, nbytes, group in records:
        wire = wire_bytes_per_device(op, nbytes, group)
        entry = per_op.setdefault(op, {}).setdefault(
            axis, {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        entry["count"] += 1
        entry["result_bytes"] += nbytes
        entry["wire_bytes"] += wire
        by_axis[axis] = by_axis.get(axis, 0.0) + wire
        wire_total += wire
    return {"collectives_per_step": len(records), "collectives": per_op,
            "wire_bytes_per_device": wire_total, "wire_bytes_by_axis": by_axis,
            "t_comm_ms": wire_total / link_bytes_per_s * 1e3}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", nargs="+", default=["configs/default.yaml"],
                        help="YAML configurations whose widths and options the steps take")
    parser.add_argument("--t1-ms", type=float, nargs="+",
                        help="one-card step ms measured on the card: one value, or one a --config")
    parser.add_argument("--meshes", default="2x4,8x1", help="comma list of DPxMP shapes")
    parser.add_argument("--loss", default=None, choices=("bce", "in_batch_softmax", "both"),
                        help="training.loss (default: the config's)")
    parser.add_argument("--exchange", default=None, choices=("gspmd", "alltoall"),
                        help="mesh.embedding_exchange (default: the config's)")
    parser.add_argument("--comm-dtype", default=None, choices=("float32", "bfloat16"),
                        help="training.comm_dtype (default: the config's)")
    parser.add_argument("--update-routing", default=None,
                        choices=("allgather", "owner", "owner_unchecked"),
                        help="training.update_routing (default: the config's)")
    parser.add_argument("--tensor-parallel", action="store_true",
                        help="mesh.tensor_parallel on (default: the config's)")
    parser.add_argument("--mimic-sparse", action="store_true",
                        help="adaptive_mimic.sparse on (default: the config's)")
    parser.add_argument("--features", type=int, default=None,
                        help="feature width F of the corpus the steps stand for (required: it is "
                        "the data's, not the config's)")
    parser.add_argument("--link-gbps", type=float, default=LINK_GBPS,
                        help="link bandwidth a direction, GB/s (default: H100 SXM NVLink 4)")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        sys.exit(_worker(args.worker))
    if not args.t1_ms:
        parser.error("--t1-ms is required: the one-card step time measured on the card")
    if args.features is None:
        parser.error("--features is required: the feature width of the prepared corpus "
                     "(its item_feature_matrix's columns)")

    cases = _cases(args)
    worlds = sorted({c["dp"] * c["mp"] for c in cases})
    link = args.link_gbps * 1e9
    with tempfile.TemporaryDirectory(prefix="torch_predict_scaling_") as tmp:
        for world in worlds:
            group = [c for c in cases if c["dp"] * c["mp"] == world]
            ranks = _launch(group, world, Path(tmp))
            for i, case in enumerate(group):
                got = ranks[0][str(i)]
                same = all([r[:5] for r in rank[str(i)]["records"]] ==
                           [r[:5] for r in got["records"]] for rank in ranks)
                paid = [r for r in got["records"] if r[4] is None]
                line = _tally(paid, link)
                t1 = case["t1_ms"]
                config, training = case["config"], case["config"]["training"]
                cfg_model = config["model"]
                tower = cfg_model["user_encoder"]
                overflow = None
                if "overflow" in got:
                    over = _tally(got["overflow"], link)
                    overflow = {"paid": False, "collectives": over["collectives_per_step"],
                                "wire_bytes_per_device": over["wire_bytes_per_device"],
                                "by_op": over["collectives"]}
                print(json.dumps({
                    "config": case["path"], "loss": training["loss"],
                    "exchange": config["mesh"].get("embedding_exchange", "gspmd"),
                    "comm_dtype": training.get("comm_dtype", "float32"),
                    "features_dtype": config.get("data", {}).get("features_dtype", "float32"),
                    "update_routing": training.get("update_routing", "allgather"),
                    "tensor_parallel": bool(config["mesh"].get("tensor_parallel", False)),
                    "mimic_sparse": bool(cfg_model.get("adaptive_mimic", {}).get("sparse", False)),
                    "mesh": f"{case['dp']}x{case['mp']}", "devices": world,
                    "batch_per_data_shard": int(training["batch_size"]),
                    "global_batch": int(training["batch_size"]) * case["dp"],
                    "widths": {"embedding_dim": tower["id_embedding"]["params"]["embedding_dim"],
                               "features": case["features"],
                               "hidden_dims": tower["feature_encoder"]["hidden_dims"],
                               "negatives": int(training.get("negatives_per_positive", 5))},
                    "reduced": f"tables of {ROWS} rows each (a step's collectives do not depend "
                               "on table rows); one step on gloo CPU ranks",
                    "ranks_agree": same,
                    **line,
                    "overflow_branch": overflow,
                    "t1_ms": t1, "link_gbps": args.link_gbps, "link": LINK_SOURCE,
                    "predicted_weak_scaling_efficiency": t1 / (t1 + line["t_comm_ms"]),
                    "model": "ring algorithms, bandwidth only, no compute/communication overlap; "
                             "leaves out NCCL's latency a collective (collectives_per_step of them)",
                }), flush=True)


if __name__ == "__main__":
    main()
