"""The readings a cell's comparison limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 1,2,3] [--fault 1,2,3]

For each seed of ``--seeds`` the program's numbers as a run compares them
(the lower readings); for each seed of ``--control`` the numbers of the
plain reference put in the program's place one precision below the
configuration's (TF32 for float32, float8 for bf16 scores; the upper
readings); for a training cell and each seed of ``--fault``, those of the
reference with half of each batch left out (the mean over the rest). One
set-up serves every seed of a training cell (the state is put back to each
seed's weights in place); a search cell draws each seed's catalogue anew.
Each reading is one JSON line on standard output. The benchmark's own runs
do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness, weights  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def train_readings(cell, seeds, control, fault, emit) -> None:
    from portbench.reference import compare
    from portbench.reference import train_step as reference

    first = (seeds or control or fault)[0]
    cell.seed = first
    cell.setup()
    for mode, group in (("program", seeds), ("control", control), ("fault_half_batch", fault)):
        for seed in group:
            cell.seed = seed
            cell.gen_seed = weights.stream_seed(seed, weights.STEPS)
            initial = cell._initial()
            batches = cell.reference_batches()
            ref = reference.run(cell.cfg, initial, cell.data, batches, cell.gen_seed)
            if mode == "program":
                cell._reset(initial)
                got = cell._first_steps(initial)
            elif mode == "control":
                got = reference.run(cell.cfg, initial, cell.data, batches, cell.gen_seed, tf32=True)
            else:
                half = [(u[: u.shape[0] // 2], p[: p.shape[0] // 2]) for u, p in batches]
                got = reference.run(cell.cfg, initial, cell.data, half, cell.gen_seed)
            emit(mode, seed, compare.train_numbers(got, ref))


def search_readings(cell, seeds, control, emit) -> None:
    from portbench.drivers.search_batches import catalogue
    from portbench.reference import search as reference

    for seed in sorted(set(seeds) | set(control)):
        cell.seed = seed
        cell.setup()
        count = int(cell.traffic["check_batches"])
        answers = [cell.search(cell.pool[j]) for j in range(count)]
        del cell.index
        torch.cuda.empty_cache()
        rows = catalogue(cell.items, cell.dim, seed, cell.dev)
        modes = (["program"] if seed in seeds else []) + (["control"] if seed in control else [])
        for mode in modes:
            worst: dict[str, float] = {}
            for j in range(count):
                if mode == "program":
                    scores, ids = answers[j]
                else:
                    scores, ids = reference.control_search(rows, cell.pool[j], cell.k, cell.dtype)
                for name, value in reference.numbers(rows, cell.pool[j], scores, ids, cell.k,
                                                     cell.dtype).items():
                    worst[name] = max(worst.get(name, 0.0), value)
            emit(mode, seed, worst)
        del rows
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control", type=_seeds, default=[])
    parser.add_argument("--fault", type=_seeds, default=[])
    args = parser.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell_def = {w["name"]: w for w in bench["workloads"]}[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell_def["config"]]["file"]).read_text())
    traffic = json.loads(harness._find(root, bench, "traffic", cell_def["traffic"], ".json").read_text())
    driver = harness._load_module(harness.HERE / "drivers" / f"{traffic['driver']}.py",
                                  f"portbench_driver_{traffic['driver']}")
    cell = driver.Cell(config, traffic, seed=0, device="cuda", cache=harness.HERE / ".cache")
    start = time.perf_counter()
    out = sys.stdout

    def emit(mode, seed, numbers):
        print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed, "numbers": numbers,
                          "t": round(time.perf_counter() - start, 1)}), file=out, flush=True)

    with contextlib.redirect_stdout(sys.stderr):
        if traffic["driver"] == "train_epochs":
            train_readings(cell, args.seeds, args.control, args.fault, emit)
        else:
            search_readings(cell, args.seeds, args.control, emit)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
