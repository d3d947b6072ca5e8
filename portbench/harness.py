"""One run of one cell of the port's benchmark, driven by ``BENCHMARK.json``.

A cell names a configuration (``portbench/configs/<name>.json``) and a
traffic mix (``<path>/traffic/<mix>.json`` for a directory of the
benchmark's ``paths``); the mix names the driver that runs it
(``portbench/drivers/<driver>.py``). A per-layer metric is read by
``<path>/layers/<metric>.py`` (``read(trace) -> float | None``) and a cell's
comparison limits sit in ``<path>/checks/<cell>.json``. Adding a cell, a mix
or a metric adds files and entries; no file here changes.

A run: set-up (load or make the corpus, build the program's state, warm up
every shape the cell uses), then the measured window of ``--seconds``; with
``--trace 1`` a bounded part under the profiler after it, from which the
per-layer metrics are read; then the peak device memory, the program's
state freed, and the comparison with the plain reference. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the last key of the result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ttamm_tpu")
PORT = "ttamm_torch"


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _find(root: Path, bench: dict, sub: str, name: str, suffix: str) -> Path:
    for base in bench["paths"]:
        path = root / base / sub / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {sub}/{name}{suffix} under {bench['paths']}")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``ttamm_torch`` is not ``ttamm_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _device(device: str) -> dict:
    """The card's name and its peak memory so far (read once the window
    and the traced part have run, before the reference)."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed in its
    ``workloads``, or without that key in every cell (a per-layer metric:
    every cell that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def run_cell(root: Path, bench: dict, cell: dict, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None, cache: Path | None = None,
             out=None, err=None, patch=None) -> int:
    """One run of ``cell``; prints the result line to ``out`` and returns
    the exit code. ``patch(driver)``, if given, replaces parts of the
    driver's timed path before the run (the harness's tests break it)."""
    t0 = time.perf_counter() if t0 is None else t0
    out = out or sys.stdout
    err = err or sys.stderr
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(_find(root, bench, "traffic", cell["traffic"], ".json").read_text())
    driver = _load_module(HERE / "drivers" / f"{traffic['driver']}.py", f"portbench_driver_{traffic['driver']}")
    limits = json.loads(_find(root, bench, "checks", cell["name"], ".json").read_text())["limits"]
    e2e = [m for m in bench["end_to_end"] if applies(m, cell["name"])]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if applies(m, cell["name"], reported)]
    readers = {m["name"]: _load_module(_find(root, bench, "layers", m["name"], ".py"),
                                       "portbench_layer_" + re.sub(r"\W", "_", m["name"]))
               for m in layers} if trace else {}

    with contextlib.redirect_stdout(err):
        run = driver.Cell(config, traffic, seed=seed, device=device,
                          cache=cache or HERE / ".cache")
        if patch is not None:
            patch(run)
        print(f"set-up: process start to the cell's own set-up in {time.perf_counter() - t0:.3f} s", flush=True)
        run.setup()
        setup_s = time.perf_counter() - t0
        values, attempted, failed = run.window(seconds)
        traced = run.traced() if trace else None
        dev = _device(device)
        numbers = run.check()

    missing = sorted(set(limits) ^ set(numbers))
    if missing:
        raise RuntimeError(f"numbers without a limit or limits without a number: {missing}")
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits) \
        and all(math.isfinite(numbers[k]) for k in numbers)
    metrics = {}
    if trace:
        for m in layers:
            value = readers[m["name"]].read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else values[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev["count"] = int(cell["chips"])
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = float(traced.busy_s)
        dev["window_s"] = float(traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["checked"] = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=err)
        return 4
    for k in limits:
        print(f"checked {k} {float(numbers[k])!r} limit {float(limits[k])!r}", file=err)
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv: list[str], t0: float) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    # every build and kernel cache of the run inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(HERE / ".cache" / sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 3
    if not (root / PORT / "__init__.py").is_file():
        print(f"no {PORT}/ in {root}: run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import ttamm_torch

    if Path(ttamm_torch.__file__).resolve().parent != (root / PORT).resolve():
        print(f"{PORT} loads from {ttamm_torch.__file__}, not from {root}", file=sys.stderr)
        return 2
    return run_cell(root, bench, cell, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), t0=t0)
