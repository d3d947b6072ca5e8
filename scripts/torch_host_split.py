"""Untraced host split of one benchmark cell: the port's spans
(``ttamm_torch/utils/trace.py``) timed on the host clock, with no profiler
running.

Under ``torch.profiler`` every aten op under a span pays its recording, so
the spans' traced durations grow with the ops a stage issues (a numpy stage
hardly grows, a launch-heavy one does). Here ``trace.span`` is replaced by a
timer (two ``perf_counter_ns`` reads and a few adds, under a microsecond a
span), the cell is built by its benchmark driver (``portbench/drivers/``),
and the driver's own timed path runs with the timers, then without them:
``--calls`` searches of the query pool in turn, or whole epochs for
``--seconds``. Prints one JSON line: for each span, its count, its summed
``n``, its mean ms and its mean self ms (less its direct children), and the
wall time a search or an example with and without the timers.

Run from the root of a checkout, with one card visible (``--device cpu``
runs the port's plain paths, for a check at a tiny size):

    python3 scripts/torch_host_split.py --workload in_batch_softmax.search_2m_bf16 --seed 7
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


class _Timer:
    """A span timed on the host clock: ``totals[name]`` gains its count,
    its ``n``, its ns and its self ns."""

    __slots__ = ("name", "n", "start", "inner")
    open: list = []
    totals: dict = {}

    def __init__(self, name: str, n: int):
        self.name, self.n = name, n

    def __enter__(self):
        self.inner = 0
        _Timer.open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self.start
        _Timer.open.pop()
        if _Timer.open:
            _Timer.open[-1].inner += ns
        row = _Timer.totals.setdefault(self.name, [0, 0, 0, 0])
        row[0] += 1
        row[1] += self.n
        row[2] += ns
        row[3] += ns - self.inner
        return False


def _cell(name: str, seed: int, device: str):
    """The cell's driver, built as ``portbench/harness.py`` builds it from
    the ``BENCHMARK.json`` of the working directory."""
    from portbench import harness

    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    config = json.loads((root / {c["name"]: c for c in bench["configs"]}[cell["config"]]["file"]).read_text())
    traffic = json.loads(harness._find(root, bench, "traffic", cell["traffic"], ".json").read_text())
    path = harness.HERE / "drivers" / f"{traffic['driver']}.py"
    spec = importlib.util.spec_from_file_location(f"driver_{traffic['driver']}", path)
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    return driver.Cell(config, traffic, seed=seed, device=device, cache=harness.HERE / ".cache"), traffic


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--calls", type=int, default=1000, help="searches a turn (search cells)")
    parser.add_argument("--seconds", type=float, default=8.0, help="a turn's epochs (train cells)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from ttamm_torch.utils import trace

    run, traffic = _cell(args.workload, args.seed, args.device)
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    run.setup()
    untimed = trace.span

    def turn(timed: bool) -> float:
        """Wall seconds a search or an example of one turn."""
        trace.span = (lambda name, n=1: _Timer(trace.PREFIX + name, n)) if timed else untimed
        try:
            sync()
            if traffic["driver"] == "search_batches":
                start = time.perf_counter()
                for i in range(args.calls):
                    run.search(run.pool[i % len(run.pool)])
                return (time.perf_counter() - start) / args.calls
            rate = run.window(args.seconds)[0]["train_examples_per_s"]
            return 1.0 / rate
        finally:
            trace.span = untimed

    walls = {"off": [], "timed": []}
    for timed in (False, True, True, False):
        if timed:
            _Timer.totals.clear()  # the last timed turn's split is kept
        walls["timed" if timed else "off"].append(turn(timed) * 1e3)
    unit = "ms_per_search" if traffic["driver"] == "search_batches" else "ms_per_example"
    spans = {k: {"count": c, "n": n, "mean_ms": ns / c / 1e6, "mean_self_ms": own / c / 1e6}
             for k, (c, n, ns, own) in sorted(_Timer.totals.items())}
    card = torch.cuda.get_device_name() if args.device == "cuda" else "cpu"
    print("SPLIT", json.dumps({"workload": args.workload, "card": card,
                               unit: walls, "spans": spans}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
