"""Fixtures of the harness's tests: a tiny copy of the benchmark's cells on
the CPU (the port's plain paths), built in a temporary root."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CORPUS = dict(num_users=600, num_items=400, num_interactions=12000, num_authors=5, seed=0)
TINY_ITEMS = 5000


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def tiny_root(root: Path, base: str = "pb") -> tuple[Path, dict]:
    """A root holding ``BENCHMARK.json`` whose one path ``base`` has every
    cell's configuration at a tiny corpus (batch 64), its mixes at 5,000
    items and 32 queries, the real layer readers and the real limits."""
    bench = benchmark()
    bench["paths"] = [base]
    for sub in ("configs", "traffic", "layers", "checks"):
        (root / base / sub).mkdir(parents=True, exist_ok=True)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["corpus"] = dict(TINY_CORPUS)
        cfg["config"]["data"]["min_item_interactions"] = 2
        cfg["config"]["training"]["batch_size"] = 64
        c["file"] = f"{base}/configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for path in (BENCH / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        if "items" in mix:
            mix.update(items=TINY_ITEMS, batch=32, traced_batches=3, query_batches=4, check_batches=3)
        (root / base / "traffic" / path.name).write_text(json.dumps(mix))
    for path in (BENCH / "layers").glob("*.py"):
        shutil.copy(path, root / base / "layers" / path.name)
    for path in (BENCH / "checks").glob("*.json"):
        shutil.copy(path, root / base / "checks" / path.name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


@pytest.fixture(scope="session")
def corpus_cache(tmp_path_factory) -> Path:
    return tmp_path_factory.mktemp("corpus_cache")


@pytest.fixture
def tiny(tmp_path) -> tuple[Path, dict]:
    return tiny_root(tmp_path)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where none is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
