"""Driver of the search mixes: one client calling ``FlatIndex.search`` in a
closed loop.

The mix file gives the catalogue (``items`` rows of the configuration's
embedding width, unit rows: the cosine index), the score dtype, the batch
of queries and ``k``, the pool of query batches the client cycles through
(``query_batches``), how many answered batches the check compares
(``check_batches``, a sample drawn from the seed over the whole window) and
how many searches the traced part holds (``traced_batches``).

Set-up draws the catalogue on the card from the seed (one normal draw,
each row normalised), copies it to the host and builds the program's index
from it (``FlatIndex``, which uploads it in its scoring dtype), draws the
query pool, and warms the search with two calls. The window sends the next
batch when the last one's ids and scores are on the host.

``search_queries_per_s``: every query answered in the window over the
window's wall time. ``search_p95_ms``: the 95th percentile over the
window's batches of the time from a batch's send (its due time, in a
closed loop) to its answer on the host.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from portbench import device_trace, weights
from portbench.device_trace import span
from portbench.reference import search as reference

ROW_CHUNK = 1 << 20


def _lap(what: str, since: float) -> float:
    now = time.perf_counter()
    print(f"set-up: {what} in {now - since:.3f} s", flush=True)
    return now


def catalogue(items: int, dim: int, seed: int, device) -> torch.Tensor:
    """float32 ``[items, dim]`` unit rows on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(weights.stream_seed(seed, weights.CATALOGUE))
    rows = torch.randn(items, dim, generator=gen, device=device)
    for start in range(0, items, ROW_CHUNK):
        part = rows[start : start + ROW_CHUNK]
        part /= torch.linalg.vector_norm(part, dim=1, keepdim=True).clamp_min(1e-12)
    return rows


class Cell:
    def __init__(self, config: dict, traffic: dict, *, seed: int, device: str, cache: Path):
        self.config, self.traffic, self.seed = config, traffic, seed
        model = config["config"]["model"]
        self.dim = int(model["item_encoder"].get("output_dim")
                       or model["item_encoder"]["id_embedding"]["params"]["embedding_dim"])
        self.items = int(traffic["items"])
        self.dtype = str(traffic["score_dtype"])
        self.batch, self.k = int(traffic["batch"]), int(traffic["k"])
        self.dev = torch.device(device)

    def setup(self) -> None:
        from ttamm_torch.serve.flat_index import FlatIndex

        tick = time.perf_counter()
        rows = catalogue(self.items, self.dim, self.seed, self.dev)
        host = rows.cpu().numpy()
        del rows
        tick = _lap("catalogue drawn and copied to the host", tick)
        self.index = FlatIndex(embeddings=host, normalized=True, score_dtype=self.dtype, device=self.dev)
        tick = _lap("index built", tick)
        gen = torch.Generator(device=self.dev).manual_seed(weights.stream_seed(self.seed, weights.QUERIES))
        pool = torch.randn(int(self.traffic["query_batches"]), self.batch, self.dim, generator=gen,
                           device=self.dev)
        pool /= torch.linalg.vector_norm(pool, dim=2, keepdim=True).clamp_min(1e-12)
        self.pool = pool.cpu().numpy()
        for q in self.pool[:2]:
            self.search(q)
        _lap("queries drawn, two warm searches", tick)

    def search(self, queries: np.ndarray):
        with span("flat_index.search"):
            return self.index.search(queries, self.k, backend="device", algorithm="auto")

    def window(self, seconds: float):
        rng = np.random.default_rng(weights.stream_seed(self.seed, weights.SAMPLE))
        keep = int(self.traffic["check_batches"])
        self.kept: list[tuple[int, np.ndarray, np.ndarray]] = []
        latencies = []
        failed = 0
        start = time.perf_counter()
        i = 0
        while True:
            j = i % len(self.pool)
            sent = time.perf_counter()
            scores, ids = self.search(self.pool[j])
            done = time.perf_counter()
            latencies.append(done - sent)
            if scores.shape != (self.batch, self.k) or ids.shape != (self.batch, self.k):
                failed += self.batch
            # a uniform sample of the window's answers (reservoir)
            if len(self.kept) < keep:
                self.kept.append((j, scores, ids))
            else:
                slot = int(rng.integers(0, i + 1))
                if slot < keep:
                    self.kept[slot] = (j, scores, ids)
            i += 1
            if done - start >= seconds:
                break
        elapsed = done - start
        p95 = float(np.quantile(np.asarray(latencies), 0.95)) * 1e3
        return {"search_queries_per_s": i * self.batch / elapsed, "search_p95_ms": p95}, \
            i * self.batch, failed

    def traced(self) -> device_trace.Trace:
        count = int(self.traffic["traced_batches"])

        def body():
            with device_trace.body_span():
                for i in range(count):
                    self.search(self.pool[i % len(self.pool)])
                if self.dev.type == "cuda":
                    torch.cuda.synchronize()

        trace = device_trace.traced(lambda: self.search(self.pool[0]), body, count, self.dev.type)
        trace.info = {"kind": "search", "batch": self.batch, "items": self.items, "dim": self.dim,
                      "dtype": self.dtype}
        return trace

    def check(self) -> dict[str, float]:
        """The sampled answers against the float64 exact search, after the
        program's index is freed."""
        del self.index
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        rows = catalogue(self.items, self.dim, self.seed, self.dev)
        worst: dict[str, float] = {}
        for j, scores, ids in self.kept:
            for name, value in reference.numbers(rows, self.pool[j], scores, ids, self.k, self.dtype).items():
                worst[name] = max(worst.get(name, 0.0), value)
        return worst
