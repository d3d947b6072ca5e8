"""Top-K from a TTFLAT index for a ``.npy`` of query vectors, with the
PyTorch port (the port of ``scripts/query.py``):

    python -m ttamm_torch.serve.query --index DIR/items.index --queries q.npy \\
        [--k 10] [--backend auto|device|native|numpy] [--score-dtype float32|bfloat16] \\
        [--device cuda|cpu]

Prints one line a query row, ``query {row}: id:score, ...`` with 4
decimals, as ``scripts/query.py`` does. ``--backend``: ``device`` (``auto``,
the default, is its alias) runs ``mips_topk`` on the CUDA card unless
``--device cpu`` asks for the CPU; ``native`` (the C++ searcher) and
``numpy`` search on the host, so they load the index on the CPU whatever
``--device`` says and need no card. ``--score-dtype`` overrides the device
search's precision stored in the index header.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .flat_index import FlatIndex


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Top-K retrieval queries (PyTorch port).")
    parser.add_argument("--index", type=Path, required=True, help="TTFLAT index path")
    parser.add_argument("--queries", type=Path, required=True, help=".npy query embedding matrix")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument(
        "--backend", choices=["auto", "device", "native", "numpy"], default="auto",
        help="the search: the device (auto), or on the host the C++ searcher or numpy",
    )
    parser.add_argument(
        "--score-dtype", choices=["float32", "bfloat16"], default=None,
        help="override the device search's precision stored in the index header",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (default) or cpu, for the device search; the host backends use the CPU",
    )
    args = parser.parse_args(argv)

    device = "cpu" if args.backend in ("native", "numpy") else args.device
    index = FlatIndex.load(args.index, device=device, score_dtype=args.score_dtype)
    scores, indices = index.search(np.load(args.queries), args.k, backend=args.backend)
    for row in range(indices.shape[0]):
        pairs = ", ".join(f"{int(i)}:{s:.4f}" for i, s in zip(indices[row], scores[row]))
        print(f"query {row}: {pairs}")


if __name__ == "__main__":
    main()
