"""Serve top-K recommendations from a serving bundle with the PyTorch port.

    python -m ttamm_torch.serve --artifacts DIR --user-id U1 --k 10
    python -m ttamm_torch.serve --artifacts DIR --http 8080 [--backend native]

Batch mode reads userIds from ``--user-id`` or stdin (one per line); with
``--http PORT`` it runs the HTTP front end (GET /healthz, GET/POST
/v1/recommend). ``--backend`` picks the search (``FlatIndex.search``):
``device`` (``auto``, the default, is its alias) on the CUDA card unless
``--device cpu`` asks for the CPU, ``native`` (the C++ searcher) or
``numpy`` on the host, which load the bundle on the CPU whatever
``--device`` says and need no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .http_server import serve_forever
from .service import RetrievalService


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Recommendation serving CLI (PyTorch port).")
    parser.add_argument("--artifacts", type=Path, default=Path("artifacts/faiss"))
    parser.add_argument("--user-id", action="append", default=None)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (default) or cpu, for the device search; the host backends use the CPU",
    )
    parser.add_argument(
        "--backend", choices=["auto", "device", "native", "numpy"], default="auto",
        help="the search: the device (auto), or on the host the C++ searcher or numpy",
    )
    parser.add_argument(
        "--score-dtype", choices=["float32", "bfloat16"], default=None,
        help="override the scoring precision stored in the index header",
    )
    parser.add_argument(
        "--http", type=int, default=None, metavar="PORT",
        help="run as an HTTP service on this port instead of batch mode",
    )
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args(argv)

    device = "cpu" if args.backend in ("native", "numpy") else args.device
    service = RetrievalService.from_artifacts(
        args.artifacts, device=device, score_dtype=args.score_dtype
    )
    if args.http is not None:
        print(f"serving on http://{args.host}:{args.http} "
              f"(backend={args.backend}, device={service.index.device})")
        serve_forever(service, args.host, args.http, backend=args.backend)
        return
    user_ids = args.user_id or [line.strip() for line in sys.stdin if line.strip()]
    for uid in user_ids:
        try:
            recs = service.recommend_for_user(uid, k=args.k, backend=args.backend)
        except KeyError as exc:
            print(f"{uid}\tERROR\t{exc}")
            continue
        formatted = ", ".join(f"{asin}:{score:.4f}" for asin, score in recs)
        print(f"{uid}\t{formatted}")


if __name__ == "__main__":
    main()
