"""Count fresh processes whose first square root on the CPU leaves the
float64 oracle: the check of PyTorch's CPU ``torch.sqrt`` (MKL's vector
math, VML) against the port's ``sparse_adam.sqrt_rn``.

Each child is a new interpreter that imports torch, sets its thread count
and makes its first call of the process, one of:

- ``torch.sqrt``: ``torch.sqrt`` of ``--n`` float32 values in [0.5, 1.5);
- ``sqrt_rn``: ``ttamm_torch.ops.sparse_adam.sqrt_rn`` of the same values;
- ``step``: one ``sparse_adam_update`` of the port on the CPU, the shapes of
  ``tests/test_torch_port_sparse_adam_rows.py``'s duplicates case (41 x 128
  table, a third of the lanes on one row, lr 0.01) with ``--lanes`` lanes,
  its table held to a float64 numpy oracle at rtol 1e-5, atol 1e-6.

A child is bad when an element is off: a square root more than 1e-6
relative from the correctly rounded one (one f32 ulp is at most 1.2e-7), or
a table element outside the tolerance. PyTorch splits the call into
2048-element chunks over its threads; a bad child prints which chunks.
``--warm`` first makes a one-thread call (16 values), so that the checked
call is not the process's first.
Run from the root of a checkout (``step`` and ``sqrt_rn`` import its
``ttamm_torch``); prints one JSON line.

    python scripts/torch_vml_first_call.py --op torch.sqrt --processes 160
    python scripts/torch_vml_first_call.py --op step --lanes 65536 --threads 64
    python scripts/torch_vml_first_call.py --op torch.sqrt --warm
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 2048  # PyTorch's grain for a VML call


def _child(op: str, n: int, lanes: int, threads: int, warm: bool) -> dict:
    import numpy as np
    import torch

    torch.set_num_threads(threads)
    if warm:  # the process's first VML call, on 16 values: one thread
        torch.sqrt(torch.ones(16))
    if op in ("torch.sqrt", "sqrt_rn"):
        x = np.random.default_rng(1).random(n, dtype=np.float32) + np.float32(0.5)
        if op == "torch.sqrt":
            got = torch.sqrt(torch.from_numpy(x)).numpy()
        else:
            sys.path.insert(0, ROOT)
            from ttamm_torch.ops.sparse_adam import sqrt_rn

            got = sqrt_rn(torch.from_numpy(x)).numpy()
        want = np.sqrt(x.astype(np.float64))
        rel = np.abs(got - want) / want
        off = rel > 1e-6
        return {"bad": bool(off.any()), "elements": int(off.sum()), "max_rel": float(rel.max()),
                "chunks": sorted({int(i) // CHUNK for i in np.nonzero(off)[0]})}
    sys.path.insert(0, ROOT)
    from ttamm_torch.ops.sparse_adam import init_sparse_adam, sparse_adam_update

    rows, d, lr = 40, 128, 0.01
    rng = np.random.default_rng(11)
    table = rng.standard_normal((rows + 1, d)).astype(np.float32)
    table[-1] = 0.0
    idx = rng.integers(0, rows, lanes).astype(np.int32)
    idx[: lanes // 3] = idx[0]
    g = rng.standard_normal((lanes, d)).astype(np.float32)
    t = torch.from_numpy(table.copy())
    sparse_adam_update(t, init_sparse_adam(t), torch.from_numpy(idx), torch.from_numpy(g), lr=lr)
    summed = np.zeros((rows + 1, d))
    np.add.at(summed, idx, g.astype(np.float64))
    touched = np.unique(idx)
    want = table.astype(np.float64)
    gr = summed[touched]
    b1, b2 = 0.9, 0.999  # step 1: m = (1 - b1) g, v = (1 - b2) g^2, bias-corrected
    m_hat, v_hat = (1 - b1) * gr / (1 - b1), (1 - b2) * gr * gr / (1 - b2)
    want[touched] -= lr * m_hat / (np.sqrt(v_hat) + 1e-8)
    off = ~np.isclose(t.numpy(), want, rtol=1e-5, atol=1e-6)
    return {"bad": bool(off.any()), "elements": int(off.sum()),
            "max_abs": float(np.abs(t.numpy() - want).max()),
            "rows": np.unique(np.nonzero(off)[0]).tolist()}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--op", choices=("torch.sqrt", "sqrt_rn", "step"), default="torch.sqrt")
    ap.add_argument("--processes", type=int, default=160)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--threads", type=int, default=32, help="torch threads in each child")
    ap.add_argument("--n", type=int, default=65536, help="values (sqrt ops)")
    ap.add_argument("--lanes", type=int, default=64, help="update lanes (step)")
    ap.add_argument("--warm", action="store_true",
                    help="make a one-thread torch.sqrt call first, then the checked one")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.op, args.n, args.lanes, args.threads, args.warm)))
        return
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--op", args.op, "--n",
           str(args.n), "--lanes", str(args.lanes), "--threads", str(args.threads)]
    cmd += ["--warm"] if args.warm else []

    def run(_):
        out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.parallel) as pool:
        results = list(pool.map(run, range(args.processes)))
    bad = [r for r in results if r["bad"]]
    print(json.dumps({"op": args.op, "threads": args.threads, "n": args.n, "lanes": args.lanes,
                      "warm": args.warm, "processes": len(results), "bad": len(bad),
                      "first_bad": bad[:3]}))


if __name__ == "__main__":
    main()
