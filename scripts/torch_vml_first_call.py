"""Count fresh processes whose first CPU vector-math call leaves the
float64 oracle.

PyTorch's CPU build sends ``sqrt``, ``exp``, ``log``, ``tanh`` (and ``erf``,
``sin`` and the rest of MKL's vector math, VML) to MKL split over its
threads, at least 2048 elements a thread. When several threads make a
process's first VML call at once, one thread's part can come back at 12 to
15 correct bits. The port makes that first call itself, on one thread, when
``ttamm_torch.device`` is imported; this script checks both the race and
that repair.

Each child is a new interpreter that imports torch (with ``--port``, then
``ttamm_torch``, as every test and gloo rank does), sets its thread count
and makes one checked call, one of:

- ``torch.sqrt``, ``torch.exp``, ``torch.log``, ``torch.log1p``,
  ``torch.tanh``: the function on ``--n`` float32 values in the range the
  port calls it on (``_DOMAIN``): the update's second moments, the BCE
  loss's ``exp(-|x|)`` and its ``log1p``, the logQ mixture's log of a
  probability, a tower activation;
- ``torch._foreach_sqrt``: over four tensors of ``--n / 4`` values, as dense
  AdamW calls it (``ttamm_torch/train/optim.py``);
- ``torch.sigmoid``, ``gelu_tanh`` (``F.gelu(approximate="tanh")``),
  ``log_softmax`` (rows of 64), ``normalize`` (``F.normalize`` of rows of
  64): the port's other transcendental calls, which PyTorch computes with its
  own vector code, not VML;
- ``sqrt_rn``: ``ttamm_torch.ops.sparse_adam.sqrt_rn`` of the square
  roots' values;
- ``step``: one ``sparse_adam_update`` of the port on the CPU, the shapes of
  ``tests/test_torch_port_sparse_adam_rows.py``'s duplicates case (41 x 128
  table, a third of the lanes on one row, lr 0.01) with ``--lanes`` lanes,
  its table held to a float64 numpy oracle at rtol 1e-5, atol 1e-6.

A child is bad when an element is off: more than 1e-6 relative from the
float64 value (one f32 ulp is at most 1.2e-7), or a table element outside
the tolerance. A bad child says which 2048-element chunks hold them.
``--warm`` first makes a one-thread call (16 values of ``torch.sqrt``), so
that the checked call is not the process's first. Run from the root of a checkout
(``--port``, ``step`` and ``sqrt_rn`` import its ``ttamm_torch``); prints
one JSON line an op.

    python scripts/torch_vml_first_call.py --op torch.exp torch.tanh --processes 320 --threads 64
    python scripts/torch_vml_first_call.py --op torch.exp --port --threads 8
    python scripts/torch_vml_first_call.py --op step --lanes 65536 --threads 64
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 2048  # PyTorch's grain for a VML call
# the checked call's inputs: uniform in [lo, hi)
_DOMAIN = {"torch.sqrt": (0.5, 1.5), "torch._foreach_sqrt": (0.5, 1.5), "sqrt_rn": (0.5, 1.5),
           "torch.exp": (-8.0, 0.0), "torch.log": (0.01, 0.5), "torch.log1p": (0.0, 1.0),
           "torch.tanh": (-3.0, 3.0), "torch.sigmoid": (-6.0, 6.0), "gelu_tanh": (0.5, 3.0),
           "log_softmax": (-4.0, 4.0), "normalize": (0.5, 1.5)}
OPS = (*_DOMAIN, "step")


def _checked(op: str, x):
    """``(port's f32 result, float64 value)`` of ``op`` on ``x``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    t, d = torch.from_numpy(x), x.astype(np.float64)
    if op == "torch._foreach_sqrt":
        got = torch.cat(torch._foreach_sqrt(list(t.chunk(4)))).numpy()
        return got, np.sqrt(d)
    if op == "sqrt_rn":
        from ttamm_torch.ops.sparse_adam import sqrt_rn

        return sqrt_rn(t).numpy(), np.sqrt(d)
    if op == "gelu_tanh":
        want = 0.5 * d * (1 + np.tanh(np.sqrt(2 / np.pi) * (d + 0.044715 * d**3)))
        return F.gelu(t, approximate="tanh").numpy(), want
    if op == "log_softmax":
        rows = d.reshape(-1, 64)
        want = rows - rows.max(1, keepdims=True)
        want = want - np.log(np.exp(want).sum(1, keepdims=True))
        return torch.log_softmax(t.reshape(-1, 64), -1).numpy().ravel(), want.ravel()
    if op == "normalize":
        rows = d.reshape(-1, 64)
        want = rows / np.sqrt((rows * rows).sum(1, keepdims=True))
        return F.normalize(t.reshape(-1, 64), dim=-1).numpy().ravel(), want.ravel()
    if op == "torch.sigmoid":
        return torch.sigmoid(t).numpy(), 1 / (1 + np.exp(-d))
    fn = op.split(".")[1]
    return getattr(torch, fn)(t).numpy(), getattr(np, fn)(d)


def _child(op: str, n: int, lanes: int, threads: int, warm: bool, port: bool) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    if port:
        import ttamm_torch  # noqa: F401  (its device module makes the first VML call)
    torch.set_num_threads(threads)
    if warm:  # the process's first VML call, on 16 values: one thread
        torch.sqrt(torch.ones(16))
    if op != "step":
        lo, hi = _DOMAIN[op]
        x = (np.random.default_rng(1).random(n) * (hi - lo) + lo).astype(np.float32)
        got, want = _checked(op, x)
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        off = rel > 1e-6
        return {"bad": bool(off.any()), "elements": int(off.sum()), "max_rel": float(rel.max()),
                "chunks": sorted({int(i) // CHUNK for i in np.nonzero(off)[0]})}
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


def _versions() -> dict:
    import torch

    mkl = [line.strip(" -") for line in torch.__config__.show().splitlines()
           if "Math Kernel" in line]
    cpu = platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            names = [line.split(":", 1)[1].strip() for line in f if line.startswith("model name")]
        cpu = names[0] if names else cpu
    return {"cores": os.cpu_count(), "cpu": cpu, "torch": torch.__version__,
            "mkl": mkl[0] if mkl else None}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--op", nargs="+", choices=OPS, default=["torch.sqrt"])
    ap.add_argument("--processes", type=int, default=160, help="fresh processes an op")
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--threads", type=int, default=32, help="torch threads in each child")
    ap.add_argument("--n", type=int, default=65536, help="values (every op but step)")
    ap.add_argument("--lanes", type=int, default=64, help="update lanes (step)")
    ap.add_argument("--warm", action="store_true",
                    help="make a one-thread torch.sqrt call first, then the checked one")
    ap.add_argument("--port", action="store_true",
                    help="import ttamm_torch before setting the threads and the checked call")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.op[0], args.n, args.lanes, args.threads, args.warm,
                                args.port)))
        return
    versions = _versions()
    for op in args.op:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", "--op", op, "--n",
               str(args.n), "--lanes", str(args.lanes), "--threads", str(args.threads)]
        cmd += ["--warm"] * args.warm + ["--port"] * args.port

        def run(_):
            out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
            return json.loads(out.strip().splitlines()[-1])

        with ThreadPoolExecutor(args.parallel) as pool:
            results = list(pool.map(run, range(args.processes)))
        bad = [r for r in results if r["bad"]]
        print(json.dumps({"op": op, "threads": args.threads, "n": args.n, "lanes": args.lanes,
                          "warm": args.warm, "port": args.port, "processes": len(results),
                          "bad": len(bad), "first_bad": bad[:3], **versions}), flush=True)


if __name__ == "__main__":
    main()
