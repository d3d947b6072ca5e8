"""Sweep the mesh update test's draws: each of
``tests/test_torch_port_parallel_mesh.py``'s six ``UPDATES`` cases on many
draws of its inputs, both sides held to the float64 oracle and to each other
at the test's own atol.

Draw ``k`` of a case is ``_update_inputs(f"{case}#{k}", ...)``, the test's
own helper (so its seed is the digest of that name). The JAX side runs here,
through the test's ``_jax_update`` with its jitted function built once a
case (bit for bit the helper's result, checked on the first draws). The
port side runs every draw in one launch of four gloo ranks, each rank
``tests/torch_parallel_worker.py``'s ``sparse_update`` task with one mesh a
shape. Prints one JSON object: for each case the draws, how many left the
oracle on each side and between the sides, and the largest distances; the
draws that left, each with the JAX side's distance from the oracle taken
with JAX's float32 bias corrections; and the distances at the test's own
draw of each case.

    python tests/torch_mesh_update_sweep.py --draws 1000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import zlib
from pathlib import Path

TESTS = Path(__file__).resolve().parent
KEYS = ("table", "m", "v")


def _rank(spec: str) -> int:
    """One gloo rank: the test worker, its mesh built once a shape."""
    sys.path.insert(0, str(TESTS))
    import torch_parallel_worker as worker

    meshes, build = {}, worker._mesh

    def cached(task):
        key = tuple(task["mesh"])
        if key not in meshes:
            meshes[key] = build(task)
        return meshes[key]

    worker._mesh = cached
    sys.argv = [worker.__file__, spec]
    return worker.main()


def _oracle_f32_bias(tm, x, jnp, step=3, b1=0.9, b2=0.999, eps=1e-8):
    """The test's float64 oracle with the JAX update's bias corrections,
    ``1 - b ** t`` in float32, in place of exact ones."""
    import numpy as np

    bc1, bc2 = (float(1.0 - jnp.power(b, jnp.float32(step))) for b in (b1, b2))
    table, m, v = (x[k].astype(np.float64) for k in KEYS)
    rows = np.unique(x["idx"])
    summed = np.zeros(table.shape)
    np.add.at(summed, x["idx"], x["grads"].astype(np.float64))
    gr = summed[rows]
    m[rows] = b1 * m[rows] + (1.0 - b1) * gr
    v[rows] = b2 * v[rows] + (1.0 - b2) * gr * gr
    table[rows] -= tm.LR * (m[rows] / bc1) / (np.sqrt(v[rows] / bc2) + eps)
    return {"table": table, "m": m, "v": v}


def _sweep(draws: int, work: Path) -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=8".strip()
    sys.path[:0] = [str(TESTS), str(TESTS.parent)]
    import jax
    import jax.numpy as jnp
    import numpy as np

    import test_torch_port_parallel_mesh as tm
    from torch_ranks import launch
    from ttamm_tpu.ops.sparse_adam import SparseAdamState
    from ttamm_tpu.parallel import MeshConfig, build_mesh
    from ttamm_tpu.parallel.sparse_update import sharded_sparse_adam_update

    fns = {}

    def jax_update(name, x):
        mesh_shape, routing, factor = tm.UPDATES[name][:3]
        if name not in fns:
            mesh = build_mesh(MeshConfig(*mesh_shape))
            fns[name] = jax.jit(lambda t, s, i, g: sharded_sparse_adam_update(
                mesh, t, s, i, g, lr=tm.LR, routing=routing, capacity_factor=factor,
                interpret=True))
        st = SparseAdamState(m=jnp.array(x["m"]), v=jnp.array(x["v"]),
                             step=jnp.asarray(2, jnp.int32))
        table, state = jax.block_until_ready(fns[name](
            jnp.array(x["table"]), st, jnp.array(x["idx"]), jnp.array(x["grads"])))
        return {"table": np.asarray(table), "m": np.asarray(state.m), "v": np.asarray(state.v)}

    cases, inputs, tasks = [], {}, []
    for k in range(-1, draws):  # -1: the test's own draw
        for name, (mesh, routing, factor, id_range, skew) in tm.UPDATES.items():
            draw = name if k < 0 else f"{name}#{k}"
            x = tm._update_inputs(draw, id_range, skew)
            want = jax_update(name, x)
            if k < 2:
                helper = tm._jax_update(mesh, routing, factor, x)
                assert all(np.array_equal(helper[a], want[a]) for a in KEYS), draw
            inputs.update({f"{draw}/{a}": b for a, b in x.items()})
            tasks.append(dict(kind="sparse_update", name=draw, mesh=mesh, routing=routing,
                              capacity_factor=factor, step=2, lr=tm.LR))
            cases.append((name, draw, x, want))
    np.savez(work / "inputs.npz", **inputs)
    spec = work / "spec.json"
    spec.write_text(json.dumps({"inputs": str(work / "inputs.npz"), "out": str(work),
                                "tasks": tasks}))
    launch(lambda r: [sys.executable, __file__, "--rank", str(spec)], tm.WORLD, work,
           120 + draws * 2.0)

    summary = {name: dict(draws=0, port_off=0, jax_off=0, port_jax_off=0, flags_off=0,
                          max_port=0.0, max_jax=0.0, max_port_jax=0.0) for name in tm.UPDATES}
    left, test_draws = [], {}
    for name, draw, x, want in cases:
        routing, skew = tm.UPDATES[name][1], tm.UPDATES[name][4]
        atol = 1e-6 if routing == "allgather" or skew else 1e-5  # the test's
        got = dict(np.load(work / f"{draw}.npz"))
        oracle = tm._oracle_update(x)
        dist = {side: max(float(np.abs(a[k] - b[k]).max()) for k in KEYS)
                for side, (a, b) in {"port": (got, oracle), "jax": (want, oracle),
                                     "port_jax": (got, want)}.items()}
        flags_off = int(got["step"]) != 3 or bool(got["overflow"]) != skew
        if draw == name:
            test_draws[name] = dict(dist, flags_off=flags_off, atol=atol)
            continue
        s = summary[name]
        s["atol"] = atol
        s["draws"] += 1
        s["flags_off"] += flags_off
        for side, d in dist.items():
            s[f"{side}_off"] += d > atol
            s[f"max_{side}"] = max(s[f"max_{side}"], d)
        if flags_off or max(dist.values()) > atol:
            f32 = _oracle_f32_bias(tm, x, jnp)
            left.append(dict(draw=draw, seed=zlib.crc32(draw.encode()), **dist,
                             jax_f32_bias=max(float(np.abs(want[k] - f32[k]).max()) for k in KEYS)))
    return {"draws_per_case": draws, "cases": summary, "left": left, "test_draws": test_draws}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=200, help="draws a case")
    ap.add_argument("--rank", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        return _rank(args.rank)
    with tempfile.TemporaryDirectory() as work:
        print(json.dumps(_sweep(args.draws, Path(work))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
