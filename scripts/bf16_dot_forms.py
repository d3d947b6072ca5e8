#!/usr/bin/env python3
"""The two ways to write the forward of ``model.precision: bfloat16``'s
matmul (``ttamm_torch.models.encoders.bf16_dot``, the JAX ``_dot``: bf16
operands, float32 sums and output), measured on the card:

- ``widened``: the float32 product of the operands rounded to bf16 and
  widened back (a full float32 GEMM, TF32 off);
- ``out_dtype``: one bf16 GEMM with float32 output,
  ``torch.mm(x16, w16.T, out_dtype=torch.float32)``.

A product of two bf16 values is exact in float32, so both equal the JAX
``_dot`` up to the order of the sums. ``bf16_dot`` launches ``out_dtype``
on the card, which this script found the faster. On the canonical corpus and
``configs/default.yaml`` with ``model.precision: bfloat16``, the script
records the shape of every ``bf16_dot`` call of one train step, times
each form's forward at each shape (``torch.profiler`` device ms) with the
largest difference between the two, then times whole train steps with the
forward swapped in, in the order widened, out_dtype, out_dtype, widened.
Prints one JSON line last.

Needs one NVIDIA Hopper card; run from the root of a checkout:

    python3 scripts/bf16_dot_forms.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402

STEPS = 20  # train steps a timed turn


def widened(x16, w16):
    return x16.float() @ w16.float().T


def out_dtype(x16, w16):
    import torch

    return torch.mm(x16, w16.T, out_dtype=torch.float32)


FORMS = {"widened": widened, "out_dtype": out_dtype}


def main() -> int:
    import numpy as np
    import torch

    from ttamm_torch.device import resolve_device
    from ttamm_torch.models import encoders
    from ttamm_torch.train import create_train_state, make_train_step

    dev = resolve_device("cuda")
    shipped = encoders._Bf16Dot.forward
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="bf16_forms_") as tmp:
        config, dataset = smoke.phase_corpus(Path(tmp))
    config["model"]["precision"] = "bfloat16"
    ctx = smoke._step_inputs(dev, config, dataset)
    cfg, tscfg, data, nu, ni, b = (ctx[k] for k in ("cfg", "tscfg", "data", "nu", "ni", "batch"))
    state = create_train_state(cfg, num_users=nu, num_items=ni, seed=smoke.STEP_SEED, device=dev)
    step = make_train_step(cfg, tscfg)
    users = torch.from_numpy(ctx["users"]).to(dev)
    items = torch.from_numpy(ctx["items"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    shapes = []
    call = encoders.bf16_dot
    encoders.bf16_dot = lambda x, w, *rest: shapes.append((tuple(x.shape), tuple(w.shape))) or call(x, w, *rest)
    try:
        step(state, data, users[:b], items[:b], generator=gen)
    finally:
        encoders.bf16_dot = call
    torch.cuda.synchronize()

    per_shape = []
    for (n, k), (out, _) in sorted(set(shapes)):
        g = torch.Generator(device=dev).manual_seed(n * 31 + k)
        x16 = torch.randn((n, k), generator=g, device=dev).to(torch.bfloat16)
        w16 = (torch.randn((out, k), generator=g, device=dev) / k**0.5).to(torch.bfloat16)
        a, c = widened(x16, w16), out_dtype(x16, w16)
        row = {"x": [n, k], "weight": [out, k], "calls_per_step": shapes.count(((n, k), (out, k))),
               "max_abs_diff": float((a - c).abs().max()), "max_abs": float(a.abs().max())}
        for name, fn in FORMS.items():
            row[f"{name}_ms"] = smoke.device_ms(lambda fn=fn: fn(x16, w16), iters=50, warmup=5)
        smoke.log(f"x [{n}, {k}] @ weight [{out}, {k}]ᵀ x{row['calls_per_step']} a step: widened "
                  f"{row['widened_ms']:.4f} ms | out_dtype {row['out_dtype_ms']:.4f} ms | max abs diff "
                  f"{row['max_abs_diff']:.3e} of max |y| {row['max_abs']:.3e}")
        per_shape.append(row)

    def forward_with(fn):
        def forward(ctx_, x, weight, reduce_dx=None):
            x16, w16 = x.to(torch.bfloat16), weight.to(torch.bfloat16)
            ctx_.save_for_backward(x16, w16)
            ctx_.reduce_dx = reduce_dx
            return fn(x16, w16)
        return staticmethod(forward)

    turns = []
    rng = np.random.default_rng(9)
    try:
        for name in ("widened", "out_dtype", "out_dtype", "widened"):
            encoders._Bf16Dot.forward = forward_with(FORMS[name])
            pick = rng.integers(0, len(ctx["users"]) - b, STEPS + 2).tolist()
            it = iter(pick)

            def one():
                s = next(it)
                step(state, data, users[s : s + b], items[s : s + b], generator=gen)

            ms = smoke.device_ms(one, iters=STEPS, warmup=2)
            turns.append({"form": name, "device_ms_per_step": ms})
            smoke.log(f"train step with the {name} forward: {ms:.4f} device ms a step")
    finally:
        encoders._Bf16Dot.forward = staticmethod(shipped)
    smoke.log(smoke.nvidia_smi())
    print(json.dumps({"per_shape": per_shape, "steps": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
