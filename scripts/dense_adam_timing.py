#!/usr/bin/env python3
"""The dense Adam / AdamW update at ``default.train``'s dense-target list
(``configs/default.yaml``: the towers' 16 tensors and the dense mimic tables
user_aug [199450, 128] and item_aug [99881, 128], AdamW, weight decay 0.01),
timed three ways: the kernel (``kernels.dense_adam_cuda``,
``csrc/dense_adam.cu``), the ``torch._foreach_*`` composition it replaces
(``kernels.dense_adam_plain`` on the card) and, as a yardstick the port
never calls, ``torch.optim.AdamW(fused=True)``.

For each, seven turns of ``CALLS`` back-to-back updates under
``torch.profiler`` (the three in turns, the order reversed every other
turn): the device ms of an update (every kernel it launched, summed) and its
kernels' names and counts; then the median and the spread (min, max) of the
seven turns, and CUDA-event ms of the same calls. The bound: each element's
parameter, gradient, m and v read once and its parameter, m and v written
once, 28 bytes, at 3.35 TB/s. Before the timing, one update of each of
AdamW with decay, AdamW without and Adam with L2 decay at steps 1, 2 and
1,000 is checked bit for bit against the composition at these shapes.

``--probe``: how the ``_foreach_`` kernels of PyTorch on this card round
the three ops in which an FMA could form (``_foreach_add_`` with alpha,
``_foreach_addcmul_``, Adam's ``_foreach_add`` of the decay) and the
division by a 0-d tensor, element by element against each candidate (an
FMA or two roundings; an IEEE division or a multiply by the reciprocal),
computed in float64 on the same values. The kernel's intrinsics follow the
candidate that matches every element.

Needs one NVIDIA Hopper card and nvcc; run from the root of a checkout:

    python3 scripts/dense_adam_timing.py [--probe]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402

USERS, ITEMS, FEATURES = 199_450, 99_881, 105  # the canonical corpus's mimic tables' rows
CALLS = 20  # updates a turn
TURNS = 7
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8)


def dense_list(dev):
    """(params, grads, m, v) at default.train's dense targets, seeded."""
    import torch
    import yaml

    from ttamm_torch.models import parse_model_config
    from ttamm_torch.train import create_train_state

    cfg = yaml.safe_load((REPO / "configs" / "default.yaml").read_text())
    model = parse_model_config(cfg["model"], user_feature_dim=FEATURES, item_feature_dim=FEATURES)
    state = create_train_state(model, num_users=USERS, num_items=ITEMS, seed=0, device="cpu")
    shapes = [tuple(t.shape) for _, t in state.dense_targets()]
    del state
    gen = torch.Generator(device=dev).manual_seed(5)
    params = [torch.randn(s, generator=gen, device=dev) * 0.02 for s in shapes]
    grads = [torch.randn(s, generator=gen, device=dev) * 1e-4 for s in shapes]
    m = [torch.randn(s, generator=gen, device=dev) * 1e-5 for s in shapes]
    v = [torch.rand(s, generator=gen, device=dev) * 1e-8 for s in shapes]
    return shapes, params, grads, m, v


def check_bits(dev, lists) -> list[str]:
    """The kernel against the composition at these shapes: one line a case."""
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.train.optim import DenseOptConfig, dense_scalars

    lines = []
    for name, wd in (("adamw", 0.01), ("adamw", 0.0), ("adam", 0.01)):
        for step in (1, 2, 1000):
            cfg = DenseOptConfig(name=name, lr=1e-3, weight_decay=wd)
            scalars = torch.from_numpy(dense_scalars(cfg, step)).to(dev)
            outs = []
            for fn in (kernels.dense_adam_cuda, kernels.dense_adam_plain):
                params, grads, m, v = ([t.clone() for t in ts] for ts in lists)
                fn(params, grads, m, v, scalars=scalars, weight_decay=wd,
                   decoupled=name == "adamw", **HYPER)
                outs.append((params, m, v))
            off = sum(int((a != b).sum()) for got, want in zip(*outs) for a, b in zip(got, want))
            lines.append(f"{name} wd {wd} step {step}: {off} elements differ")
            if off:
                raise SystemExit("dense_adam differs from the composition: " + lines[-1])
            del outs
    return lines


def turn(fn, calls: int) -> tuple[float, float, dict[str, int]]:
    """(profiler device ms a call, CUDA-event ms a call, kernel launches a
    call by the first 80 characters of their names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU and e.count]
    device_ms = smoke._device_us(events) / calls / 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    counts = {}
    for e in events:  # the composition's kernels share their first 80 characters
        counts[e.key[:80]] = counts.get(e.key[:80], 0) + e.count / calls
    return device_ms, start.elapsed_time(end) / calls, counts


def _off(got, want) -> int:
    return int((got != want).sum())


def probe(dev) -> dict:
    """Mismatching elements of each _foreach_ op against each way it may round."""
    import numpy as np
    import torch

    f32 = np.float32
    gen = torch.Generator(device=dev).manual_seed(9)
    n = 1 << 22
    a = torch.randn(n, generator=gen, device=dev) * 1e-3
    b = torch.randn(n, generator=gen, device=dev) * 1e-2
    c = torch.rand(n, generator=gen, device=dev) * 1e-6

    def fma(x, y, z):  # x * y is exact in double for f32 operands; one double rounding
        return (x.double() * y.double() + z.double()).float()

    def two(x, y, z):
        return (z.double() + (x.double() * y.double()).float().double()).float()

    out = {}
    alpha = float(f32(1.0 - 0.9))
    got = torch._foreach_add([a.clone()], [b], alpha=1.0 - 0.9)[0]
    ta = torch.full_like(a, alpha)
    out["m + (1 - b1) * g"] = {"fma": _off(got, fma(ta, b, a)), "two roundings": _off(got, two(ta, b, a))}
    value = float(f32(1.0 - 0.999))
    got = torch._foreach_addcmul([c.clone()], [b], [b], value=1.0 - 0.999)[0]
    gg, tv = b * b, torch.full_like(c, value)
    out["v + (1 - b2) * g * g"] = {"fma": _off(got, fma(tv, gg, c)), "two roundings": _off(got, two(tv, gg, c))}
    wd = float(f32(0.01))
    p = torch.randn(n, generator=gen, device=dev)
    got = torch._foreach_add([b], [p], alpha=0.01)[0]
    tw = torch.full_like(p, wd)
    out["g + wd * p"] = {"fma": _off(got, fma(tw, p, b)), "two roundings": _off(got, two(tw, p, b))}
    for step in (1, 2, 1000):
        bc2 = torch.tensor(float(f32(1.0 - 0.999**step)), device=dev)
        got = torch._foreach_div([c], bc2)[0]
        out[f"v / bc2 (step {step})"] = {
            "IEEE": _off(got, (c.double() / bc2.double()).float()),
            "times f32 reciprocal": _off(got, c * (1.0 / bc2)),
        }
    return out


def main() -> int:
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.train.optim import DenseOptConfig, dense_scalars

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--probe", action="store_true", help="only the rounding probe")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("dense_adam_timing: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smoke.nvidia_smi()} | torch {torch.__version__}"
    print(card, flush=True)
    if args.probe:
        result = probe(dev)
        for op, cands in result.items():
            print(f"{op}: " + "; ".join(f"{k} {v} off" for k, v in cands.items()), flush=True)
        print(json.dumps({"card": card, "probe": result}))
        return 0
    shapes, *lists = dense_list(dev)
    elements = sum(int(torch.Size(s).numel()) for s in shapes)
    bound = smoke.bound_ms(28 * elements)[0]
    print(f"{len(shapes)} tensors, {elements} elements; bound {bound:.4f} ms", flush=True)
    for line in check_bits(dev, lists):
        print(line, flush=True)
    cfg = DenseOptConfig(name="adamw", lr=1e-3, weight_decay=0.01)
    scalars = torch.from_numpy(dense_scalars(cfg, 3)).to(dev)
    params, grads, m, v = lists
    kw = dict(scalars=scalars, weight_decay=0.01, decoupled=True, **HYPER)
    leaves = [p.clone().requires_grad_() for p in params]
    for leaf, g in zip(leaves, grads):
        leaf.grad = g.clone()
    fused = torch.optim.AdamW(leaves, lr=1e-3, weight_decay=0.01, fused=True)
    methods = {
        "kernel": lambda: kernels.dense_adam_cuda(params, grads, m, v, **kw),
        "composition": lambda: kernels.dense_adam_plain(params, grads, m, v, **kw),
        "torch.optim.AdamW(fused=True)": fused.step,
    }
    runs = {name: {"device_ms": [], "event_ms": []} for name in methods}
    counts = {}
    for t in range(TURNS):
        for name in (list(methods) if t % 2 == 0 else list(reversed(methods))):
            dms, ems, counts[name] = turn(methods[name], CALLS)
            runs[name]["device_ms"].append(dms)
            runs[name]["event_ms"].append(ems)
    summary = {"card": card, "tensors": len(shapes), "elements": elements, "bound_ms": bound,
               "methods": {}}
    for name, r in runs.items():
        med = statistics.median(r["device_ms"])
        row = {"device_ms_median": med, "device_ms_min": min(r["device_ms"]),
               "device_ms_max": max(r["device_ms"]),
               "event_ms_median": statistics.median(r["event_ms"]),
               "of_bound": bound / med, "kernels_a_call": counts[name]}
        summary["methods"][name] = row
        print(f"{name}: device {med:.4f} ms ({row['device_ms_min']:.4f}-{row['device_ms_max']:.4f}), "
              f"events {row['event_ms_median']:.4f} ms, {100 * bound / med:.1f}% of the bound; "
              f"kernels a call {counts[name]}", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
