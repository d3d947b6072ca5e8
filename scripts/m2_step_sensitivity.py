#!/usr/bin/env python3
"""How far one training step moves when the category moments are summed in
another f32 order. The step is the card test's (``_one_step`` of
``tests/test_torch_port_cuda.py``: a gated-tower model, D = 128, C = 16,
AdamW at lr 1e-3, injected negatives, no dropout); the test holds the step
with the kernels to the step with the plain versions within lr / 100 = 1e-5
on every parameter. "Diff" below is the largest such difference.

At the test's seeds (data 8, state 4), and where it says so at 16 other
seeds (data s, state s + 100):

1. the kernel step against the plain step (also at the other seeds), and
   with only the forward or only the backward on its kernel;
2. the plain step with M2 correctly rounded (an f64 einsum rounded to f32)
   against the plain step, and the kernel step against it (also at the
   other seeds): whether the check accepts the exact moments;
3. the plain step with M2 moved by one ulp, up or down, at random
   symmetric entries (16 draws): a model of any other f32 order, with no
   kernel involved;
4. the M2 of that step: the kernel's and the einsum's error against the
   f64 einsum (largest absolute, largest relative to each category's
   largest |M2|, entries whose bits differ from the rounded f64 sum, mean
   signed over mean absolute error), and how many entries of bf16(H), the
   cotangent the backward rounds to bf16, differ from the plain step's when
   M2 is the kernel's or the exact one.

Needs one CUDA card; run from the root of a checkout:

    python3 scripts/m2_step_sensitivity.py
"""

from __future__ import annotations

import sys
from pathlib import Path

TEST_SEEDS = (8, 4)  # data, state: the seeds of _one_step
OTHER_SEEDS = [(s, s + 100) for s in range(16)]
TOL = 1e-5


def max_diff(a, b) -> float:
    tables = max(float((a.tables[n] - b.tables[n]).abs().max())
                 for n in ("user_id", "item_id", "user_aug", "item_aug"))
    dense = max(float((x.detach() - y.detach()).abs().max())
                for (_, x), (_, y) in zip(a.dense_targets(), b.dense_targets()))
    return max(tables, dense)


def summary(diffs: list[float]) -> str:
    return (f"{sum(d > TOL for d in diffs)} of {len(diffs)} beyond {TOL:g}; sorted "
            + " ".join(f"{d:.2e}" for d in sorted(diffs)))


def main() -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "tests")]
    import torch

    from test_torch_port_cuda import STEP_KERNELS, _one_step
    from ttamm_torch.ops import kernels

    if not torch.cuda.is_available():
        print("m2_step_sensitivity: no CUDA device visible", file=sys.stderr)
        return 2
    cuda = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    kernel_fns = {n: getattr(kernels, n) for n in STEP_KERNELS}

    def exact_m2(cat_ids, x, c, *_):
        xb = kernels._bf16(x).double()
        return torch.einsum("cn,nd,ne->cde", kernels._selector(cat_ids, c).double(), xb, xb).float()

    def step(seeds, plain, swap=None):
        return _one_step(cuda, plain, seeds, swap)[0]

    kernel_vs_plain, exact_vs_plain, kernel_vs_exact = [], [], []
    for seeds in [TEST_SEEDS] + OTHER_SEEDS:
        k, p = step(seeds, False), step(seeds, True)
        e = step(seeds, True, {"segment_second_moments": exact_m2})
        kernel_vs_plain.append(max_diff(k, p))
        exact_vs_plain.append(max_diff(e, p))
        kernel_vs_exact.append(max_diff(k, e))
    for what, diffs in (("kernel step vs plain step", kernel_vs_plain),
                        ("plain step with exact M2 vs plain step", exact_vs_plain),
                        ("kernel step vs plain step with exact M2", kernel_vs_exact)):
        print(f"{what}: test seeds {diffs[0]:.3e} | other seeds {summary(diffs[1:])}")

    plain = step(TEST_SEEDS, True)
    fwd_only = step(TEST_SEEDS, True, {"segment_second_moments": kernel_fns["segment_second_moments"]})
    bwd_only = step(TEST_SEEDS, True,
                    {"segment_second_moments_bwd": kernel_fns["segment_second_moments_bwd"]})
    print(f"test seeds, forward kernel only vs plain step: {max_diff(fwd_only, plain):.3e} | "
          f"backward kernel only: {max_diff(bwd_only, plain):.3e}")

    moved = []
    for draw in range(16):
        gen = torch.Generator(device="cuda").manual_seed(draw)

        def nudged(cat_ids, x, c, *_, gen=gen):
            m = kernels.segment_second_moments_plain(cat_ids, x, c)
            sign = torch.randint(-1, 2, m.shape, generator=gen, device=m.device)
            sign = torch.where(sign.transpose(1, 2) != 0, sign.transpose(1, 2), sign)  # symmetric
            up = torch.nextafter(m, torch.full_like(m, float("inf")))
            down = torch.nextafter(m, torch.full_like(m, float("-inf")))
            return torch.where(sign > 0, up, torch.where(sign < 0, down, m))

        moved.append(max_diff(step(TEST_SEEDS, True, {"segment_second_moments": nudged}), plain))
    print(f"test seeds, plain step with M2 moved one ulp at random entries, 16 draws: {summary(moved)}")

    seen = {}

    def keep_inputs(cat_ids, x, c, *_):
        seen["fwd"] = (cat_ids, x, c)
        return kernels.segment_second_moments_plain(cat_ids, x, c)

    def keep_cotangent(tag):
        def bwd(cat_ids, x, h, *_):
            seen[tag] = h.to(torch.bfloat16)
            return kernels.segment_second_moments_bwd_plain(cat_ids, x, h)
        return bwd

    step(TEST_SEEDS, True, {"segment_second_moments": keep_inputs,
                            "segment_second_moments_bwd": keep_cotangent("plain")})
    step(TEST_SEEDS, True, {"segment_second_moments": kernel_fns["segment_second_moments"],
                            "segment_second_moments_bwd": keep_cotangent("kernel")})
    step(TEST_SEEDS, True, {"segment_second_moments": exact_m2,
                            "segment_second_moments_bwd": keep_cotangent("exact")})
    ids, x, c = seen["fwd"]
    exact = exact_m2(ids, x, c).double()
    exact_f32 = exact.float()
    scale = exact.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    counts = torch.bincount(ids[(ids >= 0) & (ids < c)].long(), minlength=c)
    print(f"test seeds, the step's moments: N = {ids.numel()}, D = {x.shape[1]}, C = {c}, "
          f"rows per category {counts.tolist()}")
    for name, m2 in (("kernel", kernels.segment_second_moments_cuda(ids, x, c)),
                     ("einsum", kernels.segment_second_moments_plain(ids, x, c))):
        err = m2.double() - exact
        print(f"  {name} M2 vs the f64 einsum: max abs {float(err.abs().max()):.3e} | max of the "
              f"category's largest {float((err.abs() / scale).max()):.3e} | bits differ from the "
              f"rounded f64 sum {int((m2 != exact_f32).sum())} of {m2.numel()} | signed / absolute "
              f"{float(err.sum() / err.abs().sum().clamp_min(1e-30)):+.3f}")
    for tag in ("kernel", "exact"):
        flips = int((seen[tag] != seen["plain"]).sum())
        print(f"  bf16(H) entries that differ from the plain step's, M2 {tag}: {flips} of "
              f"{seen['plain'].numel()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
