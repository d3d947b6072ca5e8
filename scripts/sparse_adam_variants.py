#!/usr/bin/env python3
"""The design choices of the fused sparse-row Adam kernel
(``sparse_adam_rows`` in ``ttamm_torch/csrc/rows.cu``), measured at one
training step's shapes, and the three facts about eager PyTorch's rounding
on which its bit-equality with the plain version rests.

Shapes: the item table (99,881 rows x 128, the canonical corpus's items and
the scratch row) at 12,288 lanes (2,048 positives and 10,240 negatives drawn
uniformly), and the user table (199,450 x 128) at 2,048 lanes, each
coalesced as ``sparse_adam_update`` gives them (the non-head lanes -1).

Each variant is built from ``rows.cu`` with an edit: 2, 4 or 8 rows in
flight per warp (the shipped kernel replaced by MULTI_ROW_KERNEL; shipped:
one row a warp); 128 or 512 threads a block
(shipped: 256); plain loads and stores instead of the streaming
``__ldcs`` / ``__stcs``. For each: device ms
with a cold L2 (a 256 MB fill before each call) at both shapes, two
readings taken in turns (every variant, then every variant in reverse), and
table, m and v bit-identical to the plain version. Also the plain version's and the unfused composition's ms
(gather_rows x 3, eager adam_rows, scatter_set_rows x 3).

Numerics: each eager op of ``adam_rows`` on the card against the ways it
may round, element by element (the reference rounds every f32 operation
once: f64 arithmetic on f32 values, rounded to f32 after each op, exact for
+, -, x, / and sqrt of f32 operands): (1) a tensor divided by a Python
scalar c against a multiply by 1 / c formed in double and rounded to f32
(what the kernel's host scalars assume), by the f32 reciprocal of the f32
scalar, an IEEE division and a division in f64; tensor by tensor division
and the square root against the correctly rounded ones; (2)
``b1 * m + (1 - b1) * g`` against separate roundings and an FMA; (3) the
whole of ``adam_rows``, with and without weight decay, against the op-by-op
reference with each way of rounding the bias division.

Needs one NVIDIA Hopper card and nvcc; run from the root of a checkout:

    python3 scripts/sparse_adam_variants.py
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402

ITEMS, USERS, DIM, BATCH, NEG = 99_880, 199_449, 128, 2048, 5
# the shipped kernel (one row a warp), replaced whole by MULTI_ROW_KERNEL
KERNEL = re.compile(
    r"__global__ void __launch_bounds__\(kAdamThreads\)\nsparse_adam_rows_kernel\(.*?\n}\n", re.S
)
GRID = "(n + kAdamWarps - 1) / kAdamWarps"
# kAdamRows rows a warp: every row's index, then every 16-byte vector of all
# of them, before any arithmetic or store
MULTI_ROW_KERNEL = """__global__ void __launch_bounds__(kAdamThreads)
sparse_adam_rows_kernel(float* __restrict__ w, float* __restrict__ m, float* __restrict__ v,
                        const int32_t* __restrict__ idx, const float* __restrict__ grads,
                        int64_t n, int64_t rows, int dim, const float* __restrict__ scalars,
                        int decay) {
  constexpr int kAdamRows = ROWS;
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kAdamWarps + (threadIdx.x >> 5)) * kAdamRows;
  if (r0 >= n) return;
  const AdamScalars s = load_adam_scalars(scalars, decay);
  const int lane = threadIdx.x & 31;
  const int vecs = dim >> 2;
  int64_t target[kAdamRows];  // each row's offset in float4s, -1: no read, no write
#pragma unroll
  for (int j = 0; j < kAdamRows; ++j) {
    const int32_t i = r0 + j < n ? __ldg(idx + r0 + j) : -1;
    target[j] = i >= 0 && i < rows ? static_cast<int64_t>(i) * vecs : -1;
  }
  float4* w4 = reinterpret_cast<float4*>(w);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(grads) + r0 * vecs;
  for (int col = lane; col < vecs; col += 32) {
    float4 wr[kAdamRows], mr[kAdamRows], vr[kAdamRows], gr[kAdamRows];
#pragma unroll
    for (int j = 0; j < kAdamRows; ++j) {
      if (target[j] < 0) continue;
      wr[j] = __ldcs(w4 + target[j] + col);
      mr[j] = __ldcs(m4 + target[j] + col);
      vr[j] = __ldcs(v4 + target[j] + col);
      gr[j] = __ldcs(g4 + j * vecs + col);
    }
#pragma unroll
    for (int j = 0; j < kAdamRows; ++j) {
      if (target[j] < 0) continue;
      adam_vec(wr[j], mr[j], vr[j], gr[j], s);
      __stcs(w4 + target[j] + col, wr[j]);
      __stcs(m4 + target[j] + col, mr[j]);
      __stcs(v4 + target[j] + col, vr[j]);
    }
  }
}
"""


def multi_row(rows: int) -> tuple:
    return (
        (KERNEL, MULTI_ROW_KERNEL.replace("ROWS", str(rows))),
        (GRID, f"(n + kAdamWarps * {rows} - 1) / (kAdamWarps * {rows})"),
    )


VARIANTS = {
    "shipped": (),
    **{f"{rows} rows a warp": multi_row(rows) for rows in (2, 4, 8)},
    "128 threads": (("constexpr int kAdamThreads = 256;", "constexpr int kAdamThreads = 128;"),),
    "512 threads": (("constexpr int kAdamThreads = 256;", "constexpr int kAdamThreads = 512;"),),
    "plain loads and stores": (
        *((f"__ldcs({a} + ", f"*({a} + ") for a in ("w4", "m4", "v4", "g4")),
        *((f"__stcs({a} + col, {r});", f"{a}[col] = {r};")
          for a, r in (("w4", "wr"), ("m4", "mr"), ("v4", "vr"))),
    ),
}
HYPER = dict(step=2, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """rows.cu with the edits of VARIANTS[name] (each ``(old, new)``
    replaces every occurrence of the text ``old``, or the one match of the
    pattern ``old``), in its own library."""
    from ttamm_torch.ops import kernels

    src = (REPO / "ttamm_torch" / "csrc" / "rows.cu").read_text()
    for old, new in VARIANTS[name]:
        if isinstance(old, re.Pattern):
            src, found = old.subn(lambda _: new, src)
        else:
            src, found = src.replace(old, new), src.count(old)
        if not found:
            raise RuntimeError(f"rows.cu no longer has {old!r}")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"\W+", "_", name)
    cu = out_dir / f"rows_{tag}.cu"
    cu.write_text(src)
    lib = out_dir / f"librows_{tag}.so"
    proc = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    handle = ctypes.CDLL(str(lib))
    handle.regs = ptxas_line(proc.stdout + proc.stderr)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    handle.ttamm_sparse_adam_rows.argtypes = [p, p, p, p, p, i64, i64, i32, p, i32, p]
    handle.ttamm_sparse_adam_rows.restype = i32
    return handle


def ptxas_line(report: str) -> str:
    """The ``ptxas -v`` registers / spills line of the fused kernel."""
    entry = False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = "sparse_adam_rows_kernel" in line
        elif entry and ("registers" in line or "spill" in line):
            return line.strip()
    return "not found"


def cases(dev):
    """{label: (table, m, v, coalesced lanes, summed grads)} at the two shapes."""
    import torch

    from ttamm_torch.ops.sparse_adam import coalesce_row_grads

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for label, rows, n in (("item", ITEMS, BATCH * (1 + NEG)), ("user", USERS, BATCH)):
        table = torch.randn((rows + 1, DIM), generator=gen, device=dev)
        m = torch.randn((rows + 1, DIM), generator=gen, device=dev) * 0.01
        v = torch.rand((rows + 1, DIM), generator=gen, device=dev) * 1e-4
        for t in (table, m, v):
            t[rows] = 0.0  # the scratch row
        lanes = torch.randint(0, rows, (n,), generator=gen, device=dev)
        grads = torch.randn((n, DIM), generator=gen, device=dev) * 1e-2
        target, summed = coalesce_row_grads(lanes, grads, scratch_row=-1)
        out[label] = (table, m, v, target, summed)
    return out


def launch(lib, table, m, v, target, summed, scalars) -> None:
    import torch

    rc = lib.ttamm_sparse_adam_rows(
        table.data_ptr(), m.data_ptr(), v.data_ptr(), target.data_ptr(), summed.data_ptr(),
        target.numel(), table.shape[0], table.shape[1], scalars["scalars"].data_ptr(),
        int(scalars["decay"]), torch.cuda.current_stream().cuda_stream,
    )
    if rc:
        raise RuntimeError(f"launch refused ({rc})")


BIAS_MODES = ("x * f32(1 / c)", "x * (1 / f32(c)) in f32", "IEEE x / f32(c)")


def per_op_reference(w, m, v, g, *, step, lr, b1, b2, eps, weight_decay, bias):
    """adam_rows with every f32 operation rounded once: f64 arithmetic on
    f32 values, rounded to f32 after each op. ``bias`` (one of BIAS_MODES):
    how ``m_new / (1 - b1^t)`` and ``v_new / (1 - b2^t)`` round."""
    import numpy as np
    import torch

    f32 = np.float32

    def r(x):
        return x.float().double()

    def s(x):  # a Python scalar as an f32 value
        return float(f32(x))

    def unbias(x, c):
        if bias == "x * f32(1 / c)":
            return r(x * s(1.0 / c))
        if bias == "x * (1 / f32(c)) in f32":
            return r(x * float(f32(1.0) / f32(c)))
        return r(x / s(c))

    w, m, v, g = (t.double() for t in (w, m, v, g))
    m_new = r(r(s(b1) * m) + r(s(1.0 - b1) * g))
    v_new = r(r(s(b2) * v) + r(s(1.0 - b2) * r(g * g)))
    m_hat, v_hat = unbias(m_new, 1.0 - b1**step), unbias(v_new, 1.0 - b2**step)
    delta = r(r(s(lr) * m_hat) / r(r(torch.sqrt(v_hat)) + s(eps)))
    if weight_decay:
        delta = r(delta + r(s(lr * weight_decay) * w))
    return r(w - delta).float(), m_new.float(), v_new.float()


def _off(got, want) -> str:
    """Elements whose bits differ, and the largest distance in f32 ulps."""
    import torch

    diff = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    return f"{int((diff != 0).sum())} off (max {int(diff.max())} ulp)"


def numerics(dev) -> None:
    """Each eager op of adam_rows on the card against the candidate ways it
    may round, counted element by element; then the whole of adam_rows
    against the op-by-op reference with each candidate bias division."""
    import numpy as np
    import torch

    from ttamm_torch.ops.sparse_adam import adam_rows

    f32 = np.float32
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((1 << 20,), generator=gen, device=dev)
    for b, step in ((0.9, 1), (0.9, 2), (0.999, 1), (0.999, 2), (0.999, 1000)):
        c = 1.0 - b**step
        cands = {
            "x * f32(1 / c)": x * float(f32(1.0 / c)),
            "x * (1 / f32(c)) in f32": x * float(f32(1.0) / f32(c)),
            "IEEE x / f32(c)": (x.double() / float(f32(c))).float(),
            "x / c in f64": (x.double() / c).float(),
        }
        eager = x / c
        print(f"(1) x / (1 - {b}^{step}): " + "; ".join(f"{k}: {_off(eager, v)}" for k, v in cands.items()))
    a = torch.randn(x.shape, generator=gen, device=dev)
    d = torch.rand(x.shape, generator=gen, device=dev) + 1e-3
    print(f"(1b) tensor / tensor: IEEE: {_off(a / d, (a.double() / d.double()).float())}; "
          f"a * f32(1 / d): {_off(a / d, a * (1.0 / d.double()).float())}")
    v = torch.rand(x.shape, generator=gen, device=dev) * 1e-4
    print(f"(1c) sqrt: correctly rounded: {_off(torch.sqrt(v), v.double().sqrt().float())}")
    m = torch.randn(x.shape, generator=gen, device=dev) * 0.1
    g = torch.randn(x.shape, generator=gen, device=dev)
    eager = 0.9 * m + (1.0 - 0.9) * g
    first = (float(f32(0.9)) * m.double()).float().double()
    separate = (first + (float(f32(1.0 - 0.9)) * g.double()).float().double()).float()
    fma = (first + float(f32(1.0 - 0.9)) * g.double()).float()  # the second product unrounded
    print(f"(2) b1*m + (1-b1)*g: separately rounded: {_off(eager, separate)}; as one FMA on the "
          f"second product: {_off(eager, fma)}")
    w = torch.randn((4096, DIM), generator=gen, device=dev)
    mm = torch.randn((4096, DIM), generator=gen, device=dev) * 0.01
    vv = torch.rand((4096, DIM), generator=gen, device=dev) * 1e-4
    vv[::5] = 0.0
    gg = torch.randn((4096, DIM), generator=gen, device=dev) * 1e-2
    gg[::7] *= 1e-6
    for step in (1, 2, 1000):
        for wd in (0.0, 0.01):
            hyper = dict(step=step, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
            got = adam_rows(w, mm, vv, gg, **hyper)
            line = []
            for mode in BIAS_MODES:
                want = per_op_reference(w, mm, vv, gg, **hyper, bias=mode)
                line.append(f"{mode}: " + ", ".join(_off(a, b) for a, b in zip(got, want)))
            print(f"(3) adam_rows step {step}, weight decay {wd} (w, m, v) vs the op-by-op "
                  "reference with the bias division as " + "; ".join(line))


def main() -> int:
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.sparse_adam import unfused_row_update

    if not torch.cuda.is_available():
        print("sparse_adam_variants: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smoke.nvidia_smi()}")
    numerics(dev)
    data = cases(dev)
    scal = kernels.adam_row(dev, **HYPER)  # the step's scalar row on the card
    out_dir = REPO / "build" / "sparse_adam_variants"
    for label, (table, m, v, target, summed) in data.items():
        live = int((target >= 0).sum())
        nbytes = target.numel() * 4 + live * DIM * 4 * 7 + kernels.ADAM_SCALARS * 4
        copies = [t.clone() for t in (table, m, v)]
        scratch = table.shape[0] - 1
        s_target = torch.where(target >= 0, target, scratch).to(torch.int32)

        def composition():
            unfused_row_update(*copies, s_target, summed, gather=kernels.gather_rows_cuda,
                               scatter=kernels.scatter_set_rows_cuda, **scal)

        plain = smoke.device_ms_cold(lambda: kernels.sparse_adam_rows_plain(*copies, target, summed, **scal))
        comp = smoke.device_ms_cold(composition)
        print(f"{label}: {target.numel()} lanes, {live} live | bound {smoke.bound_ms(nbytes)[0]:.4f} ms "
              f"| plain {plain:.4f} ms | composition (gather x 3, eager Adam, scatter x 3) {comp:.4f} ms")
    libs = {name: build(name, out_dir) for name in VARIANTS}
    times = {name: {label: [] for label in data} for name in VARIANTS}
    for name in [*VARIANTS, *reversed(VARIANTS)]:  # two readings each, in turns
        lib = libs[name]
        for label, (table, m, v, target, summed) in data.items():
            got, want = [t.clone() for t in (table, m, v)], [t.clone() for t in (table, m, v)]
            launch(lib, *got, target, summed, scal)
            kernels.sparse_adam_rows_plain(*want, target, summed, **scal)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} at the {label} lanes: kernel != plain")
            times[name][label].append(smoke.device_ms_cold(lambda: launch(lib, *got, target, summed, scal)))
    for name, lib in libs.items():
        print(f"{name}: " + " | ".join(
            f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms" for label, ts in times[name].items()
        ) + f" (table, m, v bit-identical to the plain version) | {lib.regs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
