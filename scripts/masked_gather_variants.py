#!/usr/bin/env python3
"""The design choices of the zero-filling masked gather (the lookup of a
row-sharded table, ``gather_rows_masked_kernel`` in
``ttamm_torch/csrc/rows.cu``), measured at one training step's lookup.

Shapes: the item table (99,881 rows x 128, the canonical corpus's items and
the scratch row) padded to 4 model shards of 24,971 rows, read at 12,288
lanes (2,048 positives and 10,240 negatives drawn uniformly) in batch
order: each shard's part of the lookup (its rows on the lanes it owns,
zeros elsewhere) and the whole table at 1x1 (every lane owned).

Each variant is built from ``rows.cu`` with an edit: 2, 4 or 8 rows a
warp (the shipped kernel replaced by MULTI_ROW_KERNEL: the warp loads every
row's index, then every row's 16-byte vectors, before its stores; shipped:
one row a warp), 4 or 8 rows a warp with the foreign rows' zeros stored
before the owned rows' loads, 128 or 512 threads a block, and streaming
stores (``__stcs``). For each: device ms with
a cold L2 (a 256 MB fill before each call, as ``chip_smoke.py`` times the
row kernels) of the four shards in one call (the mean a shard) and of the
1x1 lookup, two readings taken in turns (every variant, then every variant
in reverse), each output equal to the plain version on every lane, zeros
included. Also the bound (every lane's index and row, each owned distinct
row read once), the lookup the kernel replaced (``index_select`` of the
clamped lanes, then ``where``), and two yardsticks of what the cold L2
costs a kernel that writes: the shipped kernel with every lane foreign
(the indices read and the zeros written, nothing else), and the shipped
kernel, foreign lanes or not, after a flush that reads 256 MB (``sum``)
instead of writing them, so that the L2 it finds holds no dirty lines to
write back.

Needs one NVIDIA Hopper card and nvcc; run from the root of a checkout:

    python3 scripts/masked_gather_variants.py
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

ITEMS, DIM, LANES, SHARDS = 99_880, 128, 2048 * 6, 4
THREADS = "constexpr int kThreads = 256;"
# the shipped kernel (one row a warp), replaced whole by MULTI_ROW_KERNEL
KERNEL = re.compile(
    r"__global__ void __launch_bounds__\(kThreads\)\ngather_rows_masked_kernel\(.*?\n}\n", re.S
)
GRID = "gather_rows_masked_kernel<<<blocks_for(n),"
# ROWS rows a warp: every row's index, then every row's 16-byte vectors,
# before the stores
MULTI_ROW_KERNEL = """__global__ void __launch_bounds__(kThreads)
gather_rows_masked_kernel(const float* __restrict__ local, const int32_t* __restrict__ idx,
                          float* __restrict__ out, int64_t n, int64_t rows, int dim,
                          int64_t base) {
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5)) * ROWS;
  if (first >= n) return;
  const int lane = threadIdx.x & 31;
  const int vecs = dim >> 2;
  int64_t src[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int64_t i = first + j < n ? static_cast<int64_t>(__ldg(idx + first + j)) - base : -1;
    src[j] = i >= 0 && i < rows ? i : -1;
  }
  const float4* local4 = reinterpret_cast<const float4*>(local);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int v = lane; v < vecs; v += 32) {
    float4 val[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      val[j] = src[j] >= 0 ? __ldg(local4 + src[j] * vecs + v) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      if (first + j < n) out4[(first + j) * vecs + v] = val[j];
  }
}
"""


# the loop over a warp's vectors of MULTI_ROW_KERNEL with the foreign rows'
# zeros stored first, while the owned rows' loads are in flight
ZEROS_FIRST = """  for (int v = lane; v < vecs; v += 32) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      if (first + j < n && src[j] < 0) out4[(first + j) * vecs + v] = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 val[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      if (src[j] >= 0) val[j] = __ldg(local4 + src[j] * vecs + v);
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      if (src[j] >= 0) out4[(first + j) * vecs + v] = val[j];
  }
}
"""


def multi_row(rows: int, zeros_first: bool = False) -> tuple:
    body = MULTI_ROW_KERNEL
    if zeros_first:
        body = body[: body.index("  for (int v = lane;")] + ZEROS_FIRST
    return (
        (KERNEL, body.replace("ROWS", str(rows))),
        (GRID, f"gather_rows_masked_kernel<<<(n + kRowsPerBlock * {rows} - 1) / (kRowsPerBlock * {rows}),"),
    )


def variants() -> dict[str, tuple]:
    out = {"shipped (one row a warp)": ()}
    for r in (2, 4, 8):
        out[f"{r} rows a warp"] = multi_row(r)
    for r in (4, 8):
        out[f"{r} rows a warp, zeros stored first"] = multi_row(r, zeros_first=True)
    for t in (128, 512):
        out[f"{t} threads"] = ((THREADS, f"constexpr int kThreads = {t};"),)
    out["streaming stores"] = (
        ("dst[v] = make_float4(0.f, 0.f, 0.f, 0.f);", "__stcs(dst + v, make_float4(0.f, 0.f, 0.f, 0.f));"),
        ("dst[v] = __ldg(src + v);", "__stcs(dst + v, __ldg(src + v));"),
    )
    return out


def build(name: str, edits: tuple, out_dir: Path) -> ctypes.CDLL:
    """rows.cu with ``edits`` (each ``(old, new)`` replaces every
    occurrence of the text ``old``, or the one match of the pattern
    ``old``), in its own library."""
    from ttamm_torch.ops import kernels

    src = (REPO / "ttamm_torch" / "csrc" / "rows.cu").read_text()
    for old, new in edits:
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
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    handle.ttamm_gather_rows_masked.argtypes = [p, p, p, i64, i64, i32, i64, p]
    handle.ttamm_gather_rows_masked.restype = i32
    handle.regs = ptxas_line(proc.stdout + proc.stderr)
    return handle


def ptxas_line(report: str) -> str:
    """The ``ptxas -v`` registers line of the masked gather."""
    entry = False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = "gather_rows_masked_kernel" in line
        elif entry and "registers" in line:
            return line.strip()
    return "not found"


def cases(dev):
    """{label: [(shard rows, lanes, base), ...]}: the four shards and 1x1."""
    import torch

    from ttamm_torch.parallel.sharding import padded_rows

    gen = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((ITEMS + 1, DIM), generator=gen, device=dev)
    lanes = torch.randint(0, ITEMS, (LANES,), generator=gen, device=dev, dtype=torch.int32)
    total = padded_rows(ITEMS, SHARDS)
    padded = torch.cat([table, table.new_zeros((total - table.shape[0], DIM))])
    rps = total // SHARDS
    return {
        "shard of 4": [(padded[s * rps : (s + 1) * rps], lanes, s * rps) for s in range(SHARDS)],
        "1x1": [(table, lanes, 0)],
    }


def device_ms_clean(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms after a flush that reads 256 MB
    (a ``sum``, whose reduction kernels are left out by name) in place of
    ``chip_smoke.device_ms_cold``'s fill, which leaves the L2 full of dirty
    lines."""
    import torch

    flush = torch.ones(smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def calls(n):
        for _ in range(n):
            flush.sum()
            fn()

    events = smoke._profiled(lambda: calls(2), lambda: calls(iters))
    return smoke._per_call_us([e for e in events if "reduce" not in e.key.lower()], iters) / 1e3


def launch(lib, out, local, lanes, base) -> None:
    import torch

    rc = lib.ttamm_gather_rows_masked(
        local.data_ptr(), lanes.data_ptr(), out.data_ptr(), lanes.numel(), local.shape[0],
        local.shape[1], base, torch.cuda.current_stream().cuda_stream,
    )
    if rc:
        raise RuntimeError(f"launch refused ({rc})")


def main() -> int:
    import torch

    from ttamm_torch.ops import kernels

    if not torch.cuda.is_available():
        print("masked_gather_variants: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smoke.nvidia_smi()}")
    data = cases(dev)
    outs = {label: [torch.empty((lanes.numel(), DIM), device=dev) for _, lanes, _ in group]
            for label, group in data.items()}
    for label, group in data.items():
        nbytes = 0
        for local, lanes, base in group:
            own = lanes.long() - base
            own = own[(own >= 0) & (own < local.shape[0])]
            nbytes += lanes.numel() * 4 + (int(torch.unique(own).numel()) + lanes.numel()) * DIM * 4

        def lookup(group=group):
            for local, lanes, base in group:
                lane = lanes.long() - base
                owned = (lane >= 0) & (lane < local.shape[0])
                torch.where(owned[:, None], torch.index_select(local, 0, torch.where(owned, lane, 0)), 0.0)

        def shipped(group=group):
            for local, lanes, base in group:
                kernels.gather_rows_cuda(local, lanes, masked=True, base=base)

        def zeros(group=group):  # every lane foreign: the indices read, the zeros written
            for local, lanes, _ in group:
                kernels.gather_rows_cuda(local, lanes, masked=True, base=-2 * ITEMS)

        k = len(group)
        print(f"{label}: {LANES} lanes | bound {smoke.bound_ms(nbytes / k)[0]:.4f} ms | index_select + "
              f"where {smoke.device_ms_cold(lookup) / k:.4f} ms | the shipped kernel after a reading "
              f"flush {device_ms_clean(shipped) / k:.4f} ms | every lane foreign (zeros only: bound "
              f"{smoke.bound_ms(LANES * 4 + LANES * DIM * 4)[0]:.4f} ms) "
              f"{smoke.device_ms_cold(zeros) / k:.4f} ms, after a reading flush "
              f"{device_ms_clean(zeros) / k:.4f} ms (per shard)")
    out_dir = REPO / "build" / "masked_gather_variants"
    table = variants()
    libs = {name: build(name, edits, out_dir) for name, edits in table.items()}
    times = {name: {label: [] for label in data} for name in table}
    for name in [*table, *reversed(table)]:  # two readings each, in turns
        lib = libs[name]
        for label, group in data.items():
            for out, (local, lanes, base) in zip(outs[label], group):
                out.fill_(float("nan"))
                launch(lib, out, local, lanes, base)
                want = kernels.gather_rows_plain(local, lanes, masked=True, base=base)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} at {label} (base {base}): kernel != plain")
            times[name][label].append(smoke.device_ms_cold(
                lambda: [launch(lib, o, *c) for o, c in zip(outs[label], group)]) / len(group))
    for name, lib in libs.items():
        print(f"{name}: " + " | ".join(
            f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms" for label, ts in times[name].items()
        ) + f" (equal to the plain version on every lane) | {lib.regs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
