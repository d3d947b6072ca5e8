#!/usr/bin/env python3
"""The design choices of the segment_second_moments kernels, measured at the
training step's shape (N = 12,288 item lanes, D = 128, C = 64) with two id
layouts: the skewed ids of ``chip_smoke.py`` phase 2 (the largest category
~30% of the rows) and ten populated categories of 64, near-uniform, as the
canonical corpus gives them.

Each variant is built from ``ttamm_torch/csrc/category_stats.cu`` with one
edit: the chunk size R = 32 or 64 rows (shipped: 128; the rows grouped to
match); the forward's f64 MMAs as m8n8k4 instead of m16n8k8; the grouping
kernel's lanes of one key found with a warp match instead of a ballot a key
bit; 256 threads in the forward's chunk blocks instead of 512; 512 threads in
the backward's and the reduction's instead of 256; 16 instead of 8 loads in
flight a thread. For each: the chunks, the device ms of each direction given
the grouping (the forward also split into its two kernels), the grouping
kernels' device ms, and the forward's error against an f64 einsum (the
largest relative to each category's largest |M2|, the mean, the mean signed
error over the mean absolute error: -1 is an error always toward zero; and
the M2 entries whose bits differ from the f64 sum rounded to f32 and from
the plain version's). Also the grouping's plain version's device ms
(PyTorch ops).

Every result is checked against the plain version with chip_smoke's
tolerance. Needs one NVIDIA Hopper card and nvcc; run from the root of a
checkout:

    python3 scripts/m2_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402

N, DIM, C = 12288, 128, 64
# The forward's f64 MMAs as m8n8k4 (an 8 x 8 tile, k = 4) instead of
# m16n8k8: (start, end, text) replaces the source from start up to end.
M8N8K4_FN = r'''__device__ __forceinline__ void dmma(double (&acc)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(acc[0]), "+d"(acc[1])
      : "d"(a), "d"(b));
}

'''
M8N8K4_LOOP = '''    for (int k0 = 0; k0 < depth; k0 += 4) {
      double a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        a[m] = static_cast<double>(__bfloat162float(col_a[k0 * stride + 8 * m]));
        b[m] = static_cast<double>(__bfloat162float(col_b[k0 * stride + 8 * m]));
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) dmma(acc[m][n], a[m], b[n]);
      }
    }
'''
M8N8K4 = (
    ("// acc (16 x 8 f64) += a (16 x 8)", "__global__ void __launch_bounds__(kChunkThreads)\nm2_chunk_kernel(",
     M8N8K4_FN),
    ("    for (int k0 = 0; k0 < depth; k0 += 8) {", "#pragma unroll\n    for (int m = 0; m < 4; ++m) {", M8N8K4_LOOP),
    ("round_up(ch.rows, 8);", None, "round_up(ch.rows, 4);"),
)
VARIANTS = {
    "shipped": (),
    "R = 32": (("constexpr int kChunkRows = 128;", None, "constexpr int kChunkRows = 32;"),),
    "R = 64": (("constexpr int kChunkRows = 128;", None, "constexpr int kChunkRows = 64;"),),
    "m8n8k4 f64 MMAs": M8N8K4,
    "warp-match grouping": (("same_key_lanes(keys[u], bits)", None, "__match_any_sync(0xffffffffu, keys[u])"),),
    "256-thread chunk blocks": (("constexpr int kChunkThreads = 512;", None,
                                "constexpr int kChunkThreads = 256;"),),
    "512 threads elsewhere": (("constexpr int kThreads = 256;", None, "constexpr int kThreads = 512;"),),
    "16 loads in flight": (("constexpr int kUnroll = 8;", None, "constexpr int kUnroll = 16;"),),
}


def layouts(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    skewed = torch.clamp(torch.empty(N, device=dev).exponential_(generator=gen) * 6, max=C - 3)
    uniform = torch.randint(0, 10, (N,), generator=gen, device=dev)
    return {"skewed": skewed.to(torch.int32), "10 of 64": uniform.to(torch.int32)}


def split_ms(fn, names, iters: int = 10) -> dict[str, float]:
    """Device ms per call of each kernel whose name holds one of ``names``."""
    events = smoke._profiled(lambda: [fn() for _ in range(2)], lambda: [fn() for _ in range(iters)])
    return {n: sum(smoke._device_us([e]) for e in events if n in e.key) / iters / 1e3 for n in names}


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """category_stats.cu with the edits of VARIANTS[name], in its own library:
    each ``(start, end, text)`` replaces the source from ``start`` up to
    ``end`` (``start`` itself where ``end`` is None) with ``text``."""
    from ttamm_torch.ops import kernels

    src = (REPO / "ttamm_torch" / "csrc" / "category_stats.cu").read_text()
    for start, end, text in VARIANTS[name]:
        if src.count(start) != 1 or (end is not None and end not in src[src.index(start):]):
            raise RuntimeError(f"category_stats.cu no longer has {start[:60]!r} ... {end!r:.60}")
        i = src.index(start)
        j = i + len(start) if end is None else src.index(end, i)
        src = src[:i] + text + src[j:]
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu = out_dir / f"category_stats_{tag}.cu"
    cu.write_text(src)
    lib = out_dir / f"libm2_{tag}.so"
    proc = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    handle = ctypes.CDLL(str(lib))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (handle.ttamm_segment_second_moments, handle.ttamm_segment_second_moments_bwd):
        fn.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32, p]
        fn.restype = i32
    handle.ttamm_category_grouping.argtypes = [p, i32, i32, i32, p, p, p, p, i32, p, p, p]
    handle.ttamm_category_grouping.restype = i32
    handle.ttamm_category_grouping_warps.argtypes = [i32]
    handle.ttamm_category_grouping_warps.restype = i32
    return handle


def grouping(ids, rows: int):
    """The kernels' grouping of ``ids`` in chunks of ``rows``."""
    from ttamm_torch.ops import kernels

    shipped = kernels.M2_CHUNK_ROWS
    kernels.M2_CHUNK_ROWS = rows
    try:
        return kernels._group_by_category(ids, C)
    finally:
        kernels.M2_CHUNK_ROWS = shipped


def main() -> int:
    import torch

    from ttamm_torch.ops import kernels

    if not torch.cuda.is_available():
        print("m2_variants: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)} | nvidia-smi: {smoke.nvidia_smi()}")
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((N, DIM), generator=gen, device=dev) * 0.3
    h = torch.randn((C, DIM, DIM), generator=gen, device=dev)
    h = (h + h.transpose(1, 2)).contiguous()
    libs = {name: build(name, REPO / "build" / "m2_variants") for name in VARIANTS}
    for label, ids in layouts(dev).items():
        want = kernels.segment_second_moments_plain(ids, x, C)
        want_b = kernels.segment_second_moments_bwd_plain(ids, x, h)
        scale = want.abs().amax(dim=(1, 2), keepdim=True)
        xb = kernels._bf16(x).double()
        exact = torch.einsum("cn,nd,ne->cde", kernels._selector(ids, C).double(), xb, xb)

        def check(got, got_b, what):
            if not bool(((got - want).abs() <= smoke.M2_TOL * scale).all()):
                raise AssertionError(f"{label}, {what}: forward != plain")
            if not bool(((got_b - want_b).abs() <= smoke.M2_TOL * want_b.abs().max()).all()):
                raise AssertionError(f"{label}, {what}: backward != plain")

        print(f"{label}: the grouping's plain version (PyTorch ops) "
              f"{smoke.device_ms(lambda: grouping(ids, kernels.M2_CHUNK_ROWS)):.4f} ms")
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            rows = int(name[4:]) if name.startswith("R = ") else kernels.M2_CHUNK_ROWS
            g = grouping(ids, rows)
            m2 = torch.empty((C, DIM, DIM), device=dev)
            partial = torch.empty((g.chunk_cat.numel(), DIM, DIM), dtype=torch.float64, device=dev)
            dx = torch.empty_like(x)
            common = (g.order.data_ptr(), g.offsets.data_ptr(), g.chunk_offsets.data_ptr(),
                      g.chunk_cat.data_ptr())
            tail = (C, DIM, g.chunk_cat.numel(), 1, stream)

            def fwd(lib=lib, m2=m2, partial=partial, common=common, tail=tail):
                if lib.ttamm_segment_second_moments(x.data_ptr(), *common, m2.data_ptr(),
                                                    partial.data_ptr(), *tail):
                    raise RuntimeError("launch failed")

            def bwd(lib=lib, dx=dx, common=common, tail=tail):
                if lib.ttamm_segment_second_moments_bwd(x.data_ptr(), h.data_ptr(), *common,
                                                        dx.data_ptr(), *tail):
                    raise RuntimeError("launch failed")

            gk = kernels.CategoryGrouping(*(torch.empty_like(t) for t in g))
            counts = torch.empty((C + 1) * lib.ttamm_category_grouping_warps(N), dtype=torch.int32,
                                 device=dev)
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)  # each call leaves it 0

            def group(lib=lib, gk=gk, counts=counts, ticket=ticket):
                if lib.ttamm_category_grouping(ids.data_ptr(), 0, N, C, *(t.data_ptr() for t in gk),
                                               gk.chunk_cat.numel(), counts.data_ptr(),
                                               ticket.data_ptr(), stream):
                    raise RuntimeError("launch failed")

            fwd()
            bwd()
            group()
            torch.cuda.synchronize()
            check(m2, dx, name)
            if not all(torch.equal(a, b) for a, b in zip(gk, g)):
                raise AssertionError(f"{label}, {name}: grouping kernel != plain")
            parts = split_ms(fwd, ("m2_chunk_kernel", "m2_reduce_kernel"))
            err = m2.double() - exact
            rel = float((err.abs() / exact.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)).max())
            bias = float(err.sum() / err.abs().sum().clamp_min(1e-30))
            print(f"{label}, {name}: {int(g.chunk_offsets[C])} chunks | fwd {smoke.device_ms(fwd):.4f} ms "
                  f"(chunks {parts['m2_chunk_kernel']:.4f} + reduction {parts['m2_reduce_kernel']:.4f}) | "
                  f"bwd {smoke.device_ms(bwd):.4f} ms | grouping kernel {smoke.device_ms(group):.4f} ms | "
                  f"fwd error vs f64: max "
                  f"{rel:.2e} of the category's largest, mean {float(err.abs().mean()):.2e}, signed / "
                  f"absolute {bias:+.3f}, bits differ from the rounded f64 sum "
                  f"{int((m2 != exact.float()).sum())}, from plain {int((m2 != want).sum())} of {m2.numel()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
