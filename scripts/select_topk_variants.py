#!/usr/bin/env python3
"""The design choices of the select_topk_from_groups kernel, measured:
builds ``ttamm_torch/csrc/select_topk.cu`` as shipped (128 threads a row,
a 2-digit bound, 8 blocks an SM) and with one choice changed each (256
threads; the exact 4-digit or a 3-digit bound; 12 blocks an SM), checks
each bit-identical to the plain version, and prints the device ms of each
beside a gather + torch.topk at the kernel's three main-path shapes
(``chip_smoke.select_shapes``).

Needs one NVIDIA Hopper card and nvcc; run from the root of a checkout:

    python3 scripts/select_topk_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402


VARIANTS = {
    "shipped": (),
    "256 threads": (
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        ("__launch_bounds__(kThreads, 8)", "__launch_bounds__(kThreads, 4)"),
    ),
    "exact bound": (("constexpr int kBoundDigits = 2;", "constexpr int kBoundDigits = 4;"),),
    "3-digit bound": (("constexpr int kBoundDigits = 2;", "constexpr int kBoundDigits = 3;"),),
    "12 blocks an SM": (("__launch_bounds__(kThreads, 8)", "__launch_bounds__(kThreads, 12)"),),
}


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """select_topk.cu with the edits of VARIANTS[name], in its own library."""
    from ttamm_torch.ops import kernels

    csrc = REPO / "ttamm_torch" / "csrc"
    src = (csrc / "select_topk.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"select_topk.cu no longer has {old!r}")
        src = src.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu = out_dir / f"select_topk_{tag}.cu"
    cu.write_text(src)
    lib = out_dir / f"libselect_{tag}.so"
    proc = subprocess.run(
        [kernels.find_nvcc(), *kernels.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib), str(cu)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip()}")
    handle = ctypes.CDLL(str(lib))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    handle.ttamm_select_topk_from_groups.argtypes = [p, p, p, p, i32, i64, i32, i32, i64, p]
    handle.ttamm_select_topk_from_groups.restype = i32
    return handle


def main() -> int:
    import torch

    from ttamm_torch.ops import kernels

    if not torch.cuda.is_available():
        print("select_topk_variants: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)} | nvidia-smi: {smoke.nvidia_smi()}")
    libs = {name: build(name, REPO / "build" / "select_widths") for name in VARIANTS}
    g = kernels.GROUP
    for label, qb, n, k, eval_rows in smoke.select_shapes():
        s, gi = smoke.select_case(qb, n, k, eval_rows, dev)
        ng = s.shape[1] // g
        pv, pi = kernels.select_topk_from_groups_plain(s, gi, k=k, num_items=n)
        times = {}
        for variant, lib in libs.items():
            vals = torch.empty((qb, k), dtype=torch.float32, device=dev)
            ids = torch.empty((qb, k), dtype=torch.int32, device=dev)

            def call(lib=lib, vals=vals, ids=ids):
                rc = lib.ttamm_select_topk_from_groups(
                    s.data_ptr(), gi.data_ptr(), vals.data_ptr(), ids.data_ptr(), qb, s.shape[1],
                    k, k, n, torch.cuda.current_stream().cuda_stream,
                )
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")

            call()
            torch.cuda.synchronize()
            if not (torch.equal(vals.view(torch.int32), pv.view(torch.int32)) and torch.equal(ids, pi)):
                raise AssertionError(f"{variant}, {label}: kernel != plain")
            times[variant] = smoke.device_ms(call)
        sg, gl = s.view(qb, ng, g), gi.long()[:, :, None].expand(-1, -1, g)
        lib_ms = smoke.device_ms(lambda: torch.topk(torch.gather(sg, 1, gl).view(qb, -1), k))
        bound, _ = smoke.bound_ms(qb * k * g * 4 + gi.numel() * 4 + qb * k * 8)
        print(f"{label} [{qb}, {ng * g}] KG = k = {k}: "
              + " | ".join(f"{t} {ms:.4f} ms" for t, ms in times.items())
              + f" | gather + topk {lib_ms:.4f} ms | bound {bound:.4f} ms")
        del s, sg, gl
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
