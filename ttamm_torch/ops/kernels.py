"""The port's hand-written CUDA kernels, their plain PyTorch versions and
their launch counts.

One kernel per TPU kernel on the serving, training, eval and multi-device
paths (sources and design notes in ``ttamm_torch/csrc/``):

==================================  ==========================================
port (CUDA, ``sm_90a``)             TPU kernel it replaces
==================================  ==========================================
``small_k_topk``                    ``ttamm_tpu/ops/pallas/topk.py`` small_k_topk
``select_topk_from_groups``         ``ttamm_tpu/ops/pallas/topk.py``
                                    select_topk_from_groups
``groupmax_matmul``                 ``ttamm_tpu/ops/pallas/fused_mips.py`` groupmax_matmul
``rescore_groups``                  ``ttamm_tpu/ops/pallas/fused_mips.py`` rescore_groups
``gather_rows`` (+masked)           ``ttamm_tpu/ops/pallas/rows.py`` gather_rows
``scatter_set_rows`` (+masked)      ``ttamm_tpu/ops/pallas/rows.py`` scatter_set_rows
``sparse_adam_rows``                ``ttamm_tpu/ops/sparse_adam.py`` (its row-kernel
                                    path: gather_rows x 3, Adam, scatter_set_rows x 3)
``segment_second_moments`` (+bwd)   ``ttamm_tpu/ops/pallas/category_stats.py``
                                    segment_second_moments and its VJP
``dense_adam``                      none: XLA's fusion of ``ttamm_tpu/train/optim.py``
                                    (here eleven ``torch._foreach_*`` passes)
==================================  ==========================================

Each public function dispatches on where its input lies: a CPU tensor takes
the plain version (``*_plain``), a CUDA tensor launches the kernel through
``*_cuda``, which raises on anything the kernel does not take. Nothing falls
back from the card to the plain version. The plain versions also run on
CUDA tensors when called by name; that is how the kernels are checked on the
card.

What the kernels take: ``small_k_topk`` any ``0 < k <= W`` (one block a
row, 128 / 256 / 512 threads by width); ``groupmax_matmul`` bf16 operands
through TMA and ``wgmma`` (float32 ones rounded to bf16 and D % 8 != 0
zero-padded by the wrapper, in a copy), D up to ``MAX_DIM`` = 640, fewer
than 2^31 rows (``groupmax_matmul_fits``, by which the search routes);
``select_topk_from_groups`` up to 32 groups and any ``0 < k <= KG * 128``
(one block of 128 threads a row, the bound-and-rank steps of
``small_k_topk``); ``segment_second_moments`` and its backward D up to
``MAX_M2_DIM`` = 512, any C > 0 and N >= 0, over chunks of at most
``M2_CHUNK_ROWS`` rows of one category (the rows grouped once per loss
call, :class:`CategoryGrouping`): the forward on the f64 tensor cores with
f64 sums (M2 is the exact sum rounded to f32), the backward on the bf16
ones; ``sparse_adam_rows`` any N with D % 4 == 0 and 16-byte aligned
rows, each live row the target of one lane at most, and gives the bits of
the eager composition it fuses; ``dense_adam`` any list of float32
tensors (one launch for every ``ttamm_dense_adam_tensors_a_launch()`` of
them), bit for bit the ``torch._foreach_*`` composition it replaces.

The kernels are compiled by ``nvcc`` at first use into one shared library
with a plain C interface, loaded with ``ctypes`` (``build/ttamm_torch/``,
named by a hash of the sources and flags, so an edited source rebuilds).
Each launch goes on PyTorch's current stream; a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as _device  # noqa: F401  (owns the TF32 settings)

GROUP = 128  # items per pruning group
PAD_SCORE = -3.0e38  # score of rows at or beyond num_items in groupmax_matmul
# Widest embedding groupmax_matmul takes. Its block holds a 128-query tile
# of ceil(D / 64) 16 KB chunks, 8 KB of staged maxima, 1 KB of alignment and
# at least 3 16 KB item chunks (+16 B of barriers each) within the 232,448
# bytes of shared memory a Hopper block may use:
# 16384 * ceil(D / 64) <= 232448 - 1024 - 8192 - 8 - 3 * 16400 = 174024,
# so ceil(D / 64) <= 10 and D <= 640.
MAX_DIM = 640
# groupmax_matmul's TMA coordinates are int32: rows below 2^31.
_MAX_TMA_ROWS = 2**31 - 1
# Widest rows the second-moment kernels take: the backward stages a chunk's
# 128 bf16 rows and a 64-row bf16 H tile, (128 + 64) * (D' + 8) * 2 bytes
# with D' = D rounded up to 32, beside 1 KB of row ids, within a block's
# 232,448 bytes up to D = 576.
MAX_M2_DIM = 512
# Rows per chunk of one category (R; kChunkRows in category_stats.cu).
M2_CHUNK_ROWS = 128

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ttamm_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register / shared-memory / spill report -> build log
)
# Working-set budget of the plain versions' query blocks (plain versions
# only; the kernels need no blocking).
_PLAIN_BLOCK_BYTES = 1 << 30

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_launches = {
    "small_k_topk": 0,
    "select_topk_from_groups": 0,
    "groupmax_matmul": 0,
    "rescore_groups": 0,
    "gather_rows": 0,
    "gather_rows_masked": 0,
    "scatter_set_rows": 0,
    "scatter_set_rows_masked": 0,
    "sparse_adam_rows": 0,
    "dense_adam": 0,  # the dense Adam / AdamW update (no TPU kernel: XLA's fusion there)
    "segment_second_moments": 0,
    "segment_second_moments_bwd": 0,
    "category_grouping": 0,  # the moments' row grouping (glue, not a TPU kernel)
}


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


def _count(name: str, n: int = 1) -> None:
    with _lock:
        _launches[name] += n


def add_launch_counts(launches: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``launches`` to the counts: the launches of a
    captured CUDA graph, counted at each replay (a wrapper counts where it
    launches, and a replay runs no wrapper), and taken off again after the
    capture itself (``times=-1``), which launches nothing."""
    with _lock:
        for name, n in launches.items():
            _launches[name] += n * times


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def find_nvcc() -> str | None:
    """``nvcc`` from ``$CUDA_HOME``, ``$PATH`` or the toolkit's default prefix."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.is_file() else None


def compile_shared_library(
    compiler: str | None,
    flags: Sequence[str],
    sources: Sequence[Path],
    *,
    stem: str,
    missing: str,
    depends: Sequence[Path] = (),
    salt: str = "",
    build_dir: Path | None = None,
    log_name: str = "build.log",
    link_flags: Sequence[str] | None = None,
) -> Path:
    """``build_dir/{stem}_{hash}.so``, compiled from ``sources`` by
    ``compiler`` with ``flags`` unless it is there already; with
    ``link_flags``, each source is compiled to an object with ``flags`` and
    the objects are linked by a second command with ``link_flags`` alone (so
    a compile-only flag such as ``-ffast-math`` does not reach the link).
    The hash covers the flags, ``salt`` (what else the output depends on)
    and the names and bytes of ``sources`` and ``depends`` (headers), so an
    edited source rebuilds. The compiler's output goes to
    ``build_dir/log_name``. Raises ``RuntimeError(missing)`` when the
    library must be built and ``compiler`` is None, and quotes the
    compiler's stderr when it fails."""
    build_dir = build_dir or _BUILD_DIR
    digest = hashlib.sha256(" ".join(flags).encode() + salt.encode())
    if link_flags is not None:
        digest.update(b"\0link " + " ".join(link_flags).encode())
    for src in sorted({*sources, *depends}):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = build_dir / f"{stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    if compiler is None:
        raise RuntimeError(missing)
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    if link_flags is None:
        cmds = [[compiler, *flags, "-o", str(tmp), *(str(s) for s in sources)]]
    else:
        objects = [tmp.with_name(f"{tmp.name}.{i}.o") for i in range(len(sources))]
        cmds = [[compiler, *flags, "-c", "-o", str(o), str(src)] for o, src in zip(objects, sources)]
        cmds.append([compiler, *link_flags, "-o", str(tmp), *(str(o) for o in objects)])
    log = []
    try:
        for cmd in cmds:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{Path(compiler).name} failed ({proc.returncode}):\n{proc.stderr}")
    finally:
        (build_dir / log_name).write_text("".join(log), encoding="utf-8")
        if link_flags is not None:
            for o in objects:
                o.unlink(missing_ok=True)
    os.replace(tmp, lib_path)
    return lib_path


def build_library(build_dir: Path | None = None) -> Path:
    """Compile ``csrc/*.cu`` into one shared library (cached by content,
    headers included)."""
    return compile_shared_library(
        find_nvcc(), NVCC_FLAGS, sorted(_CSRC.glob("*.cu")), stem="libttamm_kernels",
        depends=sorted(_CSRC.glob("*.cuh")), build_dir=build_dir,
        missing="cannot build the CUDA kernels: nvcc not found (set CUDA_HOME or put nvcc on PATH)",
    )


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.ttamm_error_string.argtypes = [i32]
            lib.ttamm_error_string.restype = ctypes.c_char_p
            lib.ttamm_small_k_topk.argtypes = [p, p, p, i32, i32, i32, p]
            lib.ttamm_small_k_topk.restype = i32
            lib.ttamm_select_topk_from_groups.argtypes = [p, p, p, p, i32, i64, i32, i32, i64, p]
            lib.ttamm_select_topk_from_groups.restype = i32
            lib.ttamm_groupmax_matmul.argtypes = [p, p, p, i32, i64, i64, i32, p]
            lib.ttamm_groupmax_matmul.restype = i32
            lib.ttamm_rescore_groups.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, p]
            lib.ttamm_rescore_groups.restype = i32
            lib.ttamm_gather_rows.argtypes = [p, p, p, i64, i64, i32, p]
            lib.ttamm_gather_rows.restype = i32
            lib.ttamm_scatter_set_rows.argtypes = [p, p, p, i64, i64, i32, p]
            lib.ttamm_scatter_set_rows.restype = i32
            lib.ttamm_gather_rows_masked.argtypes = [p, p, p, i64, i64, i32, i64, p]
            lib.ttamm_gather_rows_masked.restype = i32
            lib.ttamm_sparse_adam_rows.argtypes = [p, p, p, p, p, i64, i64, i32, p, i32, p]
            lib.ttamm_sparse_adam_rows.restype = i32
            lib.ttamm_segment_second_moments.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32, p]
            lib.ttamm_segment_second_moments.restype = i32
            lib.ttamm_segment_second_moments_bwd.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32, p]
            lib.ttamm_segment_second_moments_bwd.restype = i32
            lib.ttamm_category_grouping.argtypes = [p, i32, i32, i32, p, p, p, p, i32, p, p, p]
            lib.ttamm_category_grouping.restype = i32
            lib.ttamm_category_grouping_warps.argtypes = [i32]
            lib.ttamm_category_grouping_warps.restype = i32
            pp, f32 = ctypes.POINTER(ctypes.c_void_p), ctypes.c_float
            lib.ttamm_dense_adam.argtypes = [pp, pp, pp, pp, ctypes.POINTER(i64), i32, p,
                                             f32, f32, f32, f32, f32, f32, i32, p]
            lib.ttamm_dense_adam.restype = i32
            lib.ttamm_dense_adam_tensors_a_launch.argtypes = []
            lib.ttamm_dense_adam_tensors_a_launch.restype = i32
            lib.ttamm_graph_if.argtypes = [p, i32, p, p]
            lib.ttamm_graph_if.restype = i32
            _lib = lib
        return _lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA kernel given a tensor on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"{name}: kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(dev)} is "
            f"sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
        )
    return dev


def _launch(name: str, dev: torch.device, *args, counter: str | None = None,
            launches: int = 1) -> None:
    """Call the C entry point ``ttamm_<name>`` on the current stream of
    ``dev``; raise if the launch was refused, else count its ``launches``
    (under ``counter``, default ``name``)."""
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"ttamm_{name}")(*args, stream)
    if rc != 0:
        msg = lib.ttamm_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
    _count(counter or name, launches)


def _f32_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone int32 image of f32 values (the TPU kernel's ``_f32_keys``)."""
    u = x.contiguous().view(torch.int32)
    return torch.where(u < 0, u ^ 0x7FFFFFFF, u)


# ---------------------------------------------------------------------------
# small_k_topk
# ---------------------------------------------------------------------------


def small_k_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-row top-k of f32 rows: ``(values f32 [B, k], indices i32
    [B, k])``, descending, ties to the lowest index, values bit-identical to
    the inputs. Any ``0 < k <= W``; the kernel reads each row once and its
    cost does not grow with k on rows without heavy ties at the top (see
    ``csrc/small_k_topk.cu``)."""
    if x.device.type == "cpu":
        return small_k_topk_plain(x, k)
    return small_k_topk_cuda(x, k)


def _check_topk(x: torch.Tensor, k: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"small_k_topk expects 2-D float32 rows, got {x.dtype} {tuple(x.shape)}")
    if not 0 < k <= x.shape[1]:
        raise ValueError(f"small_k_topk: k={k} unsupported for width {x.shape[1]}")


def small_k_topk_plain(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable descending sort of the int32 key image, sliced to ``k``.

    (``torch.topk`` promises no order among ties, so it is not the reference;
    sorting keys rather than floats also orders -0.0 below +0.0, as the
    kernel and the TPU kernel do.)
    """
    _check_topk(x, k)
    order = torch.sort(_f32_keys(x), dim=1, descending=True, stable=True).indices
    idx = order[:, :k]
    return torch.gather(x, 1, idx), idx.to(torch.int32)


def small_k_topk_cuda(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    dev = _check_cuda("small_k_topk", x)
    _check_topk(x, k)
    batch, width = x.shape
    vals = torch.empty((batch, k), dtype=torch.float32, device=dev)
    idx = torch.empty((batch, k), dtype=torch.int32, device=dev)
    if batch:
        _launch(
            "small_k_topk", dev,
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), batch, width, k,
        )
    return vals, idx


# ---------------------------------------------------------------------------
# select_topk_from_groups
# ---------------------------------------------------------------------------

MAX_SELECT_GROUPS = 32  # the widest group selection the kernel takes


def select_topk_from_groups(
    scores: torch.Tensor, group_ids: torch.Tensor, *, k: int, num_items: int,
    group: int = GROUP,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k among each row's selected groups of a float32 score slab.

    ``scores`` f32 ``[B, NG * group]`` holds item ``n`` at column ``n``;
    ``group_ids`` int32 ``[B, KG]`` names each row's selected groups
    (distinct within a row). Returns ``(values f32 [B, k], item ids int32
    [B, k])``: bit-identical to gathering the KG group rows and taking a
    stable descending top-k, so ties go to the lower candidate position
    (group rank, then lane). Pad lanes (``id >= num_items``), and every lane
    of a group id outside ``[0, NG)``, score ``finfo(f32).min``; other
    columns are taken as they stand (blocked columns already hold
    ``finfo(f32).min``). Domain: ``0 < KG <= 32``, ``0 < k <= KG * group``.
    """
    if scores.device.type == "cpu":
        return select_topk_from_groups_plain(
            scores, group_ids, k=k, num_items=num_items, group=group
        )
    return select_topk_from_groups_cuda(
        scores, group_ids, k=k, num_items=num_items, group=group
    )


def _check_select(scores: torch.Tensor, group_ids: torch.Tensor, k: int, group: int) -> None:
    if scores.dtype != torch.float32 or scores.dim() != 2 or scores.shape[1] % group:
        raise ValueError(
            f"select_topk_from_groups expects a 2-D float32 slab of whole {group}-item "
            f"groups, got {scores.dtype} {tuple(scores.shape)}"
        )
    if group_ids.dtype != torch.int32 or group_ids.dim() != 2 or group_ids.shape[0] != scores.shape[0]:
        raise ValueError(
            f"select_topk_from_groups: group_ids must be int32 [{scores.shape[0]}, KG], "
            f"got {group_ids.dtype} {tuple(group_ids.shape)}"
        )
    kg = group_ids.shape[1]
    if not 0 < kg <= MAX_SELECT_GROUPS:
        raise ValueError(f"select_topk_from_groups: {kg} groups (1..{MAX_SELECT_GROUPS})")
    if not 0 < k <= kg * group:
        raise ValueError(f"select_topk_from_groups: k={k} unsupported for {kg} groups of {group}")


def select_topk_from_groups_plain(
    scores: torch.Tensor, group_ids: torch.Tensor, *, k: int, num_items: int,
    group: int = GROUP,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.gather`` of the groups' rows, then ``small_k_topk_plain``."""
    _check_select(scores, group_ids, k, group)
    batch, ng = scores.shape[0], scores.shape[1] // group
    gi = group_ids.long()
    in_range = (gi >= 0) & (gi < ng)
    cand = torch.gather(
        scores.view(batch, ng, group), 1,
        torch.where(in_range, gi, 0)[:, :, None].expand(-1, -1, group),
    )
    ids = gi[:, :, None] * group + torch.arange(group, device=gi.device)
    cand = cand.masked_fill((ids >= num_items) | ~in_range[:, :, None], torch.finfo(torch.float32).min)
    vals, pos = small_k_topk_plain(cand.reshape(batch, -1), k)
    return vals, torch.gather(ids.reshape(batch, -1), 1, pos.long()).to(torch.int32)


def select_topk_from_groups_cuda(
    scores: torch.Tensor, group_ids: torch.Tensor, *, k: int, num_items: int,
    group: int = GROUP,
) -> tuple[torch.Tensor, torch.Tensor]:
    dev = _check_cuda("select_topk_from_groups", scores, group_ids)
    _check_select(scores, group_ids, k, group)
    if group != GROUP:
        raise ValueError(f"select_topk_from_groups: the kernel takes groups of {GROUP}, not {group}")
    if scores.data_ptr() % 16:
        raise ValueError("select_topk_from_groups: the slab must be 16-byte aligned")
    batch, width = scores.shape
    vals = torch.empty((batch, k), dtype=torch.float32, device=dev)
    ids = torch.empty((batch, k), dtype=torch.int32, device=dev)
    if batch:
        _launch(
            "select_topk_from_groups", dev,
            scores.data_ptr(), group_ids.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            batch, width, group_ids.shape[1], k, num_items,
        )
    return vals, ids


# ---------------------------------------------------------------------------
# groupmax_matmul
# ---------------------------------------------------------------------------


def groupmax_matmul(
    queries: torch.Tensor, items: torch.Tensor, num_items: int
) -> torch.Tensor:
    """Per-128-item-group maxima of ``bf16(Q) . bf16(I)^T`` (f32 sums):
    f32 ``[B, ceil(N / 128)]``. Rows at or beyond ``num_items`` score
    ``PAD_SCORE`` (-3e38) before the max."""
    if queries.device.type == "cpu":
        return groupmax_matmul_plain(queries, items, num_items)
    return groupmax_matmul_cuda(queries, items, num_items)


def _check_groupmax(queries: torch.Tensor, items: torch.Tensor, num_items: int) -> None:
    if queries.dim() != 2 or items.dim() != 2 or queries.shape[1] != items.shape[1]:
        raise ValueError(
            f"groupmax_matmul: shapes {tuple(queries.shape)} x {tuple(items.shape)}"
        )
    if queries.dtype != items.dtype or queries.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"groupmax_matmul: dtypes {queries.dtype}, {items.dtype} "
            "(both float32 or both bfloat16)"
        )
    if not 0 <= num_items <= items.shape[0]:
        raise ValueError(f"groupmax_matmul: num_items={num_items} > {items.shape[0]} rows")


def groupmax_matmul_plain(
    queries: torch.Tensor, items: torch.Tensor, num_items: int
) -> torch.Tensor:
    _check_groupmax(queries, items, num_items)
    batch = queries.shape[0]
    ng = -(-items.shape[0] // GROUP)
    q = queries.to(torch.bfloat16).float()
    it = items.to(torch.bfloat16).float()
    if ng * GROUP != it.shape[0]:
        it = torch.cat([it, it.new_zeros(ng * GROUP - it.shape[0], it.shape[1])])
    invalid = torch.arange(ng * GROUP, device=it.device) >= num_items
    out = torch.empty((batch, ng), dtype=torch.float32, device=queries.device)
    qb = max(1, _PLAIN_BLOCK_BYTES // (ng * GROUP * 4))
    for start in range(0, batch, qb):
        s = (q[start : start + qb] @ it.T).masked_fill_(invalid, PAD_SCORE)
        out[start : start + qb] = s.view(s.shape[0], ng, GROUP).amax(dim=-1)
    return out


def groupmax_matmul_fits(batch: int, n_rows: int, dim: int) -> bool:
    """Whether ``groupmax_matmul_cuda`` takes ``[batch, dim]`` queries
    against ``[n_rows, dim]`` items: D up to ``MAX_DIM`` (its shared
    memory), and rows and queries within the TMA coordinates. The search
    routes by it on every device, so the CPU picks what the card would."""
    return dim <= MAX_DIM and n_rows <= _MAX_TMA_ROWS and batch <= _MAX_TMA_ROWS


def groupmax_matmul_cuda(
    queries: torch.Tensor, items: torch.Tensor, num_items: int
) -> torch.Tensor:
    """The kernel takes bf16 operands with ``D % 8 == 0`` (TMA's 16-byte row
    pitch): float32 operands are rounded to bf16 (round-to-nearest-even, the
    rounding of the plain version) and a narrower D is zero-padded, each in a
    copy; that is the same function."""
    dev = _check_cuda("groupmax_matmul", queries, items)
    _check_groupmax(queries, items, num_items)
    batch, dim = queries.shape
    n_rows = items.shape[0]
    ng = -(-n_rows // GROUP)
    if not groupmax_matmul_fits(batch, n_rows, dim):
        raise ValueError(
            f"groupmax_matmul: [{batch}, {dim}] x [{n_rows}, {dim}] is beyond the kernel "
            f"(D <= {MAX_DIM}, rows < 2^31)"
        )
    q, it = queries.to(torch.bfloat16), items.to(torch.bfloat16)
    if dim % 8:
        pad = (0, 8 - dim % 8)
        q, it = torch.nn.functional.pad(q, pad), torch.nn.functional.pad(it, pad)
    # TMA reads from 16-byte aligned rows
    q, it = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, it))
    out = torch.empty((batch, ng), dtype=torch.float32, device=dev)
    if batch and ng:
        _launch(
            "groupmax_matmul", dev,
            q.data_ptr(), it.data_ptr(), out.data_ptr(), batch, n_rows, num_items, q.shape[1],
        )
    return out


# ---------------------------------------------------------------------------
# rescore_groups
# ---------------------------------------------------------------------------


def rescore_groups(
    queries: torch.Tensor, items_grouped: torch.Tensor, gids: torch.Tensor
) -> torch.Tensor:
    """Scores of each query's selected groups: f32 ``[B, KG * 128]`` with
    ``out[b, j*128 + l] = sum_d bf16(q[b, d]) * bf16(items[gids[b, j], l, d])``
    summed in f32."""
    if queries.device.type == "cpu":
        return rescore_groups_plain(queries, items_grouped, gids)
    return rescore_groups_cuda(queries, items_grouped, gids)


def _check_rescore(
    queries: torch.Tensor, items_grouped: torch.Tensor, gids: torch.Tensor
) -> None:
    if (
        queries.dim() != 2
        or items_grouped.dim() != 3
        or items_grouped.shape[1] != GROUP
        or items_grouped.shape[2] != queries.shape[1]
        or gids.dim() != 2
        or gids.shape[0] != queries.shape[0]
    ):
        raise ValueError(
            f"rescore_groups: shapes {tuple(queries.shape)}, "
            f"{tuple(items_grouped.shape)}, {tuple(gids.shape)}"
        )
    if queries.dtype != items_grouped.dtype or queries.dtype not in (
        torch.float32, torch.bfloat16,
    ):
        raise ValueError(
            f"rescore_groups: dtypes {queries.dtype}, {items_grouped.dtype}"
        )
    if gids.dtype != torch.int32:
        raise ValueError(f"rescore_groups: gids must be int32, got {gids.dtype}")


def rescore_groups_plain(
    queries: torch.Tensor, items_grouped: torch.Tensor, gids: torch.Tensor
) -> torch.Tensor:
    _check_rescore(queries, items_grouped, gids)
    batch, dim = queries.shape
    kg = gids.shape[1]
    q = queries.to(torch.bfloat16).float()
    out = torch.empty((batch, kg * GROUP), dtype=torch.float32, device=queries.device)
    qb = max(1, _PLAIN_BLOCK_BYTES // max(kg * GROUP * dim * 4, 1))
    for start in range(0, batch, qb):
        cand = items_grouped[gids[start : start + qb].long()]  # [qb, kg, G, D]
        cand = cand.to(torch.bfloat16).float()
        scores = torch.einsum("bd,bkgd->bkg", q[start : start + qb], cand)
        out[start : start + qb] = scores.reshape(-1, kg * GROUP)
    return out


def rescore_groups_cuda(
    queries: torch.Tensor, items_grouped: torch.Tensor, gids: torch.Tensor
) -> torch.Tensor:
    dev = _check_cuda("rescore_groups", queries, items_grouped, gids)
    _check_rescore(queries, items_grouped, gids)
    batch, dim = queries.shape
    kg = gids.shape[1]
    out = torch.empty((batch, kg * GROUP), dtype=torch.float32, device=dev)
    if batch and kg:
        _launch(
            "rescore_groups", dev,
            queries.data_ptr(), items_grouped.data_ptr(), gids.data_ptr(),
            out.data_ptr(), batch, items_grouped.shape[0], dim, kg,
            int(queries.dtype == torch.bfloat16),
        )
    return out


# ---------------------------------------------------------------------------
# gather_rows / scatter_set_rows
# ---------------------------------------------------------------------------


def _check_rows(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"{name}: table must be 2-D float32, got {table.dtype} {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be 1-D int32, got {idx.dtype} {tuple(idx.shape)}")


def _check_vec4(name: str, *tensors: torch.Tensor) -> None:
    """The row kernels move 16-byte vectors: D % 4 == 0, 16-byte aligned."""
    for t in tensors:
        if t.shape[-1] % 4 or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must have D % 4 == 0 and be 16-byte aligned")


def gather_rows(
    table: torch.Tensor, idx: torch.Tensor, *, masked: bool = False, base: int = 0
) -> torch.Tensor:
    """``table[idx]``: f32 ``[N, D]`` rows of a f32 ``[rows, D]`` table at
    int32 indices in ``[0, rows)``; any N.

    ``masked=True`` (kernel ``gather_rows_masked``): the lookup of a
    row-sharded table whose local shard ``table`` holds global rows
    ``[base, base + rows)``. Lane ``r`` gets ``table[idx[r] - base]`` where
    that lies in the shard, and zeros elsewhere (``idx`` global ids; with
    ``base`` 0, every ``idx < 0`` lane is zeros). ``base`` is read only
    with ``masked=True``."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx, masked=masked, base=base)
    return gather_rows_cuda(table, idx, masked=masked, base=base)


def gather_rows_plain(
    table: torch.Tensor, idx: torch.Tensor, *, masked: bool = False, base: int = 0
) -> torch.Tensor:
    _check_rows("gather_rows", table, idx)
    if not masked:
        return table[idx]
    local = idx.long() - base
    live = (local >= 0) & (local < table.shape[0])
    if _capturing(table):
        # the same rows without a boolean index (a host sync), which a
        # captured step cannot hold
        if not table.shape[0]:
            return table.new_zeros((idx.shape[0], table.shape[1]))
        rows = table[local.clamp(0, table.shape[0] - 1)]
        return torch.where(live[:, None], rows, 0.0)
    out = table.new_zeros((idx.shape[0], table.shape[1]))
    out[live] = table[local[live]]
    return out


def _capturing(t: torch.Tensor) -> bool:
    """True inside a CUDA graph capture on ``t``'s card: a plain version
    called on the card there (the checks do so) takes a form without a host
    sync, with the same bits."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def gather_rows_cuda(
    table: torch.Tensor, idx: torch.Tensor, *, masked: bool = False, base: int = 0
) -> torch.Tensor:
    name = "gather_rows_masked" if masked else "gather_rows"
    dev = _check_cuda(name, table, idx)
    _check_rows(name, table, idx)
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32, device=dev)
    _check_vec4(name, table, out)
    if idx.shape[0]:
        args = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], table.shape[0],
                table.shape[1])
        _launch(name, dev, *args, *([base] if masked else []))
    return out


def scatter_set_rows(
    table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *, masked: bool = False
) -> torch.Tensor:
    """``table[idx] = rows`` in place; returns ``table``. Duplicate indices
    race (one row wins), so callers route duplicate lanes to a scratch row
    whose value is never read.

    ``masked=True`` (the shard-local form, counted as
    ``scatter_set_rows_masked``): a lane with ``idx < 0`` writes nothing, and
    lanes that target one row must carry identical bytes (then their race is
    benign)."""
    if table.device.type == "cpu":
        return scatter_set_rows_plain(table, idx, rows, masked=masked)
    return scatter_set_rows_cuda(table, idx, rows, masked=masked)


def _check_scatter(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    _check_rows("scatter_set_rows", table, idx)
    if rows.dtype != torch.float32 or rows.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(
            f"scatter_set_rows: rows {rows.dtype} {tuple(rows.shape)} for "
            f"{idx.shape[0]} indices into {tuple(table.shape)}"
        )


def scatter_set_rows_plain(
    table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *, masked: bool = False
) -> torch.Tensor:
    _check_scatter(table, idx, rows)
    if masked and _capturing(table):
        # the skipped lanes write a row past the table, dropped after
        grown = torch.cat([table, table.new_zeros((1, table.shape[1]))])
        grown.index_copy_(0, torch.where(idx >= 0, idx.long(), table.shape[0]), rows)
        return table.copy_(grown[:-1])
    if masked:
        live = idx >= 0
        idx, rows = idx[live], rows[live]
    return table.index_copy_(0, idx.long(), rows)


def scatter_set_rows_cuda(
    table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *, masked: bool = False
) -> torch.Tensor:
    name = "scatter_set_rows_masked" if masked else "scatter_set_rows"
    dev = _check_cuda(name, table, idx, rows)
    _check_scatter(table, idx, rows)
    _check_vec4(name, table, rows)
    if idx.shape[0]:
        # one kernel (it writes nothing for idx < 0), counted per form
        _launch(
            "scatter_set_rows", dev, table.data_ptr(), idx.data_ptr(), rows.data_ptr(),
            idx.shape[0], table.shape[0], table.shape[1], counter=name,
        )
    return table


# ---------------------------------------------------------------------------
# sparse_adam_rows: gather, Adam and scatter of one table in one pass
# ---------------------------------------------------------------------------


def sparse_adam_rows(
    table: torch.Tensor, m: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
    grads: torch.Tensor, *, scalars: torch.Tensor | None = None, decay: bool = False,
    step: int | None = None, lr: float | None = None, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 0.0,
) -> None:
    """One sparse-row Adam step in place: for each lane ``r`` with ``i =
    idx[r] >= 0``, ``table[i]``, ``m[i]`` and ``v[i]`` take
    :func:`ttamm_torch.ops.sparse_adam.adam_rows` of those rows and
    ``grads[r]``; a lane with ``idx < 0`` reads and writes nothing.

    f32 ``[rows, D]`` table, m and v (distinct tensors), int32 ``[N]``
    indices, f32 ``[N, D]`` gradients. Each live row is the target of one
    lane at most: two lanes on one row would apply the update twice, in an
    order the kernel does not fix.

    The step's scalars: ``scalars``, the f32 ``[ADAM_SCALARS]`` row of
    :func:`adam_scalars` on the table's device, which the kernel reads from
    device memory (so a captured launch reads each replay's own step), and
    ``decay`` (``weight_decay != 0``); or by value, ``step`` (1-indexed),
    ``lr``, ``b1``, ``b2``, ``eps`` and ``weight_decay``, from which the row
    is formed and uploaded here."""
    scalars, decay = _adam_row(table, scalars, decay, step, lr, b1, b2, eps, weight_decay)
    if table.device.type == "cpu":
        return sparse_adam_rows_plain(table, m, v, idx, grads, scalars=scalars, decay=decay)
    return sparse_adam_rows_cuda(table, m, v, idx, grads, scalars=scalars, decay=decay)


def _check_sparse_adam(
    table: torch.Tensor, m: torch.Tensor, v: torch.Tensor, idx: torch.Tensor, grads: torch.Tensor
) -> None:
    _check_rows("sparse_adam_rows", table, idx)
    for name, t in (("m", m), ("v", v)):
        if t.shape != table.shape or t.dtype != table.dtype:
            raise ValueError(
                f"sparse_adam_rows: {name} {t.dtype} {tuple(t.shape)} for a table "
                f"{table.dtype} {tuple(table.shape)}"
            )
    if grads.dtype != torch.float32 or grads.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(
            f"sparse_adam_rows: grads {grads.dtype} {tuple(grads.shape)} for "
            f"{idx.shape[0]} indices into {tuple(table.shape)}"
        )
    spans = sorted(
        (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
        for t in (table, m, v, grads) if t.numel()
    )
    if any(lo < hi for (_, hi), (lo, _) in zip(spans, spans[1:])):
        raise ValueError("sparse_adam_rows: table, m, v and grads must be distinct tensors")


ADAM_SCALARS = 9  # the f32 scalars of one sparse Adam step (adam_scalars)


def adam_scalars(*, step: int, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float) -> np.ndarray:
    """The f32 ``[ADAM_SCALARS]`` scalars of one step, as eager PyTorch on the
    card forms them in the by-value ``adam_rows``: each Python scalar cast to
    f32 once (``1 - b1``, ``1 - b2`` and ``lr * weight_decay`` formed in
    double first), and a tensor divided by a Python scalar ``c`` multiplied
    by ``1 / c`` formed in double and rounded to f32 once (measured on the
    card, PyTorch 2.11: ``scripts/sparse_adam_variants.py``; neither the f32
    reciprocal of the f32 scalar nor an IEEE division gives its bits). In
    order: b1, 1 - b1, b2, 1 - b2, 1 / (1 - b1^step), 1 / (1 - b2^step),
    eps, lr, lr * weight_decay. Host arithmetic: no sync."""
    return np.array(
        [b1, 1.0 - b1, b2, 1.0 - b2, 1.0 / (1.0 - b1**step), 1.0 / (1.0 - b2**step), eps, lr,
         lr * weight_decay],
        dtype=np.float32,
    )


def adam_row(device: torch.device, **hyper) -> dict:
    """:func:`sparse_adam_rows`' ``scalars`` and ``decay`` for one step given
    by value (``hyper``: :func:`adam_scalars`' keywords): the row uploaded to
    ``device``."""
    return dict(scalars=torch.from_numpy(adam_scalars(**hyper)).to(device),
                decay=bool(hyper["weight_decay"]))


def _adam_row(table, scalars, decay, step, lr, b1, b2, eps, weight_decay):
    """``(scalars, decay)`` of :func:`sparse_adam_rows`: as given, or formed
    from the by-value keywords on the table's device."""
    if scalars is not None:
        return scalars, bool(decay)
    if step is None or lr is None:
        raise ValueError("sparse_adam_rows: give scalars, or step and lr")
    row = adam_row(table.device, step=step, lr=lr, b1=b1, b2=b2, eps=eps,
                   weight_decay=weight_decay)
    return row["scalars"], row["decay"]


def _check_scalars(table: torch.Tensor, scalars: torch.Tensor) -> None:
    if (scalars.dtype != torch.float32 or scalars.shape != (ADAM_SCALARS,)
            or scalars.device != table.device or not scalars.is_contiguous()):
        raise ValueError(
            f"sparse_adam_rows: scalars must be a contiguous float32 [{ADAM_SCALARS}] on "
            f"{table.device}, got {scalars.dtype} {tuple(scalars.shape)} on {scalars.device}"
        )


def sparse_adam_rows_plain(
    table: torch.Tensor, m: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
    grads: torch.Tensor, *, scalars: torch.Tensor | None = None, decay: bool = False,
    step: int | None = None, lr: float | None = None, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 0.0,
) -> None:
    """The unfused composition: the masked plain gathers of m, v and the
    weights, ``adam_rows``, the masked plain scatters back (the step's
    scalars as :func:`sparse_adam_rows` takes them)."""
    from .sparse_adam import unfused_row_update

    scalars, decay = _adam_row(table, scalars, decay, step, lr, b1, b2, eps, weight_decay)
    _check_sparse_adam(table, m, v, idx, grads)
    _check_scalars(table, scalars)
    unfused_row_update(
        table, m, v, idx, grads, gather=functools.partial(gather_rows_plain, masked=True),
        scatter=functools.partial(scatter_set_rows_plain, masked=True), scalars=scalars,
        decay=decay,
    )


def sparse_adam_rows_cuda(
    table: torch.Tensor, m: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
    grads: torch.Tensor, *, scalars: torch.Tensor | None = None, decay: bool = False,
    step: int | None = None, lr: float | None = None, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 0.0,
) -> None:
    """The kernel (``csrc/rows.cu``), which reads the step's scalars through
    a pointer; the arguments are checked before the device."""
    scalars, decay = _adam_row(table, scalars, decay, step, lr, b1, b2, eps, weight_decay)
    _check_sparse_adam(table, m, v, idx, grads)
    _check_vec4("sparse_adam_rows", table, m, v, grads)
    dev = _check_cuda("sparse_adam_rows", table, m, v, idx, grads)
    _check_scalars(table, scalars)
    if idx.shape[0]:
        _launch(
            "sparse_adam_rows", dev, table.data_ptr(), m.data_ptr(), v.data_ptr(),
            idx.data_ptr(), grads.data_ptr(), idx.shape[0], table.shape[0], table.shape[1],
            scalars.data_ptr(), int(decay),
        )


# ---------------------------------------------------------------------------
# dense_adam: the dense Adam / AdamW update of a list of tensors in one pass
# ---------------------------------------------------------------------------


def dense_adam(
    params: list[torch.Tensor], grads: list[torch.Tensor], m: list[torch.Tensor],
    v: list[torch.Tensor], *, scalars: torch.Tensor, b1: float, b2: float, eps: float,
    weight_decay: float, decoupled: bool,
) -> None:
    """One dense Adam (``decoupled=False``: L2 decay folded into the
    gradient) or AdamW (decoupled decay ``p * first``) step in place on
    ``params``, ``m`` and ``v`` from ``grads``: ``train/optim.py``'s update,
    the step's f32 scalars ``(first, step_size, bc2)`` read from
    ``scalars`` (``dense_scalars``' row on the parameters' device). CPU
    tensors take the ``torch._foreach_*`` composition
    (:func:`dense_adam_plain`); CUDA tensors ``csrc/dense_adam.cu``, bit
    for bit the composition on the card."""
    if not params:
        return
    fn = dense_adam_plain if params[0].device.type == "cpu" else dense_adam_cuda
    fn(params, grads, m, v, scalars=scalars, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
       decoupled=decoupled)


def dense_adam_plain(
    params: list[torch.Tensor], grads: list[torch.Tensor], m: list[torch.Tensor],
    v: list[torch.Tensor], *, scalars: torch.Tensor, b1: float, b2: float, eps: float,
    weight_decay: float, decoupled: bool,
) -> None:
    """The composition of eleven ``torch._foreach_*`` passes, the step's
    scalars read as 0-d tensors; on the card it is what the kernel is held
    to."""
    first, step_size, bc2 = scalars.unbind()
    if not decoupled and weight_decay:
        grads = torch._foreach_add(grads, params, alpha=weight_decay)
    if decoupled and weight_decay:
        torch._foreach_mul_(params, first)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, grads, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
    denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, denom)
    torch._foreach_mul_(update, step_size)
    torch._foreach_add_(params, update)


def _check_dense_adam(
    params: list[torch.Tensor], grads: list[torch.Tensor], m: list[torch.Tensor],
    v: list[torch.Tensor], scalars: torch.Tensor,
) -> torch.device:
    """The arguments, then the device (as ``_check_cuda``)."""
    if not len(params) == len(grads) == len(m) == len(v):
        raise ValueError(
            f"dense_adam: {len(params)} params, {len(grads)} grads, {len(m)} m and {len(v)} v")
    for group in zip(params, grads, m, v):
        if any(t.dtype != torch.float32 or t.shape != group[0].shape for t in group):
            raise ValueError(
                "dense_adam: params, grads, m and v must be float32 of one shape each, got "
                + ", ".join(f"{t.dtype} {tuple(t.shape)}" for t in group))
    tensors = (*params, *grads, *m, *v)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_adam: tensors must be contiguous")
    if scalars.dtype != torch.float32 or scalars.shape != (3,):
        raise ValueError(
            f"dense_adam: scalars must be float32 [3], got {scalars.dtype} {tuple(scalars.shape)}")
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * 4) for t in tensors if t.numel())
    if any(lo < hi for (_, hi), (lo, _) in zip(spans, spans[1:])):
        raise ValueError("dense_adam: params, grads, m and v must be distinct tensors")
    return _check_cuda("dense_adam", *tensors, scalars)


def dense_adam_cuda(
    params: list[torch.Tensor], grads: list[torch.Tensor], m: list[torch.Tensor],
    v: list[torch.Tensor], *, scalars: torch.Tensor, b1: float, b2: float, eps: float,
    weight_decay: float, decoupled: bool,
) -> None:
    """The kernel (``csrc/dense_adam.cu``): the non-empty tensors in one
    call, which launches once for every
    ``ttamm_dense_adam_tensors_a_launch()`` of them; the step's scalars read
    through a pointer, the constants passed as f32 (each double rounded
    once, as PyTorch converts a Python scalar for a ``_foreach_`` op)."""
    dev = _check_dense_adam(params, grads, m, v, scalars)
    # the kernel's decay modes: 0 none, 1 AdamW's p * first, 2 Adam's L2 in g
    decay = 0 if not weight_decay else 1 if decoupled else 2
    consts = [ctypes.c_float(c) for c in (b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay)]
    live = [group for group in zip(params, m, v, grads) if group[0].numel()]
    if not live:
        return
    ptrs = [(ctypes.c_void_p * len(live))(*(group[j].data_ptr() for group in live))
            for j in range(4)]
    counts = (ctypes.c_int64 * len(live))(*(group[0].numel() for group in live))
    per_launch = load_library().ttamm_dense_adam_tensors_a_launch()
    _launch("dense_adam", dev, *ptrs, counts, len(live), scalars.data_ptr(), *consts, decay,
            launches=-(-len(live) // per_launch))


# ---------------------------------------------------------------------------
# segment_second_moments (forward and backward)
# ---------------------------------------------------------------------------


class CategoryGrouping(NamedTuple):
    """The moments kernels' row grouping and work list, built once per loss
    call on the device (:func:`category_grouping`) and shared by the forward
    and the backward. R = ``M2_CHUNK_ROWS``.

    ``order`` int64 ``[N]``: the row ids, stably sorted by category, ids
    outside ``[0, C)`` last (run ``C``); ``offsets`` int32 ``[C + 2]``: run
    ``c`` is ``order[offsets[c]:offsets[c + 1]]``; ``chunk_offsets`` int32
    ``[C + 2]``: run ``c`` is cut into chunks of R rows, work items
    ``[chunk_offsets[c], chunk_offsets[c + 1])``; ``chunk_cat`` int32
    ``[ceil(N / R) + C + 1]``: each work item's run, ``C + 1`` past the
    last chunk. Item ``j`` of run ``c`` covers ``order[b:min(b + R,
    offsets[c + 1])]`` with ``b = offsets[c] + (j - chunk_offsets[c]) * R``.
    """

    order: torch.Tensor
    offsets: torch.Tensor
    chunk_offsets: torch.Tensor
    chunk_cat: torch.Tensor


def category_grouping(cat_ids: torch.Tensor, num_categories: int) -> CategoryGrouping | None:
    """The row grouping that :func:`segment_second_moments` and its
    backward take, built once for both by one kernel launch; ``None`` for
    ids on the CPU, whose plain versions need none."""
    if cat_ids.device.type == "cpu":
        return None
    return _group_by_category_cuda(cat_ids, num_categories)


def segment_second_moments(
    cat_ids: torch.Tensor, x: torch.Tensor, num_categories: int,
    grouping: CategoryGrouping | None = None,
) -> torch.Tensor:
    """``M2[c] = sum_{n: cat_ids[n] = c} bf16(x_n) bf16(x_n)^T`` summed in
    f32: ``[C, D, D]`` for int ``cat_ids [N]`` and f32 ``x [N, D]``; rows
    with ids outside ``[0, C)`` add nothing. ``grouping``: the rows'
    :class:`CategoryGrouping`, built here when not given (the kernel's; the
    plain version does not need it)."""
    if x.device.type == "cpu":
        return segment_second_moments_plain(cat_ids, x, num_categories)
    return segment_second_moments_cuda(cat_ids, x, num_categories, grouping)


def segment_second_moments_bwd(
    cat_ids: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
    grouping: CategoryGrouping | None = None,
) -> torch.Tensor:
    """The gradient of :func:`segment_second_moments` for the symmetrised
    cotangent ``h = G + G^T`` ``[C, D, D]``: ``dx_n = bf16(h_c) bf16(x_n)``
    (f32 sums), zero for ids outside ``[0, C)``; ``grouping`` as there."""
    if x.device.type == "cpu":
        return segment_second_moments_bwd_plain(cat_ids, x, h)
    return segment_second_moments_bwd_cuda(cat_ids, x, h, grouping)


def _check_m2(cat_ids: torch.Tensor, x: torch.Tensor, num_categories: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"segment_second_moments: x must be 2-D float32, got {x.dtype} {tuple(x.shape)}")
    if cat_ids.shape != (x.shape[0],) or cat_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"segment_second_moments: cat_ids {cat_ids.dtype} {tuple(cat_ids.shape)} "
            f"for {x.shape[0]} rows"
        )
    if num_categories <= 0:
        raise ValueError(f"segment_second_moments: num_categories={num_categories}")


def _selector(cat_ids: torch.Tensor, num_categories: int) -> torch.Tensor:
    """The TPU kernel's 0/1 ``[C, N]`` selector."""
    cats = torch.arange(num_categories, device=cat_ids.device, dtype=cat_ids.dtype)
    return (cat_ids[None, :] == cats[:, None]).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def segment_second_moments_plain(
    cat_ids: torch.Tensor, x: torch.Tensor, num_categories: int,
    grouping: CategoryGrouping | None = None,
) -> torch.Tensor:
    """The einsum of the TPU kernel's selector (``grouping`` is ignored)."""
    _check_m2(cat_ids, x, num_categories)
    xb = _bf16(x)
    return torch.einsum("cn,nd,ne->cde", _selector(cat_ids, num_categories), xb, xb)


def segment_second_moments_bwd_plain(
    cat_ids: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
    grouping: CategoryGrouping | None = None,
) -> torch.Tensor:
    """The einsum of the TPU kernel's selector (``grouping`` is ignored)."""
    _check_m2(cat_ids, x, h.shape[0])
    sel = _selector(cat_ids, h.shape[0])
    return torch.einsum("cn,ced,nd->ne", sel, _bf16(h), _bf16(x))


def _group_by_category(cat_ids: torch.Tensor, num_categories: int) -> CategoryGrouping:
    """The :class:`CategoryGrouping` of ``cat_ids`` from PyTorch ops, on
    the ids' device and without a host sync: the grouping kernel's plain
    version."""
    c, rows = num_categories, M2_CHUNK_ROWS
    # the narrowest key that holds [0, C + 1]: a radix sort of 8-bit keys
    # makes one pass
    dtype = torch.uint8 if c < 255 else torch.int16 if c < 32767 else torch.int32
    key = cat_ids.clamp(-1, c).remainder(c + 1).to(dtype)  # outside [0, C) -> C
    sorted_key, order = torch.sort(key, stable=True)
    runs = torch.arange(c + 2, dtype=dtype, device=key.device)
    offsets = torch.searchsorted(sorted_key, runs, out_int32=True)
    per_run = (offsets[1:] - offsets[:-1] + (rows - 1)) // rows
    chunk_offsets = F.pad(torch.cumsum(per_run, 0, dtype=torch.int32), (1, 0))
    work = torch.arange(m2_max_chunks(key.shape[0], c), dtype=torch.int32, device=key.device)
    chunk_cat = torch.searchsorted(chunk_offsets, work, right=True, out_int32=True) - 1
    return CategoryGrouping(order, offsets, chunk_offsets, chunk_cat)


def m2_max_chunks(n: int, num_categories: int) -> int:
    """Work items of :class:`CategoryGrouping`: a bound on the chunks of
    ``n`` rows in ``C + 1`` runs (each run's last chunk may be short)."""
    return -(-n // M2_CHUNK_ROWS) + num_categories + 1


def _group_by_category_cuda(cat_ids: torch.Tensor, num_categories: int) -> CategoryGrouping:
    """The :class:`CategoryGrouping` of ``cat_ids`` from the grouping
    kernels (a stable counting sort of the category keys over many blocks,
    the run and chunk offsets and the work list; no host sync),
    bit-identical to :func:`_group_by_category`."""
    dev = _check_cuda("category_grouping", cat_ids)
    if cat_ids.dim() != 1 or cat_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"category_grouping: cat_ids {cat_ids.dtype} {tuple(cat_ids.shape)}")
    if num_categories <= 0:
        raise ValueError(f"category_grouping: num_categories={num_categories}")
    ids = cat_ids.contiguous()
    n, runs = ids.shape[0], num_categories + 1
    order = torch.empty(n, dtype=torch.int64, device=dev)
    offsets = torch.empty(runs + 1, dtype=torch.int32, device=dev)
    chunk_offsets = torch.empty(runs + 1, dtype=torch.int32, device=dev)
    chunk_cat = torch.empty(m2_max_chunks(n, num_categories), dtype=torch.int32, device=dev)
    # each warp's count of each key, and the ticket of the block that scans them
    counts = torch.empty(runs * load_library().ttamm_category_grouping_warps(n), dtype=torch.int32,
                         device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch(
        "category_grouping", dev, ids.data_ptr(), int(ids.dtype == torch.int64), n,
        num_categories, order.data_ptr(), offsets.data_ptr(), chunk_offsets.data_ptr(),
        chunk_cat.data_ptr(), chunk_cat.shape[0], counts.data_ptr(), ticket.data_ptr(),
    )
    return CategoryGrouping(order, offsets, chunk_offsets, chunk_cat)


def _m2_grouping(
    cat_ids: torch.Tensor, num_categories: int, grouping: CategoryGrouping | None
) -> CategoryGrouping:
    if grouping is None:
        return _group_by_category_cuda(cat_ids, num_categories)
    if grouping.order.shape != cat_ids.shape or grouping.offsets.shape != (num_categories + 2,):
        raise ValueError("segment_second_moments: the grouping is not of these ids")
    return grouping


def _check_m2_dim(name: str, dim: int) -> None:
    if dim > MAX_M2_DIM:
        raise ValueError(f"{name}: dim {dim} > {MAX_M2_DIM}")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def segment_second_moments_cuda(
    cat_ids: torch.Tensor, x: torch.Tensor, num_categories: int,
    grouping: CategoryGrouping | None = None,
) -> torch.Tensor:
    dev = _check_cuda("segment_second_moments", cat_ids, x)
    _check_m2(cat_ids, x, num_categories)
    dim = x.shape[1]
    _check_m2_dim("segment_second_moments", dim)
    g = _m2_grouping(cat_ids, num_categories, grouping)
    chunks = g.chunk_cat.shape[0]
    m2 = torch.empty((num_categories, dim, dim), dtype=torch.float32, device=dev)
    partial = torch.empty((chunks, dim, dim), dtype=torch.float64, device=dev)  # scratch
    _launch(
        "segment_second_moments", dev, x.data_ptr(), g.order.data_ptr(), g.offsets.data_ptr(),
        g.chunk_offsets.data_ptr(), g.chunk_cat.data_ptr(), m2.data_ptr(), partial.data_ptr(),
        num_categories, dim, chunks, int(dim % 4 == 0 and _aligned(x)),
    )
    return m2


def segment_second_moments_bwd_cuda(
    cat_ids: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
    grouping: CategoryGrouping | None = None,
) -> torch.Tensor:
    dev = _check_cuda("segment_second_moments_bwd", cat_ids, x, h)
    num_categories = h.shape[0]
    _check_m2(cat_ids, x, num_categories)
    n, dim = x.shape
    if h.shape != (num_categories, dim, dim) or h.dtype != torch.float32:
        raise ValueError(f"segment_second_moments_bwd: h {h.dtype} {tuple(h.shape)}")
    _check_m2_dim("segment_second_moments_bwd", dim)
    dx = torch.empty((n, dim), dtype=torch.float32, device=dev)
    if n:
        g = _m2_grouping(cat_ids, num_categories, grouping)
        _launch(
            "segment_second_moments_bwd", dev, x.data_ptr(), h.data_ptr(), g.order.data_ptr(),
            g.offsets.data_ptr(), g.chunk_offsets.data_ptr(), g.chunk_cat.data_ptr(),
            dx.data_ptr(), num_categories, dim, g.chunk_cat.shape[0],
            int(dim % 4 == 0 and _aligned(x, h)),
        )
    return dx
