#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving path on one NVIDIA Hopper card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero and prints no
result line):

1. build the CUDA kernels from ``ttamm_torch/csrc/`` and report the card;
2. hold each kernel against its plain PyTorch version at the serving path's
   shapes (small_k_topk bit-identical; groupmax_matmul and rescore_groups
   within rtol 1e-6 + atol 1e-5 — exact bf16 products, f32 sums in another
   order) and time both;
3. serve at the canonical scale: the ``scripts/make_corpus.py`` corpus
   (200k users x 100k items x 2M interactions), the bundle exported with
   ``configs/default.yaml`` widths on the card from a seeded init, the
   retrieval service behind the HTTP front end answering ``/healthz`` and
   ``/v1/recommend`` (GET user, POST user, POST embedding); ids must equal
   the host numpy search except where scores tie within 1e-5;
4. corpus scale: a 2M x 128 index of seeded random rows searched through
   ``auto``, ``group_exact`` and ``fused`` at B=1024, k=20; fused ids must
   equal the plain-version fused ids (ties within 1e-5 aside);
5. the launch counts of phases 3-4 (every kernel must have run).

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import traceback
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH, K = 1024, 20
TIE_TOL = 1e-5
KERNEL_RTOL, KERNEL_ATOL = 1e-6, 1e-5
CORPUS_ROWS, CORPUS_DIM = 2_000_000, 128

KERNEL_INFO = {
    "small_k_topk": ("ttamm_torch/csrc/small_k_topk.cu", "ttamm_tpu/ops/pallas/topk.py:239"),
    "groupmax_matmul": ("ttamm_torch/csrc/groupmax_matmul.cu", "ttamm_tpu/ops/pallas/fused_mips.py:91"),
    "rescore_groups": ("ttamm_torch/csrc/rescore_groups.cu", "ttamm_tpu/ops/pallas/fused_mips.py:176"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "Phase":
        log(f"== phase {self.name}")
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        status = "ok" if exc_type is None else "FAILED"
        log(f"phase {self.name}: {status} in {time.perf_counter() - self.start:.2f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_qps(fn, batch: int, iters: int = 15) -> float:
    """Queries/s of a host-level search call that returns numpy arrays, from
    the median call (the host clock of a shared machine is noisy)."""
    fn()
    fn()
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    return batch / sorted(times)[len(times) // 2]


def ids_agree(ids, scores, ref_ids, ref_scores, tol: float = TIE_TOL) -> bool:
    """Equal ids except at positions whose scores tie within ``tol``."""
    import numpy as np

    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    scores, ref_scores = np.asarray(scores), np.asarray(ref_scores)
    close = np.abs(scores - ref_scores) <= tol
    return bool(np.all(close) and np.all(close[ids != ref_ids]))


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(dev) -> str:
    import torch

    from ttamm_torch.ops import kernels

    lib = kernels.build_library()
    kernels.load_library()
    log(f"kernels: {lib.relative_to(REPO)}")
    build_log = lib.parent / "build.log"
    if build_log.is_file():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(dev)} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def _topk_rows(width: int, seed: int, dev):
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((BATCH, width), generator=gen)
    x[0] = 1.5  # all tied
    x[1] = float("-inf")  # all -inf
    x[2] = float("-inf")
    x[2, 5] = 0.5  # fewer than k finite values
    x[3, ::3] = torch.finfo(torch.float32).min  # masked-score sentinels
    x[4, ::5] = -3.0e38
    x[5] = torch.round(x[5] * 2) / 2  # many ties
    return x.to(dev)


def phase_kernels(dev) -> dict[str, dict]:
    import torch

    from ttamm_torch.ops import kernels
    from ttamm_torch.ops.topk import SAFETY_GROUPS

    results: dict[str, dict] = {}

    # small_k_topk at the path's widths: 100k-item group pick (782) and
    # final top-k (20 groups x 128), the fused candidates ((20+4) x 128),
    # and the 2M-item group pick (15,625). Bit-identical values and ids.
    topk_err = 0.0
    for width, k in ((782, 20), (2560, 20), (3072, 20), (15625, 24)):
        x = _topk_rows(width, width, dev)
        kv, ki = kernels.small_k_topk_cuda(x, k)
        pv, pi = kernels.small_k_topk_plain(x, k)
        torch.cuda.synchronize()
        same = torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)
        check(same, f"small_k_topk [{BATCH}, {width}] k={k}: kernel != plain")
        # equal values (-inf included) differ by 0, not by inf - inf = nan
        err = float(torch.where(kv == pv, 0.0, (kv - pv).abs()).max())
        topk_err = max(topk_err, err)
        ms = cuda_ms(lambda: kernels.small_k_topk_cuda(x, k))
        plain_ms = cuda_ms(lambda: kernels.small_k_topk_plain(x, k))
        log(f"small_k_topk [{BATCH}, {width}] k={k}: bit-identical, max abs err {err:.3e} "
            f"| kernel {ms:.4f} ms | plain {plain_ms:.4f} ms")
        if width == 782:
            results["small_k_topk"] = dict(shape=f"[{BATCH}, {width}] k={k}", ms=ms, plain_ms=plain_ms)
    results["small_k_topk"]["max_abs_err"] = topk_err

    # groupmax_matmul at B=1024, N=2M, D=128 in bf16, unit rows (cosine).
    gen = torch.Generator(device=dev).manual_seed(11)
    items = torch.randn((CORPUS_ROWS, CORPUS_DIM), generator=gen, device=dev)
    items = torch.nn.functional.normalize(items, dim=1).to(torch.bfloat16)
    q = torch.randn((BATCH, CORPUS_DIM), generator=gen, device=dev)
    q = torch.nn.functional.normalize(q, dim=1).to(torch.bfloat16)
    got = kernels.groupmax_matmul_cuda(q, items, CORPUS_ROWS)
    want = kernels.groupmax_matmul_plain(q, items, CORPUS_ROWS)
    err = (got - want).abs()
    bound = KERNEL_ATOL + KERNEL_RTOL * want.abs()
    check(bool((err <= bound).all()), f"groupmax_matmul: max abs err {float(err.max()):.3e}")
    # ragged shapes: B and N not tile multiples, D padded, masked tail rows
    small_q, small_i = q[:200, :40].float().contiguous(), items[:3000, :40].float().contiguous()
    e2 = (kernels.groupmax_matmul_cuda(small_q, small_i, 2900)
          - kernels.groupmax_matmul_plain(small_q, small_i, 2900)).abs().max()
    check(float(e2) <= KERNEL_ATOL, f"groupmax_matmul ragged f32: max abs err {float(e2):.3e}")
    ms = cuda_ms(lambda: kernels.groupmax_matmul_cuda(q, items, CORPUS_ROWS), iters=5)
    plain_ms = cuda_ms(lambda: kernels.groupmax_matmul_plain(q, items, CORPUS_ROWS), iters=3, warmup=1)
    log(f"groupmax_matmul [{BATCH}, {CORPUS_DIM}] x [{CORPUS_ROWS}, {CORPUS_DIM}] bf16: "
        f"max abs err {float(err.max()):.3e} (ragged f32 {float(e2):.3e}) | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms")
    results["groupmax_matmul"] = dict(
        shape=f"[{BATCH}, {CORPUS_DIM}] x [{CORPUS_ROWS}, {CORPUS_DIM}] bf16",
        max_abs_err=float(max(err.max(), e2)), ms=ms, plain_ms=plain_ms,
    )

    # rescore_groups at the fused path's shapes: the top (k + 4) groups of
    # those maxima.
    kg = K + SAFETY_GROUPS
    _, gi = kernels.small_k_topk_cuda(got, kg)
    grouped = items.view(-1, kernels.GROUP, CORPUS_DIM)
    got_r = kernels.rescore_groups_cuda(q, grouped, gi)
    want_r = kernels.rescore_groups_plain(q, grouped, gi)
    err_r = (got_r - want_r).abs()
    bound = KERNEL_ATOL + KERNEL_RTOL * want_r.abs()
    check(bool((err_r <= bound).all()), f"rescore_groups: max abs err {float(err_r.max()):.3e}")
    ms = cuda_ms(lambda: kernels.rescore_groups_cuda(q, grouped, gi))
    plain_ms = cuda_ms(lambda: kernels.rescore_groups_plain(q, grouped, gi), iters=3, warmup=1)
    log(f"rescore_groups [{BATCH}, {kg} groups] bf16: max abs err {float(err_r.max()):.3e} "
        f"| kernel {ms:.4f} ms | plain {plain_ms:.4f} ms")
    results["rescore_groups"] = dict(
        shape=f"[{BATCH}, {CORPUS_DIM}], {kg} groups of {kernels.GROUP} bf16",
        max_abs_err=float(err_r.max()), ms=ms, plain_ms=plain_ms,
    )
    del items, q, got, want, got_r, want_r
    torch.cuda.empty_cache()
    return results


def _http(port: int, path: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _search_table(index, queries) -> None:
    """Search speed by score dtype and algorithm: batched FlatIndex.search
    queries/s on the host clock (host normalisation and copies included),
    and the device time of mips_topk alone (CUDA events)."""
    import torch

    from ttamm_torch.ops.topk import mips_topk
    from ttamm_torch.serve import FlatIndex

    label = f"{len(index)} items"
    unit = torch.nn.functional.normalize(torch.from_numpy(queries).to(index.device), dim=1)
    for score_dtype in ("float32", "bfloat16"):
        idx = FlatIndex.from_host(index, device=index.device, score_dtype=score_dtype)
        for algorithm in ("auto", "group_exact", "fused"):
            qps = host_qps(lambda: idx.search(queries, K, algorithm=algorithm), len(queries))
            ms = cuda_ms(lambda: mips_topk(
                unit, idx.corpus, k=K, num_valid_rows=len(idx), algorithm=algorithm,
                score_dtype=score_dtype,
            ))
            log(f"search {label} {score_dtype} {algorithm}: {qps:.1f} queries/s "
                f"| mips_topk {ms:.4f} ms on the device (B={len(queries)}, k={K})")
        del idx


def phase_serve(dev, work: Path) -> None:
    import torch
    import yaml

    from ttamm_torch.pipelines.export import export_bundle
    from ttamm_torch.serve import RetrievalService, start_in_thread

    data_dir = work / "data"
    start = time.perf_counter()
    subprocess.run(
        [sys.executable, str(REPO / "scripts" / "make_corpus.py"), "--out", str(data_dir)],
        check=True, cwd=REPO,
    )
    log(f"corpus: {time.perf_counter() - start:.2f} s")
    config = yaml.safe_load((REPO / "configs" / "default.yaml").read_text())
    config["data"]["root"] = str(data_dir)
    start = time.perf_counter()
    result = export_bundle(config, work / "bundle", device=dev)
    log(f"export: {time.perf_counter() - start:.2f} s | users {result.num_users} items "
        f"{result.num_items} dim {result.embedding_dim} score_dtype {result.score_dtype}")
    for side, rows in (("item", result.num_items), ("user", result.num_users)):
        secs = result.encode_seconds[side]
        log(f"encode {side}s: {rows} rows in {secs * 1e3:.3f} ms = {rows / secs:.1f} rows/s")

    service = RetrievalService.from_artifacts(work / "bundle", device=dev)
    check(service.index.device == dev, f"index on {service.index.device}, not {dev}")
    srv, thread = start_in_thread(service, port=0)
    port = srv.server_address[1]
    try:
        status, body = _http(port, "/healthz")
        check(status == 200 and body["items"] == result.num_items, f"/healthz: {status} {body}")
        log(f"/healthz: {body}")
        item_pos = {asin: i for i, asin in enumerate(service.item_ids)}
        requests = [
            ("GET user", service.user_ids[0], None, f"/v1/recommend?user_id={service.user_ids[0]}&k={K}"),
            ("POST user", service.user_ids[1], {"user_id": service.user_ids[1], "k": K}, "/v1/recommend"),
            ("POST user", service.user_ids[2], {"user_id": service.user_ids[2], "k": K}, "/v1/recommend"),
            ("POST embedding", service.user_ids[3],
             {"embedding": service.user_embeddings[3].tolist(), "k": K}, "/v1/recommend"),
        ]
        for label, uid, payload, path in requests:
            status, body = _http(port, path, payload)
            check(status == 200 and len(body["items"]) == K, f"{label}: {status}, {len(body.get('items', []))} items")
            query = service.user_embeddings[service.user_to_idx[uid]][None, :]
            ref_s, ref_i = service.index.search(query, K, backend="numpy")
            ids = [item_pos[it["asin"]] for it in body["items"]]
            scores = [it["score"] for it in body["items"]]
            check(ids_agree(ids, scores, ref_i[0], ref_s[0]), f"{label}: ids differ from the numpy search")
            log(f"{label} {uid}: 200, {K} items, ids agree with the numpy search")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "HTTP server thread did not stop")

    queries = service.user_embeddings[:BATCH]
    got_s, got_i = service.index.search(queries, K)
    ref_s, ref_i = service.index.search(queries, K, backend="numpy")
    check(ids_agree(got_i, got_s, ref_i, ref_s), "batched search: ids differ from the numpy search")
    log("batched FlatIndex.search: ids agree with the numpy search")
    _search_table(service.index, queries)
    del service
    torch.cuda.empty_cache()


def phase_corpus_scale(dev) -> None:
    import numpy as np
    import torch

    from ttamm_torch.ops import topk
    from ttamm_torch.serve import build_flat_index

    rng = np.random.default_rng(2024)
    rows = rng.standard_normal((CORPUS_ROWS, CORPUS_DIM), dtype=np.float32)
    queries = rng.standard_normal((BATCH, CORPUS_DIM), dtype=np.float32)
    index = build_flat_index(rows, normalize=True, score_dtype="bfloat16", device=dev)
    del rows
    log(f"index: {len(index)} x {index.dim} bf16-scored on {index.device}")

    fused_s, fused_i = index.search(queries, K, algorithm="fused")
    # the plain versions on the same inputs (normalised as FlatIndex.search does)
    unit = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    q = torch.from_numpy(unit).to(dev).to(torch.bfloat16)
    plain_s, plain_i = topk._fused_groupmax_topk(q, index.corpus, K, len(index), plain=True)
    check(ids_agree(fused_i, fused_s, plain_i.cpu().numpy(), plain_s.cpu().numpy()),
          "fused kernels' ids differ from the plain-version fused ids")
    log("fused ids agree with the plain-version fused ids")
    _search_table(index, queries)
    del index, q
    torch.cuda.empty_cache()


def main() -> int:
    if not (REPO / "ttamm_torch" / "csrc").is_dir():
        print("chip_smoke: ttamm_torch/ not found beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from ttamm_torch.device import resolve_device
    from ttamm_torch.ops import kernels

    dev = resolve_device("cuda")
    try:
        with Phase("1 build and device"):
            smi = phase_build(dev)
        with Phase("2 kernels vs plain versions"):
            kernel_rows = phase_kernels(dev)
        kernels.reset_launch_counts()  # the main path's launches start here
        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke_") as work:
            with Phase("3 serve at the canonical scale"):
                phase_serve(dev, Path(work))
        with Phase("4 corpus scale"):
            phase_corpus_scale(dev)
        with Phase("5 launch counts"):
            counts = kernels.launch_counts()
            log(f"launch counts (phases 3-4): {counts}")
            for name, n in counts.items():
                check(n > 0, f"{name} never launched on the main path")
        check("jax" not in sys.modules, "JAX was imported")
    except Exception:
        traceback.print_exc()
        return 1

    summary = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": KERNEL_INFO[name][0],
                "replaces": KERNEL_INFO[name][1],
                "launches": counts[name],
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "shape": row["shape"],
            }
            for name, row in kernel_rows.items()
        ]
    }
    log(json.dumps(summary))
    log(smi)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
