#!/usr/bin/env python3
"""small_k_topk beside torch.topk at the chunked search's widths, timed
over many launches: the 40-wide merge of a chunk's top 20 into the running
top 20, and a whole chunk at B = 1,024 (``ttamm_torch.ops.topk``'s chunk
for that batch, and the older fixed 8,192). For each (width, function)
seven turns of ``LAUNCHES`` back-to-back calls under ``torch.profiler``:
each turn's device µs a call (every kernel the call launched, summed) and
its kernels' names and counts; then the median and the spread (min, max)
of the seven. The same calls are also timed by CUDA events around each
turn (µs a call on the card's clock, host gaps between launches
included). Prints one JSON line last.

Needs one NVIDIA Hopper card; run from the root of a checkout:

    python3 scripts/topk_merge_timing.py
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402

LAUNCHES = 500  # calls a turn at the narrow widths
TURNS = 7
K = 20


def turn(fn, calls: int) -> tuple[float, float, dict[str, int]]:
    """(profiler device µs a call, CUDA-event µs a call, kernel counts)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU and e.count]
    device_us = smoke._device_us(events) / calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_us, start.elapsed_time(end) * 1e3 / calls, {e.key[:80]: e.count for e in events}


def main() -> int:
    import torch

    from ttamm_torch.device import resolve_device
    from ttamm_torch.ops import kernels, topk

    dev = resolve_device("cuda")
    chunk = topk.chunk_items(smoke.BATCH)
    out = []
    for width in (2 * K, 8192, chunk):
        x = smoke._topk_rows(width, width, dev)
        kv, ki = kernels.small_k_topk_cuda(x, K)
        pv, pi = kernels.small_k_topk_plain(x, K)
        smoke.check(torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi),
                    f"small_k_topk [{smoke.BATCH}, {width}]: kernel != plain")
        calls = LAUNCHES if width <= 8192 else 20
        for name, fn in (("small_k_topk", lambda: kernels.small_k_topk_cuda(x, K)),
                         ("torch.topk", lambda: torch.topk(x, K, dim=1))):
            turns = [turn(fn, calls) for _ in range(TURNS)]
            prof_us = [t[0] for t in turns]
            event_us = [t[1] for t in turns]
            row = {"width": width, "function": name, "calls_a_turn": calls,
                   "device_us_median": statistics.median(prof_us), "device_us_min": min(prof_us),
                   "device_us_max": max(prof_us), "event_us_median": statistics.median(event_us),
                   "event_us_min": min(event_us), "event_us_max": max(event_us),
                   "kernels": turns[-1][2]}
            smoke.log(f"[{smoke.BATCH}, {width}] k={K} {name}: device {row['device_us_median']:.2f} µs "
                      f"a call (min {row['device_us_min']:.2f}, max {row['device_us_max']:.2f}) | "
                      f"events {row['event_us_median']:.2f} µs (min {row['event_us_min']:.2f}, max "
                      f"{row['event_us_max']:.2f}) | kernels {row['kernels']}")
            out.append(row)
        del x
        torch.cuda.empty_cache()
    smoke.log(smoke.nvidia_smi())
    print(json.dumps({"rows": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
