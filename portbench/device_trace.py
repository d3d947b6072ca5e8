"""Reading a bounded part of a run under ``torch.profiler``: the device's busy
time, each kernel's time by name, and the idle gaps with what the host was
doing in them.

The arithmetic follows ``chip_smoke.py``'s ``_device_us`` / ``_profiled``
(the work that ran on the card: kernels, copies and fills; a discarded
warm-up step first, since the first records of a session are the likeliest
to be dropped), frozen here. Busy time is the union of the device
intervals, so kernels that overlap count once. The host side is read from
the ``portbench.*`` spans the drivers open around their calls into the
program (``span``), and from the runtime calls beneath them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}


def span(name: str):
    """A host span named ``portbench.<name>`` in the trace (a no-op cost
    outside the profiler)."""
    import torch

    return torch.profiler.record_function(f"portbench.{name}")


@dataclass
class Trace:
    """What a traced part holds. Times in seconds."""

    window_s: float
    busy_s: float
    kernels: dict[str, float]  # device seconds by operation name
    gaps: list[tuple[str, float]]  # idle gaps, longest first, by host activity
    units: int  # steps or searches in the part
    info: dict = field(default_factory=dict)  # what the driver adds for readers

    def kernel_s(self, *needles: str) -> float | None:
        """Device seconds of the operations whose names hold any of
        ``needles``; None where none ran."""
        hits = [t for k, t in self.kernels.items() if any(n in k for n in needles)]
        return sum(hits) if hits else None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in self.gaps[:top]]}


def _ns(evt, which: str) -> int:
    fn = getattr(evt, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(evt, f"{which}_us")() * 1000)


def _kind(evt) -> str | None:
    kind = getattr(evt, "activity_type", None)
    kind = kind() if callable(kind) else None
    return kind if isinstance(kind, str) else None


def _is_device(evt, kinds=DEVICE_ACTIVITIES) -> bool:
    kind = _kind(evt)
    if kind is not None:
        return kind in kinds
    from torch.autograd import DeviceType

    return (evt.device_type() != DeviceType.CPU and not evt.is_user_annotation()
            and not evt.name().startswith("ProfilerStep"))


def _label(host: list[tuple[int, int, str]], t: int) -> str:
    """The innermost ``portbench.*`` span open at ``t``, with the innermost
    host operation open then (a runtime call, an aten op) after a colon."""
    outer = inner = None
    for start, end, name in host:
        if start <= t < end:
            if name.startswith("portbench."):
                if outer is None or start >= outer[0]:
                    outer = (start, name)
            elif inner is None or start >= inner[0]:
                inner = (start, name)
    parts = [p[1] for p in (outer, inner) if p is not None]
    return ": ".join(parts) if parts else "host idle"


def read_events(events, t0: int, t1: int, top: int = 10, kinds=DEVICE_ACTIVITIES):
    """``(busy seconds, seconds by device op, idle gaps)`` of the kineto
    ``events`` inside ``[t0, t1]`` (ns, the host clock of the trace): the
    ``top`` longest stretches in which no device operation ran, each named
    by what the host was doing halfway through it."""
    device, host = [], []
    for evt in events:
        start = _ns(evt, "start")
        end = start + _ns(evt, "duration")
        if end <= t0 or start >= t1:
            continue
        if _is_device(evt, kinds):
            device.append((start, end, evt.name()))
        elif not evt.is_user_annotation() or evt.name().startswith("portbench."):
            host.append((start, end, evt.name()))
    device.sort()
    kernels: dict[str, float] = {}
    busy = 0
    idle = []  # (ns, midpoint)
    edge = t0
    for start, end, name in device:
        kernels[name] = kernels.get(name, 0.0) + (end - start) / 1e9
        start, end = max(start, t0), min(end, t1)
        if start > edge:
            idle.append((start - edge, edge + (start - edge) // 2))
            busy += end - start
            edge = end
        elif end > edge:
            busy += end - edge
            edge = end
    if t1 > edge:
        idle.append((t1 - edge, edge + (t1 - edge) // 2))
    idle.sort(reverse=True)
    gaps = [(_label(host, mid), ns / 1e9) for ns, mid in idle[:top]]
    return busy / 1e9, kernels, gaps


def traced(warm, body, units: int, device: str = "cuda") -> Trace:
    """``body()`` under ``torch.profiler`` (host and device), after
    ``warm()`` in a traced step that is thrown away; ``body`` must end in a
    synchronise, inside ``body_span()``. The part's window is that span's
    length on the trace's clock. Where the profiler saw no device work,
    the part cannot be read, and this raises. On the CPU (the harness's
    tests) the host's aten operations stand in for device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    cpu = device == "cpu"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    activities = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    results = []
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda prof: results.append(prof.profiler.kineto_results)) as prof:
        warm()
        sync()
        prof.step()
        body()
        sync()
        prof.step()
    events = list(results[0].events()) if results else []
    # the trace's clock: place the window by the body's outermost span
    marks = [(_ns(e, "start"), _ns(e, "start") + _ns(e, "duration")) for e in events
             if e.name() == "portbench.body" and e.device_type() == DeviceType.CPU]
    if marks:
        t0, t1 = marks[0]
        busy, kernels, gaps = read_events(events, t0, t1,
                                          kinds={"cpu_op"} if cpu else DEVICE_ACTIVITIES)
        if busy > 0:
            return Trace((t1 - t0) / 1e9, busy, kernels, gaps, units)
    raise RuntimeError("the profiler saw no device work in the traced part")


@contextlib.contextmanager
def body_span():
    """The outermost span of a traced part (``traced`` finds its bounds)."""
    with span("body"):
        yield
