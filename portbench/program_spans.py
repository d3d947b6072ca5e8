"""The port's own spans (``ttamm_torch/utils/trace.py``) as the per-layer
metrics read them.

The port keeps no records of its own: each reader of a span metric calls
:func:`collect` when the harness loads it, at the start of a run, so the
records are this run's. A span records only while a profiler records in
its thread, and in a run of ``run.py`` the profiler records only the
traced part's body (the warm step runs under its warm-up), so the records
are exactly that body's. A checkout whose port has no span module gives
nothing to read, and the metrics that read spans are left out of its
result line.
"""

from __future__ import annotations


def collect() -> None:
    """Start keeping the port's span records for this run (nothing where
    the port has no span module)."""
    try:
        from ttamm_torch.utils import trace as spans
    except ImportError:
        return
    spans.collect()


def records():
    """The port's span records, or None where the port has no span module
    or recorded nothing; raises where records were dropped."""
    try:
        from ttamm_torch.utils import trace as spans
    except ImportError:
        return None
    if spans.dropped():
        raise RuntimeError(f"{spans.dropped()} span records dropped past the cap")
    return spans.records() or None


def roots(recs, name: str) -> list:
    return [r for r in recs if r.parent_id is None and r.name == name]


def child_ns(recs, name: str) -> dict[int, int]:
    """Nanoseconds of the spans called ``name``, summed by parent id."""
    out: dict[int, int] = {}
    for r in recs:
        if r.name == name and r.parent_id is not None:
            out[r.parent_id] = out.get(r.parent_id, 0) + r.ns
    return out


def train_calls(trace, recs) -> list:
    """The traced epoch's ``ttamm.train.multi`` roots; raises unless they
    and the single steps (``ttamm.train.step``) hold every traced step."""
    calls = roots(recs, "ttamm.train.multi")
    steps = sum(r.n for r in calls) + len(roots(recs, "ttamm.train.step"))
    if steps != trace.units:
        raise RuntimeError(f"the train spans hold {steps} steps, the traced part {trace.units}")
    return calls
