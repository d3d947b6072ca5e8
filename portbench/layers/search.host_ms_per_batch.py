"""Host ms a search: over the traced part's ``ttamm.search`` roots (the
port's spans), the mean of each root's duration less its
``ttamm.search.readback`` child's, the host's time from the call until its
last kernel is enqueued."""

from portbench import program_spans

program_spans.collect()  # loaded at the start of a run


def read(trace):
    if trace.info.get("kind") != "search":
        return None
    recs = program_spans.records()
    if recs is None:
        return None
    roots = program_spans.roots(recs, "ttamm.search")
    if len(roots) != trace.units:
        raise RuntimeError(f"{len(roots)} ttamm.search spans for {trace.units} traced searches")
    readback = program_spans.child_ns(recs, "ttamm.search.readback")
    return sum(r.ns - readback.get(r.id, 0) for r in roots) / len(roots) / 1e6
