"""Host ms a multi-step call: over the traced epoch's ``ttamm.train.multi``
roots (the port's spans), the mean of each root's duration less its
``ttamm.step.replay`` child's: the step scalars, the staging of the
batches and any capture."""

from portbench import program_spans

program_spans.collect()  # loaded at the start of a run


def read(trace):
    if trace.info.get("kind") != "train":
        return None
    recs = program_spans.records()
    if recs is None:
        return None
    calls = program_spans.train_calls(trace, recs)
    if not calls:
        return None
    replay = program_spans.child_ns(recs, "ttamm.step.replay")
    return sum(r.ns - replay.get(r.id, 0) for r in calls) / len(calls) / 1e6
