"""Host ms to issue one replayed step: the summed duration of the traced
epoch's ``ttamm.step.replay`` spans (the port's spans) over the replays
they issue. Near ``train.device_ms_per_step`` the card sets the pace; well
above it, the launches do. None where no step was replayed (the CPU)."""

from portbench import program_spans

program_spans.collect()  # loaded at the start of a run


def read(trace):
    if trace.info.get("kind") != "train":
        return None
    recs = program_spans.records()
    if recs is None:
        return None
    calls = {r.id for r in program_spans.train_calls(trace, recs)}
    replays = [r for r in recs if r.name == "ttamm.step.replay" and r.parent_id in calls]
    steps = sum(r.n for r in replays)
    if not steps:
        return None
    return sum(r.ns for r in replays) / steps / 1e6
