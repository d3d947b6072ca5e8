"""Device ms a search of one batch: the union of the device operations of
the traced searches over their count."""


def read(trace):
    if trace.info.get("kind") != "search":
        return None
    return trace.busy_s / trace.units * 1e3
