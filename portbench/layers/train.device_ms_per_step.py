"""Device ms a train step: the union of the device operations of the traced
epoch (every replayed step, the remainder step, the order's upload and the
losses' read) over its steps."""


def read(trace):
    if trace.info.get("kind") != "train":
        return None
    return trace.busy_s / trace.units * 1e3
