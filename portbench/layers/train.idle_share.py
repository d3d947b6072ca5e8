"""The share of the traced epoch's wall time in which no operation ran on
the device, in %."""


def read(trace):
    if trace.info.get("kind") != "train":
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
