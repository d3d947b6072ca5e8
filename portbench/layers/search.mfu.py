"""The whole search call's share of the card's peak, in %: ``2 B N D`` a
search times the traced searches, over their wall time, over the peak of
the score dtype (float32: 67 TFLOP/s; bfloat16: 989 TFLOP/s)."""

from portbench import yardstick


def read(trace):
    info = trace.info
    if info.get("kind") != "search":
        return None
    flops = yardstick.search_flops(info["batch"], info["items"], info["dim"]) * trace.units
    return 100.0 * flops / trace.window_s / yardstick.PEAK_FLOPS[info["dtype"]]
