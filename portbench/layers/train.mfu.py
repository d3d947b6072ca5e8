"""The whole step's share of the card's peak, in %: the model operations of
the traced epoch's steps (the towers' and gates' matmuls forward and
backward, the retrieval loss's products, the category moments; counted
from the configuration's widths by ``yardstick.train_step_flops``) over its
wall time, over the peak of the arithmetic the configuration states
(float32 with TF32 off: 67 TFLOP/s)."""

from portbench import yardstick


def read(trace):
    if trace.info.get("kind") != "train":
        return None
    return 100.0 * trace.info["flops"] / trace.window_s / yardstick.PEAK_FLOPS[trace.info["dtype"]]
