"""The category second moments' share of their roofline, in %: the least
time the card needs for every step's moments in the traced epoch (the
larger of the bytes over 3.35 TB/s and the operations over the bf16 peak,
their operands being bf16 by the op's definition; ``yardstick``) over the
time of their kernels (the grouping, the chunk partials, the reduction and
the backward; ``csrc/category_stats.cu``)."""

from portbench import yardstick

KERNELS = ("group_count_kernel", "group_scatter_kernel", "m2_chunk_kernel", "m2_reduce_kernel",
           "m2_bwd_kernel")


def read(trace):
    info = trace.info
    if info.get("kind") != "train" or not info.get("moments_rows"):
        return None
    seconds = trace.kernel_s(*KERNELS)
    if seconds is None:
        return None
    d, c = info["dim"], info["categories"]
    bound = sum(yardstick.bound_ms(yardstick.moments_bytes(n, d, c), yardstick.moments_flops(n, d))[0]
                for n in info["moments_rows"])
    return 100.0 * bound / (seconds * 1e3)
