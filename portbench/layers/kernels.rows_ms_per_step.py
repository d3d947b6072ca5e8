"""Device ms a step of the row kernels (``csrc/rows.cu``): the fused
sparse-row Adam update and the sparse tables' row reads, in the traced
epoch over its steps."""


def read(trace):
    if trace.info.get("kind") != "train":
        return None
    seconds = trace.kernel_s("sparse_adam_rows_kernel", "gather_rows_kernel")
    return None if seconds is None else seconds / trace.units * 1e3
