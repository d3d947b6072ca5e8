"""Device ms a step of the dense AdamW's kernel (``csrc/dense_adam.cu``,
called by ``train/optim.py``): its launches in the traced epoch over its
steps. None where it never ran (a port whose dense AdamW is still the
``torch._foreach_*`` composition)."""


def read(trace):
    if trace.info.get("kind") != "train":
        return None
    seconds = trace.kernel_s("dense_adam_kernel")
    return None if seconds is None else seconds / trace.units * 1e3
