"""Device ms a step of the dense AdamW (``train/optim.py``): its
``torch._foreach_*`` kernels (``multi_tensor_apply``) in the traced epoch
over its steps."""


def read(trace):
    if trace.info.get("kind") != "train":
        return None
    seconds = trace.kernel_s("multi_tensor_apply")
    return None if seconds is None else seconds / trace.units * 1e3
