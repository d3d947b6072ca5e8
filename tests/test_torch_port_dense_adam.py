"""The dense Adam / AdamW kernel's wrapper (``kernels.dense_adam_cuda``)
on the CPU: it refuses what the kernel does not take before it looks at
the device. The kernel itself is held to the ``torch._foreach_*``
composition on the card (tests/test_torch_port_cuda.py); on CPU tensors
``kernels.dense_adam`` takes the composition, which
tests/test_torch_port_train_ops.py holds to JAX, and launches nothing
(tests/test_torch_port_kernels.py)."""

import pytest
import torch

from ttamm_torch.ops import kernels

SHAPES = ((40, 8), (256, 5), (1,), (3,), (5,), (127,))


def _case(seed):
    gen = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=gen) for s in SHAPES]
    grads = [torch.randn(s, generator=gen) * 1e-2 for s in SHAPES]
    m = [torch.randn(s, generator=gen) * 1e-3 for s in SHAPES]
    v = [torch.rand(s, generator=gen) * 1e-5 for s in SHAPES]
    return params, grads, m, v


def _bad_arguments(kind):
    """``(params, grads, m, v, scalars)`` with one fault of ``kind``."""
    params, grads, m, v = _case(7)
    scalars = torch.zeros(3)
    if kind in ("float64", "bfloat16"):
        grads[1] = grads[1].to(getattr(torch, kind))
    elif kind == "lengths":
        v = v[:-1]
    elif kind == "aliased_p_m":
        m[2] = params[2]
    elif kind == "aliased_m_v":
        buf = torch.zeros(40 * 8 + 4)  # m and v overlapping views of one buffer
        m[0], v[0] = buf[:-4].view(40, 8), buf[4:].view(40, 8)
    elif kind == "non_contiguous":
        params[0], grads[0], m[0], v[0] = (t.t() for t in (params[0], grads[0], m[0], v[0]))
    elif kind == "shapes":
        grads[0] = grads[0].reshape(8, 40)
    elif kind == "scalars":
        scalars = torch.zeros(4)
    return params, grads, m, v, scalars


@pytest.mark.parametrize("kind,message", [
    ("float64", "float32 of one shape"),
    ("bfloat16", "float32 of one shape"),
    ("shapes", "float32 of one shape"),
    ("lengths", "params, .* grads"),
    ("aliased_p_m", "distinct"),
    ("aliased_m_v", "distinct"),
    ("non_contiguous", "contiguous"),
    ("scalars", "scalars"),
    ("cpu", "CUDA kernel given a tensor on cpu"),
])
def test_dense_adam_kernel_wrapper_refuses_what_the_kernel_does_not_take(kind, message):
    """Each fault raises, before any launch, and the arguments come before
    the device: a list the kernel would take raises only for lying on the
    CPU."""
    params, grads, m, v, scalars = _bad_arguments(kind)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=message):
        kernels.dense_adam_cuda(params, grads, m, v, scalars=scalars, b1=0.9, b2=0.999,
                                eps=1e-8, weight_decay=0.01, decoupled=True)
    assert kernels.launch_counts()["dense_adam"] == 0
