"""The training path's kernel functions (ttamm_torch/ops/kernels.py) against
the JAX Pallas kernels they replace, run in interpret mode on the CPU.

On the CPU each wrapper takes its plain PyTorch version, so these tests pin
the plain versions to the TPU kernels; the CUDA kernels are held against
the plain versions on the card (tests/test_torch_port_cuda.py and
chip_smoke.py).

Tolerances: the row gather and scatter move bits (exact). The second
moments round their operands to bf16 on both sides, so every product is
exact and only the order of the f32 sums differs: rtol 1e-5, atol 1e-5 at
O(1)-O(100) entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.ops import kernels
from ttamm_torch.ops.losses import SegmentSecondMoments
from ttamm_tpu.ops.pallas.category_stats import segment_second_moments
from ttamm_tpu.ops.pallas.rows import gather_rows, scatter_set_rows


@pytest.mark.parametrize("n", [8, 96])
def test_gather_rows_plain_equals_jax(n):
    rng = np.random.default_rng(n)
    table = rng.standard_normal((257, 128)).astype(np.float32)
    idx = rng.integers(0, 257, n).astype(np.int32)
    idx[: n // 2] = 3  # duplicates read the same row
    want = gather_rows(jnp.asarray(table), jnp.asarray(idx), block=8, interpret=True)
    got = kernels.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_set_rows_plain_equals_jax():
    """Unique targets plus duplicate lanes on the scratch row (the last
    row), as coalesce_row_grads sends them: every other row is exact."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((65, 128)).astype(np.float32)
    idx = rng.permutation(64)[:32].astype(np.int32)
    idx[20:] = 64
    rows = rng.standard_normal((32, 128)).astype(np.float32)
    want = np.asarray(scatter_set_rows(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(rows), block=8, interpret=True
    ))
    got = torch.from_numpy(table.copy())
    out = kernels.scatter_set_rows(got, torch.from_numpy(idx), torch.from_numpy(rows))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy()[:64], want[:64])


def _m2_inputs(seed, n=300, c=16, d=128):
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.geometric(0.3, n) - 1, c + 3).astype(np.int32)  # some >= C
    ids[ids == 5] = 6  # category 5 empty
    ids[0] = c - 1  # the one member of category C-1 (if no draw landed there)
    x = rng.standard_normal((n, d)).astype(np.float32)
    sel = (ids[None, :] == np.arange(c)[:, None]).astype(np.float32)
    return ids, x, sel


def test_segment_second_moments_plain_matches_jax():
    ids, x, sel = _m2_inputs(2)
    want = segment_second_moments(jnp.asarray(sel), jnp.asarray(x), True)
    got = kernels.segment_second_moments(torch.from_numpy(ids), torch.from_numpy(x), 16)
    assert got.shape == (16, 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[5] == 0)


def test_segment_second_moments_gradient_matches_jax_vjp():
    """The autograd function's backward (the backward kernel's plain
    version) against jax.vjp of the Pallas kernel's custom VJP."""
    ids, x, sel = _m2_inputs(3)
    g = np.random.default_rng(4).standard_normal((16, 128, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: segment_second_moments(jnp.asarray(sel), xx, True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    m2 = SegmentSecondMoments.apply(torch.from_numpy(ids), xt, 16)
    (got,) = torch.autograd.grad(m2, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[ids >= 16] == 0)  # ids outside [0, C) get no gradient


def test_kernel_argument_checks():
    with pytest.raises(ValueError, match="int32"):
        kernels.gather_rows(torch.randn(4, 8), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        kernels.gather_rows(torch.randn(4, 8, dtype=torch.float64), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        kernels.scatter_set_rows(torch.randn(4, 8), torch.zeros(2, dtype=torch.int32), torch.randn(3, 8))
    with pytest.raises(ValueError, match="cat_ids"):
        kernels.segment_second_moments(torch.zeros(3, dtype=torch.int32), torch.randn(4, 8), 2)
    with pytest.raises(ValueError, match="num_categories"):
        kernels.segment_second_moments(torch.zeros(4, dtype=torch.int32), torch.randn(4, 8), 0)


def test_group_by_category_glue():
    """The kernels' row grouping: stable per category, ids outside [0, C)
    last, and 32-row backward chunks per run."""
    ids = torch.tensor([2, 0, 9, 2, -1, 0, 0, 1] + [1] * 40, dtype=torch.int32)
    order, offsets, chunks = kernels._group_by_category(ids, 3)
    assert order[:3].tolist() == [1, 5, 6]  # category 0, in row order
    assert offsets.tolist() == [0, 3, 44, 46, 48]
    assert sorted(order[46:].tolist()) == [2, 4]  # the ids outside [0, 3)
    assert chunks.tolist() == [0, 1, 3, 4, 5]  # 41 rows of category 1: 2 chunks
