"""Edge layouts of the two search kernels' plain versions against the JAX
Pallas kernels, run in interpret mode on the CPU.

These pin the semantics the CUDA designs rely on (csrc/small_k_topk.cu,
csrc/groupmax_matmul.cu): the top-k's order and tie rule on rows whose keys
tie at the k-th place, share their top radix digits, or are signed zeros and
sentinels; the group max's masking of rows at or beyond ``num_items`` at
ragged B, N and D. The CUDA kernels are held to these plain versions on the
card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.ops import kernels
from ttamm_tpu.ops.pallas.fused_mips import groupmax_matmul
from ttamm_tpu.ops.pallas.topk import small_k_topk


def _topk_case(case: str) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "ties_at_kth_scattered":
        x = rng.standard_normal((16, 500)).astype(np.float32)
        for row in x:
            kth = np.sort(row)[::-1][9]
            row[rng.choice(500, 12, replace=False)] = kth  # the 10th key, 12 more times
        return x, 10
    if case == "one_top_digit":
        # every key shares its top 26 bits: 1.0 plus a few low mantissa bits
        steps = rng.integers(0, 48, (16, 700))
        return (np.float32(1.0) + steps * np.float32(2.0**-23)).astype(np.float32), 24
    if case == "signed_zeros":
        x = np.where(rng.random((16, 300)) < 0.5, np.float32(0.0), np.float32(-0.0))
        x[:, ::17] = rng.standard_normal(x[:, ::17].shape) * 1e-30
        return x.astype(np.float32), 40
    if case == "k_equals_w_128":
        return rng.standard_normal((8, 128)).astype(np.float32), 128
    if case == "k_equals_w_40_ties":
        return np.round(rng.standard_normal((8, 40)) * 2).astype(np.float32) / 2, 40
    if case == "width_one":
        x = rng.standard_normal((9, 1)).astype(np.float32)
        x[0, 0], x[1, 0], x[2, 0] = -np.inf, np.finfo(np.float32).min, -0.0
        return x, 1
    # fewer than k finite values: -inf rows with a few finite keys and sentinels
    x = np.full((8, 260), -np.inf, np.float32)
    x[0, [3, 100, 250]] = [0.5, -0.25, 0.5]
    x[1, ::50] = np.finfo(np.float32).min
    x[2, ::40] = -3.0e38
    x[2, 7] = -1.0
    x[3, 259] = 2.0
    return x, 20


@pytest.mark.parametrize(
    "case",
    [
        "ties_at_kth_scattered", "one_top_digit", "signed_zeros", "k_equals_w_128",
        "k_equals_w_40_ties", "width_one", "fewer_finite_than_k",
    ],
)
def test_small_k_topk_plain_edges_bit_identical_to_jax(case):
    x, k = _topk_case(case)
    want_v, want_i = small_k_topk(jnp.asarray(x), k, interpret=True)
    got_v, got_i = kernels.small_k_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32), np.asarray(want_v).view(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_small_k_topk_plain_ranks_negative_zero_below_positive_zero():
    x = np.array([[-0.0, 0.0, -0.0, 0.0]], np.float32)
    vals, idx = kernels.small_k_topk(torch.from_numpy(x), 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    assert np.signbit(vals.numpy()).tolist() == [[False, False, True, True]]


def _bf16_values(rng, shape, scale):
    """bf16-representable values (times a power of two), so every product is
    exact in f32 and only the order of the f32 sums differs."""
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,n,d,num_items,negative",
    [
        (1, 1300, 36, 1290, False),   # num_items inside the last group
        (129, 1280, 36, 1280, False),  # num_items at the edge of the last group
        (1, 1280, 136, 1200, True),   # all-negative scores, a pad-only tail group
        (129, 1300, 136, 1300, True),  # all-negative, ragged last group
        (129, 2000, 36, 1921, True),
        (1, 700, 136, 1, False),      # one real row
    ],
)
def test_groupmax_matmul_plain_edges_match_jax(dtype, b, n, d, num_items, negative):
    rng = np.random.default_rng(b * n + d)
    q = _bf16_values(rng, (b, d), 1 / 8)
    items = _bf16_values(rng, (n, d), 1 / 8)
    if negative:
        q, items = np.abs(q), -np.abs(items)
    # the JAX kernel's tiling, as its callers pad: B to 128s, rows to 2048s
    bp, npad = -(-b // 128) * 128, -(-n // 2048) * 2048
    qj = np.zeros((bp, d), np.float32)
    qj[:b] = q
    ij = np.zeros((npad, d), np.float32)
    ij[:n] = items
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(groupmax_matmul(
        jnp.asarray(qj).astype(jdt), jnp.asarray(ij).astype(jdt),
        num_items=num_items, interpret=True,
    ))
    tdt = getattr(torch, dtype)
    got = kernels.groupmax_matmul(
        torch.from_numpy(q).to(tdt), torch.from_numpy(items).to(tdt), num_items
    ).numpy()
    ng = -(-n // 128)
    assert got.shape == (b, ng)
    np.testing.assert_allclose(got, want[:b, :ng], rtol=1e-6, atol=1e-5)
    # groups past num_items hold only pad rows: the -3e38 sentinel exactly
    full = -(-num_items // 128)
    assert np.all(got[:, full:] == np.float32(-3.0e38))
    if negative:
        assert np.all(got[:, :full] < 0)
