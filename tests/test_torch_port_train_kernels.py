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


def _glue_ids(layout, rows):
    """Category ids of one layout (C = 64 unless it says otherwise)."""
    rng = np.random.default_rng(len(layout) + rows)
    if layout == "one_category":  # every row in one category: 5R + 3 rows
        return np.full(5 * rows + 3, 7), 64
    if layout == "canonical":  # 10 populated ids of 64, near-uniform
        return rng.integers(0, 10, 12288), 64
    if layout == "skewed":  # one category with ~30% of the rows
        return np.minimum(rng.exponential(6.0, 12288).astype(np.int64), 61), 64
    if layout == "empty_and_single":  # category 5 empty, category 15 one member
        ids = np.minimum(rng.geometric(0.3, 300) - 1, 19)
        ids[ids == 5] = 6
        ids[ids == 15] = 14
        ids[7] = 15
        return ids, 16
    if layout == "run_lengths":  # runs of R - 1, R, R + 1 and 2R + 1 rows, shuffled
        ids = np.repeat(np.arange(4), [rows - 1, rows, rows + 1, 2 * rows + 1])
        return rng.permutation(np.concatenate([ids, [-1, 64, 99]])), 64
    if layout == "all_outside":
        return rng.choice([-3, -1, 64, 70], 500), 64
    if layout == "wide_c":  # C = 300: 16-bit sort keys
        return rng.integers(-2, 303, 3000), 300
    return np.zeros(0, dtype=np.int64), 64  # "empty": N = 0


def _work_items(g, c):
    """The grouping's work items as the kernels read them: (run, rows)."""
    order, offsets, chunk_offsets, chunk_cat = (t.tolist() for t in g[:4])
    items = []
    for j, cat in enumerate(chunk_cat):
        if cat > c:  # past the last chunk
            continue
        begin = offsets[cat] + (j - chunk_offsets[cat]) * kernels.M2_CHUNK_ROWS
        items.append((cat, order[begin : min(begin + kernels.M2_CHUNK_ROWS, offsets[cat + 1])]))
    return items


@pytest.mark.parametrize(
    "layout",
    ["canonical", "skewed", "one_category", "empty_and_single", "run_lengths", "all_outside",
     "wide_c", "empty"],
)
def test_group_by_category_glue(layout):
    """The kernels' row grouping and work list at the shipped R: every row
    with an id in [0, C) lies in exactly one chunk of its own category, in
    row order; the ids outside [0, C) form run C; no chunk exceeds R rows;
    the work list has ceil(N / R) + C + 1 items, the chunks first, then only
    items past them."""
    rows = kernels.M2_CHUNK_ROWS
    ids, c = _glue_ids(layout, rows)
    n = len(ids)
    for dtype in (torch.int32, torch.int64):
        g = kernels._group_by_category(torch.from_numpy(ids).to(dtype), c)
        assert g.order.dtype == torch.int64
        assert g.chunk_cat.numel() == -(-n // rows) + c + 1 == kernels.m2_max_chunks(n, c)
        live = g.chunk_cat <= c
        assert bool((g.chunk_cat[~live] == c + 1).all())
        assert bool(live[: int(live.sum())].all())  # the chunks come first
        assert bool((g.chunk_cat[live][1:] >= g.chunk_cat[live][:-1]).all())
        items = _work_items(g, c)
        assert all(0 < len(r) <= rows for _, r in items)
        for cat in range(c):
            want = np.flatnonzero(ids == cat).tolist()
            assert [row for k, r in items if k == cat for row in r] == want, cat
        outside = [row for k, r in items if k == c for row in r]
        assert sorted(outside) == np.flatnonzero((ids < 0) | (ids >= c)).tolist()


def test_group_by_category_layout():
    """The grouping of a small batch, entry by entry: stable per category,
    ids outside [0, C) last, chunks of R = 128 rows per run."""
    assert kernels.M2_CHUNK_ROWS == 128
    ids = torch.tensor([2, 0, 9, 2, -1, 0, 0, 1] + [1] * 160, dtype=torch.int32)
    g = kernels._group_by_category(ids, 3)
    assert g.order[:3].tolist() == [1, 5, 6]  # category 0, in row order
    assert g.offsets.tolist() == [0, 3, 164, 166, 168]
    assert sorted(g.order[166:].tolist()) == [2, 4]  # the ids outside [0, 3)
    assert g.chunk_offsets.tolist() == [0, 1, 3, 4, 5]  # 161 rows of category 1: 2 chunks
    assert g.chunk_cat.tolist() == [0, 1, 1, 2, 3, 4]  # 4 = C + 1: past the last chunk


def test_segment_second_moments_glue_checks():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="dim 513"):
        kernels._check_m2_dim("segment_second_moments", 513)
    other = kernels._group_by_category(torch.zeros(5, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="grouping"):
        kernels._m2_grouping(ids, 2, other)
    with pytest.raises(ValueError, match="on cpu"):  # built by the grouping kernel
        kernels._m2_grouping(ids, 2, None)
    assert kernels.category_grouping(ids, 2) is None  # the plain versions need none
