"""The port's ``select_topk_from_groups`` and its masked search against the
JAX package, on the CPU.

- ``kernels.select_topk_from_groups`` (the plain version on a CPU tensor)
  against the JAX Pallas kernel in interpret mode, on the cases of
  ``tests/test_pallas_kernels.py``: values and ids equal, bit for bit.
- ``mips_topk(mask_rows=...)`` against the JAX ``mips_topk`` for float32
  ``group_exact`` with k <= 32 (the select kernel's route) and k > 32 (the
  gather route), bfloat16 ``group_exact`` and ``fused`` (the JAX Pallas
  kernels in interpret mode), and ``topk_with_mask``: ids equal, scores
  within rtol 1e-5 (the bf16 and fused cases use dyadic inputs whose sums are
  exact, so ties, which they have plenty of, must break identically).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.ops import kernels
from ttamm_torch.ops.topk import mips_topk, topk_with_mask
from ttamm_tpu.ops.pallas.topk import select_topk_from_groups as jax_select
from ttamm_tpu.ops.topk import _fused_groupmax_topk
from ttamm_tpu.ops.topk import mips_topk as jax_mips_topk
from ttamm_tpu.ops.topk import topk_with_mask as jax_topk_with_mask


def _slab(b, num_items, kg, *, ties=False, sentinel=False, seed=1):
    """The inputs of tests/test_pallas_kernels.py's select cases."""
    r = np.random.default_rng(seed)
    ng = -(-num_items // 128)
    s = r.normal(0, 1, (b, ng * 128)).astype(np.float32)
    if ties:
        s = np.round(s * 4) / 4
    if sentinel:
        s[:, ::7] = np.finfo(np.float32).min
    s[:, num_items:] = 0.0  # pad columns as the matmul writes them
    gi = np.stack([r.permutation(ng)[:kg] for _ in range(b)]).astype(np.int32)
    return s, gi


@pytest.mark.parametrize(
    "b,num_items,k,kg,ties,sentinel",
    [
        (8, 1024, 20, 20, False, False),  # random
        (8, 1000, 20, 20, False, False),  # pad tail inside selected groups
        (4, 129, 5, 2, True, False),  # one-lane tail group, ties
        (5, 1000, 20, 20, False, False),  # batch not a multiple of 8
        (16, 777, 7, 7, True, False),  # ties: group rank, then lane
        (6, 1000, 10, 10, False, True),  # finfo.min sentinels
    ],
    ids=["random", "pad_tail", "tail_ties", "batch5", "ties", "sentinels"],
)
def test_select_topk_from_groups_bit_identical_to_jax(b, num_items, k, kg, ties, sentinel):
    s, gi = _slab(b, num_items, kg, ties=ties, sentinel=sentinel)
    want_v, want_i = jax_select(
        jnp.asarray(s), jnp.asarray(gi), k=k, num_items=num_items, interpret=True
    )
    got_v, got_i = kernels.select_topk_from_groups(
        torch.from_numpy(s), torch.from_numpy(gi), k=k, num_items=num_items
    )
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy().view(np.int32), np.asarray(want_v).view(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_select_topk_from_groups_domain():
    s = torch.zeros(2, 33 * 128)
    gi = torch.arange(33, dtype=torch.int32).repeat(2, 1)
    for args, match in [
        ((s, gi, 5), "33 groups"),  # KG > 32
        ((s, gi[:, :2], 257), "k=257"),  # k > KG * 128
        ((s, gi[:, :2], 0), "k=0"),
        ((s.double(), gi[:, :2], 5), "float32"),
        ((s[:, :-1], gi[:, :2], 5), "whole 128-item groups"),
        ((s, gi[:, :2].long(), 5), "int32"),
    ]:
        with pytest.raises(ValueError, match=match):
            kernels.select_topk_from_groups(args[0], args[1], k=args[2], num_items=4000)


def _normal(seed, n, d, b, shift=0.0):
    rng = np.random.default_rng(seed)
    items = rng.normal(shift, 1.0, (n, d)).astype(np.float32)
    queries = rng.normal(0.0, 1.0, (b, d)).astype(np.float32)
    return queries, items


def _dyadic(seed, n, d, b, shift=0):
    """Multiples of 1/4 in [-1, 1] (+ shift): exact in bf16, exact sums."""
    rng = np.random.default_rng(seed)
    items = (rng.integers(-4, 5, (n, d)) / 4 + shift).astype(np.float32)
    queries = (rng.integers(-4, 5, (b, d)) / 4).astype(np.float32)
    return queries, items


def _mask(q, items, width, k, seed):
    """Blocked ids that bite: each query's unmasked top ids (every other
    one), a few random ids, and the padding id N (dropped)."""
    n = items.shape[0]
    top = np.argsort(-(q @ items.T), axis=1, kind="stable")[:, : 2 * k : 2]
    rng = np.random.default_rng(seed)
    mask = np.full((q.shape[0], width), n, np.int32)
    for row in range(q.shape[0]):
        ids = list(top[row][: width - 3]) + list(rng.integers(0, n, 2))
        mask[row, : len(ids)] = ids
    return mask


def _check(got, want):
    gs, gi = (t.numpy() for t in got)
    ws, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi.astype(np.int64))
    np.testing.assert_allclose(gs, ws, rtol=1e-5)


@pytest.mark.parametrize("k", [20, 40], ids=["select_kernel", "gather"])
@pytest.mark.parametrize("n,shift", [(3000, 0.0), (2900, -2.0)])
def test_masked_group_exact_float32_matches_jax(k, n, shift):
    q, items = _normal(0, n, 32, 24, shift)
    mask = _mask(q, items, 12, k, 1)
    want = jax_mips_topk(
        jnp.asarray(q), jnp.asarray(items), k=k, mask_rows=jnp.asarray(mask),
        algorithm="group_exact",
    )
    got = mips_topk(
        torch.from_numpy(q), torch.from_numpy(items), k=k, mask_rows=torch.from_numpy(mask),
        algorithm="group_exact",
    )
    _check(got, want)
    for ids, blocked in zip(got[1].numpy(), mask):
        assert not np.isin(ids, blocked).any()


def test_masked_group_exact_bfloat16_matches_jax():
    q, items = _dyadic(1, 2900, 16, 24, -1)
    mask = _mask(q, items, 10, 20, 2)
    kw = dict(k=20, algorithm="group_exact", score_dtype="bfloat16")
    want = jax_mips_topk(jnp.asarray(q), jnp.asarray(items), mask_rows=jnp.asarray(mask), **kw)
    got = mips_topk(
        torch.from_numpy(q), torch.from_numpy(items), mask_rows=torch.from_numpy(mask), **kw
    )
    _check(got, want)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_masked_fused_matches_jax(score_dtype):
    n = 1000
    q, items = _dyadic(2, n, 16, 8, -1)
    mask = _mask(q, items, 6, 4, 3)
    jdt = jnp.float32 if score_dtype == "float32" else jnp.bfloat16
    want = _fused_groupmax_topk(
        jnp.asarray(q).astype(jdt), jnp.asarray(items).astype(jdt), 4, n,
        mask_rows=jnp.asarray(mask), use_pallas=False, interpret=True,
    )
    got = mips_topk(
        torch.from_numpy(q), torch.from_numpy(items), k=4, mask_rows=torch.from_numpy(mask),
        algorithm="fused", score_dtype=score_dtype,
    )
    _check(got, want)


def test_topk_with_mask_matches_jax():
    q, items = _normal(4, 1000, 16, 9)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    mask = _mask(q, items, 6, 10, 4)
    want = jax_topk_with_mask(
        jnp.asarray(q), jnp.asarray(items), k=10, mask_rows=jnp.asarray(mask),
        normalize_queries=True,
    )
    got = topk_with_mask(
        torch.from_numpy(q), torch.from_numpy(items), k=10, mask_rows=torch.from_numpy(mask),
        normalize_queries=True,
    )
    _check(got, want)


def test_masked_auto_routing(monkeypatch):
    """bf16 takes fused from the crossover only with masks up to 32 wide."""
    from ttamm_torch.ops import topk

    q, items = _normal(5, 600, 16, 4)
    qt, it = torch.from_numpy(q), torch.from_numpy(items)
    monkeypatch.setattr(topk, "BF16_FUSED_MIN_ITEMS", 600)
    calls = []
    for name in ("_fused_groupmax_topk", "_group_exact_topk"):
        real = getattr(topk, name)
        monkeypatch.setattr(
            topk, name, lambda *a, _real=real, _name=name, **kw: calls.append(_name) or _real(*a, **kw)
        )
    for width in (32, 33):
        mask = torch.full((4, width), 600, dtype=torch.int32)
        mips_topk(qt, it, k=5, mask_rows=mask, score_dtype="bfloat16")
    assert calls == ["_fused_groupmax_topk", "_group_exact_topk"]
