"""The port's ``mips_topk`` (ttamm_torch/ops/topk.py) against the JAX
package's on the CPU: group_exact in float32 and bfloat16, and fused (JAX
side: ``_fused_groupmax_topk`` with its Pallas kernels in interpret mode).

Tolerances: ids must be equal and scores within rtol 1e-5. The bf16 and
fused cases use small dyadic inputs whose products and sums are exact in
f32, so both sides compute identical scores and ties (which these inputs
have plenty of) must break identically.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.ops.topk import mips_topk
from ttamm_tpu.ops.topk import _fused_groupmax_topk
from ttamm_tpu.ops.topk import mips_topk as jax_mips_topk


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


def _check(got, want):
    gs, gi = (t.numpy() for t in got)
    ws, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi.astype(np.int64))
    np.testing.assert_allclose(gs, ws, rtol=1e-5)


# (num_items, item shift): a multiple of 128, a ragged tail, and an
# all-negative corpus whose zero pad rows would win if left unmasked.
SHAPES = [(2560, 0.0), (3000, 0.0), (2900, -2.0)]


@pytest.mark.parametrize("n,shift", SHAPES)
def test_group_exact_float32_matches_jax(n, shift):
    q, items = _normal(0, n, 32, 24, shift)
    want = jax_mips_topk(jnp.asarray(q), jnp.asarray(items), k=20, algorithm="group_exact")
    got = mips_topk(torch.from_numpy(q), torch.from_numpy(items), k=20, algorithm="group_exact")
    _check(got, want)
    assert got[1].max() < n


@pytest.mark.parametrize("n,shift", SHAPES)
def test_group_exact_bfloat16_matches_jax(n, shift):
    q, items = _dyadic(1, n, 16, 24, shift)
    kw = dict(k=20, algorithm="group_exact", score_dtype="bfloat16")
    want = jax_mips_topk(jnp.asarray(q), jnp.asarray(items), **kw)
    got = mips_topk(torch.from_numpy(q), torch.from_numpy(items), **kw)
    _check(got, want)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,shift", [(3000, 0), (2900, -2)])
def test_fused_matches_jax(n, shift, score_dtype):
    q, items = _dyadic(2, n, 16, 8, shift)
    jdt = jnp.float32 if score_dtype == "float32" else jnp.bfloat16
    want = _fused_groupmax_topk(
        jnp.asarray(q).astype(jdt), jnp.asarray(items).astype(jdt), 4, n,
        use_pallas=False, interpret=True,
    )
    got = mips_topk(
        torch.from_numpy(q), torch.from_numpy(items), k=4,
        algorithm="fused", score_dtype=score_dtype,
    )
    _check(got, want)


def test_num_valid_rows_on_a_padded_corpus():
    q, items = _normal(3, 300, 16, 7, -2.0)
    padded = np.concatenate([items, np.zeros((84, 16), np.float32)])
    for algorithm in ("group_exact", "fused"):
        s0, i0 = mips_topk(torch.from_numpy(q), torch.from_numpy(items), k=9, algorithm=algorithm)
        s1, i1 = mips_topk(
            torch.from_numpy(q), torch.from_numpy(padded), k=9,
            num_valid_rows=300, algorithm=algorithm,
        )
        assert torch.equal(i0, i1) and torch.equal(s0, s1)
        assert int(i1.max()) < 300


def test_query_blocking_matches_one_block():
    from ttamm_torch.ops.topk import _group_exact_topk

    q, items = _normal(4, 1000, 16, 10)
    qt, it = torch.from_numpy(q), torch.from_numpy(items)
    whole = _group_exact_topk(qt, it, 5, 1000)
    blocked = _group_exact_topk(qt, it, 5, 1000, scores_bytes_budget=3 * 1024 * 4)
    # BLAS may order the f32 sums differently for another number of rows.
    assert torch.equal(whole[1], blocked[1])
    torch.testing.assert_close(whole[0], blocked[0], rtol=1e-6, atol=0)


def test_auto_routing(monkeypatch):
    """float32 takes group_exact (full f32); bf16 takes fused from the
    crossover; a float32 search past the slab ceiling takes chunked and
    returns the JAX package's chunked answer."""
    from ttamm_torch.ops import topk

    q, items = _normal(5, 600, 16, 4)
    qt, it = torch.from_numpy(q), torch.from_numpy(items)
    exact = topk._group_exact_topk(qt, it, 5, 600)
    assert all(torch.equal(a, b) for a, b in zip(mips_topk(qt, it, k=5), exact))

    q16, it16 = qt.to(torch.bfloat16), it.to(torch.bfloat16)
    fused = topk._fused_groupmax_topk(q16, it16, 5, 600)
    monkeypatch.setattr(topk, "BF16_FUSED_MIN_ITEMS", 600)
    got = mips_topk(qt, it, k=5, score_dtype="bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(got, fused))

    monkeypatch.setattr(topk, "SCORES_BYTES_CEILING", 64 * 4 * 599)
    want = jax_mips_topk(jnp.asarray(q), jnp.asarray(items), k=5, algorithm="chunked")
    _check(mips_topk(qt, it, k=5), want)


@pytest.mark.parametrize("algorithm", ["auto", "fused"])
@pytest.mark.parametrize("dim", [640, 648])
def test_fused_routes_within_the_kernels_limits(monkeypatch, dim, algorithm):
    """A bf16 search that would go to 'fused' goes to 'group_exact' exactly
    where groupmax_matmul refuses the shape (D > 640), for 'auto' and an
    explicit 'fused', as the JAX package reroutes a fused search its kernels
    cannot take; the answer is the JAX package's for that algorithm. Sparse
    dyadic items keep every score exact in bf16, so ids must be equal."""
    from ttamm_torch.ops import kernels, topk

    rng = np.random.default_rng(dim)
    n = 600
    items = np.zeros((n, dim), np.float32)
    cols = rng.integers(0, dim, (n, 6))
    np.put_along_axis(items, cols, rng.integers(-4, 5, (n, 6)) / 4, 1)
    q = (rng.integers(-4, 5, (4, dim)) / 4).astype(np.float32)
    monkeypatch.setattr(topk, "BF16_FUSED_MIN_ITEMS", n)
    ran = []
    for name in ("_fused_groupmax_topk", "_group_exact_topk"):
        fn = getattr(topk, name)
        monkeypatch.setattr(topk, name, lambda *a, _fn=fn, _name=name, **kw: ran.append(_name) or _fn(*a, **kw))
    got = mips_topk(
        torch.from_numpy(q), torch.from_numpy(items), k=5, algorithm=algorithm, score_dtype="bfloat16",
    )
    fits = kernels.groupmax_matmul_fits(4, 640, dim)
    assert fits == (dim <= kernels.MAX_DIM)
    assert ran == ["_fused_groupmax_topk" if fits else "_group_exact_topk"]
    q16, it16 = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(items).astype(jnp.bfloat16)
    if fits:
        want = _fused_groupmax_topk(q16, it16, 5, n, use_pallas=False, interpret=True)
    else:
        want = jax_mips_topk(q16, it16, k=5, algorithm="group_exact", score_dtype="bfloat16")
    _check(got, want)

    # past the slab ceiling a refused fused search scans in chunks, as the
    # JAX package's bf16 chunked search does
    monkeypatch.setattr(topk, "SCORES_BYTES_CEILING", 64 * 4 * (n - 1))
    ran.clear()
    got = mips_topk(torch.from_numpy(q), torch.from_numpy(items), k=5, algorithm=algorithm,
                    score_dtype="bfloat16")
    if fits:
        assert ran == ["_fused_groupmax_topk"]
    else:
        assert ran == []  # neither slab nor fused: the chunk scan
        want = jax_mips_topk(q16, it16, k=5, algorithm="chunked", score_dtype="bfloat16")
    _check(got, want)
