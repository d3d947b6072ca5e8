"""The port's losses, negative sampling and optimizers against the JAX
package, on the CPU (Pallas kernels in interpret mode).

Tolerances: float32 on both sides with sums in another order: losses and
gradients rtol 1e-5 (atol 1e-6 to 1e-7 at their scales); optimizer states
after three steps atol 1e-6 (Adam's first steps move each parameter by
about lr = 1e-2 here, and the two bias corrections are computed in another
precision). Negative sampling is tested by its properties, because JAX's
threefry streams cannot be reproduced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.ops.losses import bce_with_logits, category_alignment_loss
from ttamm_torch.ops.sampling import sample_negative_items
from ttamm_torch.ops.sparse_adam import coalesce_row_grads, init_sparse_adam, sparse_adam_update, sum_rows
from ttamm_torch.train import optim
from ttamm_tpu.ops import losses as jax_losses
from ttamm_tpu.ops import sparse_adam as jax_sparse
from ttamm_tpu.train import optim as jax_optim


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(500) * 8).astype(np.float32)
    y = (rng.random(500) < 0.3).astype(np.float32)
    want = jax_losses.bce_with_logits(jnp.asarray(x), jnp.asarray(y))
    got = bce_with_logits(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _cal_inputs(seed, n=240, d=128, c=16):
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.geometric(0.35, n) - 1, c + 2).astype(np.int32)
    x = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    return ids, x


@pytest.mark.parametrize("case", ["skewed", "major_alone", "one_category"])
def test_category_alignment_loss_and_grad_match_jax(case):
    """Value and embedding gradient against the JAX loss with its Pallas
    second-moment kernel (C = 16, D = 128: the kernel's gate)."""
    ids, x = _cal_inputs(1)
    if case == "major_alone":
        ids[ids == 0] = 1
        ids[0] = 0  # the major category has one member: the loss is 0
    elif case == "one_category":
        ids[:] = 0  # nothing to compare: the loss is 0

    def jax_loss(xx):
        return jax_losses.category_alignment_loss(
            jnp.asarray(ids), xx, max_categories=16, use_pallas=True
        )

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = category_alignment_loss(torch.from_numpy(ids), xt, max_categories=16)
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
    if case != "skewed":
        assert float(got.detach()) == 0.0


def test_negative_sampling_properties():
    rng = np.random.default_rng(2)
    num_items, cap = 50, 6
    pos = np.full((300, cap), num_items, np.int32)  # pad = num_items
    for row in pos:
        k = rng.integers(0, cap + 1)
        row[:k] = rng.choice(num_items, k, replace=False)
    gen = torch.Generator().manual_seed(0)
    neg = sample_negative_items(
        torch.from_numpy(pos), num_items=num_items, num_negatives=5, generator=gen,
        num_rounds=30,
    )
    assert neg.shape == (300, 5) and neg.dtype == torch.int32
    neg = neg.numpy()
    assert neg.min() >= 0 and neg.max() < num_items
    assert not np.any(neg[:, :, None] == pos[:, None, :])  # no positives
    assert len(np.unique(neg)) > 40  # uniform over the catalogue
    again = sample_negative_items(
        torch.from_numpy(pos), num_items=num_items, num_negatives=5,
        generator=torch.Generator().manual_seed(0), num_rounds=30,
    )
    np.testing.assert_array_equal(again.numpy(), neg)  # the generator decides
    with pytest.raises(ValueError, match="num_negatives"):
        sample_negative_items(torch.from_numpy(pos), num_items=9, num_negatives=0, generator=gen)
    with pytest.raises(ValueError, match="num_items"):
        sample_negative_items(torch.from_numpy(pos), num_items=1, num_negatives=2, generator=gen)


def test_coalesce_row_grads_matches_jax():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 10, 40).astype(np.int32)
    g = rng.standard_normal((40, 8)).astype(np.float32)
    want_t, want_g = jax_sparse.coalesce_row_grads(jnp.asarray(idx), jnp.asarray(g), scratch_row=10)
    got_t, got_g = coalesce_row_grads(torch.from_numpy(idx), torch.from_numpy(g), scratch_row=10)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [0, 1, 777])
def test_coalesce_row_grads_sums_each_run_in_lane_order(n):
    """Each run of a row is summed left to right, in f32, with no atomics:
    the same bits as a sequential loop over the sorted lanes."""
    rng = np.random.default_rng(n)
    idx = rng.integers(0, 50, n).astype(np.int32)
    g = rng.standard_normal((n, 8)).astype(np.float32)
    got_t, got_g = coalesce_row_grads(torch.from_numpy(idx), torch.from_numpy(g), scratch_row=50)
    order = np.argsort(idx, kind="stable")
    want_t = np.full(n, 50, np.int32)
    want_g = np.zeros_like(g)
    for pos, lane in enumerate(order):
        if pos == 0 or idx[lane] != idx[order[pos - 1]]:
            head = pos
            want_t[pos] = idx[lane]
        want_g[head] += g[lane]
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    # the table-shaped sum (dense-table gradients, category sums) from the
    # same runs, differentiable in the rows
    x = torch.from_numpy(g).requires_grad_()
    summed = sum_rows(torch.from_numpy(idx), x, 50)
    np.testing.assert_array_equal(summed.detach().numpy(), _table_sum(idx, g, 50))
    if n:
        (dx,) = torch.autograd.grad(summed, x, torch.ones_like(summed))
        np.testing.assert_array_equal(dx.numpy(), np.ones_like(g))


def _table_sum(idx, g, rows):
    out = np.zeros((rows, g.shape[1]), np.float32)
    for lane in np.argsort(idx, kind="stable"):
        out[idx[lane]] += g[lane]
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_sparse_adam_with_duplicates_matches_jax(weight_decay):
    """Three steps with duplicate-heavy indices against the JAX update on
    its row-kernel path (use_pallas=True, kernels interpreted)."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((41, 128)).astype(np.float32)  # 40 rows + scratch
    j_table, j_state = jnp.asarray(table), jax_sparse.init_sparse_adam(jnp.asarray(table))
    t_table = torch.from_numpy(table.copy())
    t_state = init_sparse_adam(t_table)
    for _ in range(3):
        idx = rng.integers(0, 40, 64).astype(np.int32)
        idx[:20] = idx[0]
        g = rng.standard_normal((64, 128)).astype(np.float32)
        j_table, j_state = jax_sparse.sparse_adam_update(
            j_table, j_state, jnp.asarray(idx), jnp.asarray(g), lr=0.01,
            weight_decay=weight_decay, use_pallas=True,
        )
        sparse_adam_update(
            t_table, t_state, torch.from_numpy(idx), torch.from_numpy(g), lr=0.01,
            weight_decay=weight_decay,
        )
    assert t_state.step == int(j_state.step) == 3
    for got, want in ((t_table, j_table), (t_state.m, j_state.m), (t_state.v, j_state.v)):
        np.testing.assert_allclose(got.numpy()[:40], np.asarray(want)[:40], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(name="adam", lr=0.01, weight_decay=0.1),
        dict(name="adamw", lr=0.01, weight_decay=0.01),
        dict(name="adamw", lr=0.01, weight_decay=0.01, lr_schedule="cosine",
             lr_total_steps=4, lr_final_factor=0.1),
        dict(name="sgd", lr=0.1, weight_decay=0.01, momentum=0.9),
    ],
    ids=["adam", "adamw", "adamw_cosine", "sgd_momentum"],
)
def test_dense_opt_update_matches_jax(cfg):
    rng = np.random.default_rng(5)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((7, 5), (5,), (3, 4, 2))]
    j_params = [jnp.asarray(p) for p in params]
    j_state = jax_optim.init_dense_opt(j_params)
    t_params = [torch.from_numpy(p.copy()) for p in params]
    t_state = optim.init_dense_opt(t_params)
    jcfg, tcfg = jax_optim.DenseOptConfig(**cfg), optim.DenseOptConfig(**cfg)
    for _ in range(3):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        j_params, j_state = jax_optim.dense_opt_update(
            j_params, [jnp.asarray(g) for g in grads], j_state, jcfg
        )
        optim.dense_opt_update(t_params, [torch.from_numpy(g) for g in grads], t_state, tcfg)
    assert t_state.step == int(j_state.step) == 3
    for got, want in zip(t_params, j_params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for got, want in zip(t_state.m, j_state.m):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_lr_schedule_and_config_parsing_match_jax():
    training = {
        "optimizer": "adamw", "learning_rate": 0.002, "weight_decay": 0.01,
        "betas": [0.8, 0.99], "lr_schedule": {"type": "linear", "final_factor": 0.2},
    }
    jcfg = jax_optim.parse_dense_opt_config(training, total_steps=50)
    tcfg = optim.parse_dense_opt_config(training, total_steps=50)
    assert tuple(tcfg) == tuple(jcfg)
    for schedule in ("linear", "cosine", "constant"):
        j = jcfg._replace(lr_schedule=schedule)
        t = tcfg._replace(lr_schedule=schedule)
        for step in (1, 10, 50, 80):
            np.testing.assert_allclose(
                optim.lr_scale(t, step), float(jax_optim.lr_scale(j, jnp.int32(step))), rtol=1e-6
            )
    with pytest.raises(ValueError, match="optimizer"):
        optim.parse_dense_opt_config({"optimizer": "lion"})
