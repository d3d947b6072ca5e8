"""The port's in-batch softmax against the JAX package, on the CPU: the loss
(``ttamm_tpu.train.step._in_batch_softmax_loss``), its data-shard form, the
eval-loss step and one train step with dense (AdamW) mimic tables.

Inputs come from numpy seeds (tests/torch_step_setup.py builds one state on
both sides). Tolerances: the loss rtol 1e-5 and its gradients atol 1e-6
(float32 on both sides; the sums run in another order); the loss over data
shards, each mean weighted by its share of the batch, rtol 1e-6 of the
whole batch's; the eval loss rtol 1e-5; after three train steps losses
rtol 1e-5 and every state leaf atol 2e-5 (as
tests/test_torch_port_train_step.py: Adam's step lr * m / (sqrt(v) + eps)
turns gradient differences into parameter differences of at most ~1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_step_setup as ts
from ttamm_torch.train import make_eval_loss_step
from ttamm_torch.train.step import _data_shard, in_batch_softmax_loss
from ttamm_tpu.train import step as jax_step

B, DL, NI = 12, 16, 30


def _loss_inputs(m: int, seed: int = 0):
    """Embeddings, ids and log q of a batch whose positives repeat (rows 1,
    3 and 7 share an item) and whose pool holds row 5's positive."""
    rng = np.random.default_rng(seed)
    user = rng.normal(0, 1, (B, DL)).astype(np.float32)
    pos = rng.normal(0, 1, (B, DL)).astype(np.float32)
    neg = rng.normal(0, 1, (m, DL)).astype(np.float32)
    pos_idx = rng.integers(0, NI, B).astype(np.int32)
    pos_idx[[3, 7]] = pos_idx[1]
    neg_idx = rng.integers(0, NI, m).astype(np.int32)
    if m:
        neg_idx[2] = pos_idx[5]
    log_q = np.log(rng.dirichlet(np.full(NI, 0.5)) + 1e-6).astype(np.float32)
    return user, pos, neg, pos_idx, neg_idx, log_q


def _port_loss(user, pos, neg, pos_idx, neg_idx, log_q, temperature, rows=None):
    """The port's loss and its gradients in (user, pos, neg); ``rows`` (lo,
    hi) takes those rows of the batch as a data shard would."""
    u, p, n = (torch.tensor(x, requires_grad=True) for x in (user, pos, neg))
    lo, hi = rows or (0, B)
    cand = None if log_q is None else torch.from_numpy(log_q[np.concatenate([pos_idx, neg_idx])])
    loss = in_batch_softmax_loss(
        u[lo:hi], p, torch.from_numpy(pos_idx), neg_emb=n, neg_idx=torch.from_numpy(neg_idx),
        num_items=NI, cand_log_q=cand, temperature=temperature, row_offset=lo,
    )
    grads = torch.autograd.grad(loss, (u, p, n), allow_unused=True)
    return loss.detach(), [np.zeros(x.shape, np.float32) if g is None else g.numpy()
                           for x, g in zip((user, pos, neg), grads)]


@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("logq", [True, False])
@pytest.mark.parametrize("m", [0, 6])
def test_in_batch_softmax_loss_matches_jax(m, logq, temperature):
    user, pos, neg, pos_idx, neg_idx, log_q = _loss_inputs(m)
    log_q = log_q if logq else None

    def jloss(u, p, n):
        return jax_step._in_batch_softmax_loss(
            u, p, jnp.asarray(pos_idx), neg_emb=n, neg_idx=jnp.asarray(neg_idx), num_items=NI,
            log_q=None if log_q is None else jnp.asarray(log_q), temperature=temperature,
        )

    want, want_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(user), jnp.asarray(pos), jnp.asarray(neg)
    )
    got, got_grads = _port_loss(user, pos, neg, pos_idx, neg_idx, log_q, temperature)
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for name, g, w in zip(("user", "pos", "pool"), got_grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dp", [2, 5])
@pytest.mark.parametrize("m", [0, 6])
def test_in_batch_softmax_loss_over_data_shards_sums_to_the_batch(m, dp):
    """A mesh rank's rows ``[lo, hi)`` against every candidate, weighted by
    (hi - lo) / B: the shards' sum is the whole batch's loss and gradient
    (dp = 5 leaves the last shard empty)."""
    x = _loss_inputs(m, seed=1)
    want, want_grads = _port_loss(*x, 0.5)
    total, grads = 0.0, [np.zeros_like(g) for g in want_grads]
    for d in range(dp):
        lo, hi = _data_shard(B, dp, d)
        if hi == lo:
            continue
        loss, g = _port_loss(*x, 0.5, rows=(lo, hi))
        total += float(loss) * (hi - lo) / B
        grads = [a + b * (hi - lo) / B for a, b in zip(grads, g)]
    np.testing.assert_allclose(total, float(want), rtol=1e-6)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("m", [0, 8])
def test_eval_loss_step_matches_jax_at_a_ragged_batch(m):
    """The eval loss of a last batch shorter than the others (13 rows, with
    a repeated positive): the in-batch softmax with its own pool, no
    dropout, no auxiliary terms."""
    jx, pt, pos, rng = ts.setup(mixed=m)
    u, p = ts.batch(rng, pos, 13)
    key = jax.random.key(9)
    want = jax_step.make_eval_loss_step(jx.cfg, jx.tscfg)(
        jx.state, jx.data, jnp.asarray(u), jnp.asarray(p), key
    )
    got = make_eval_loss_step(pt.cfg, pt.tscfg)(
        pt.state, pt.data, torch.from_numpy(u), torch.from_numpy(p), generator=None,
        negatives=torch.from_numpy(ts.jax_pool(key, m)),
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_train_step_with_dense_mimic_matches_jax():
    """The in-batch loss with dense-AdamW mimic tables (ROADMAP's item 3
    configuration), 8 mixed negatives, temperature 0.5: three steps."""
    jx, pt, pos, rng = ts.setup(mimic_sparse=False, mixed=8, temperature=0.5)
    ts.assert_steps_match(*ts.run_steps(jx, pt, pos, rng))
