"""``training.comm_dtype: bfloat16`` and ``data.features_dtype: bfloat16``
on one device, against the JAX package, on the CPU.

The wire cast rounds every table-row gradient to bf16 once: a dense
table's lanes before the clip's norm, a sparse table's lanes after the
clip's scale; the update math stays float32 after the widen. bf16 feature
matrices are widened in the towers.

Tolerances:

- each rounding point from identical float32 lanes (both sides round the
  same values, round-to-nearest-even): the sparse update against the JAX
  ``sparse_adam_update`` on its row-kernel path at the update tests'
  rtol 1e-5 / atol 1e-6; the dense table gradient against the JAX
  scatter-add of the rounded lanes at atol 1e-7 (float32 sums of the same
  rounded values in another order);
- whole steps (three, from one state, as tests/test_torch_port_train_step.py):
  losses rtol 1e-5; every state leaf within the step tests' atol 2e-5 but
  for the elements a rounding flip moved. The two packages sum a lane's
  float32 gradient in another order, so a lane within ~1e-7 of a bf16
  rounding boundary may round to the other neighbour on one side. Adam's
  step moves an element by about lr * sign(g), so a flip moves it by up to
  ~2 * lr a step: such elements are bounded by 2.5 * lr * steps (the JAX
  package's own bf16-vs-float32 bound, tests/test_parallel.py, per step)
  and may be at most 0.1% of a leaf. The comparison against the float32
  step shows that the rounding happened;
- the encodes through bf16 features: rtol 1e-5, atol 1e-6 (the same bf16
  rows widened, float32 matmuls in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_step_setup as ts
from test_torch_port_train_step import _batch, _setup
from ttamm_torch.evaluation import encode_user_batch
from ttamm_torch.models.convert import train_state_to_flat
from ttamm_torch.ops.sparse_adam import init_sparse_adam, sparse_adam_update
from ttamm_torch.pipelines.training import run_single_experiment
from ttamm_torch.train import BatchData, TrainStepConfig, encode_corpus, make_train_step
from ttamm_torch.train.step import _OneDevice
from ttamm_tpu.evaluation.retrieval import encode_user_batch as jax_encode_user_batch
from ttamm_tpu.ops import sparse_adam as jax_sparse
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import step as jax_step

STEPS, LR = 3, 1e-3
STEP_ATOL = 2e-5
FLIP_BOUND = 2.5 * LR * STEPS  # elements a bf16 rounding flip moved
FLIP_SHARE = 1e-3


def _assert_leaves_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in want:
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        err = np.abs(g - w)
        flipped = err > STEP_ATOL
        assert err.max(initial=0.0) <= FLIP_BOUND, (key, err.max())
        assert flipped.sum() <= max(1, FLIP_SHARE * err.size), (key, int(flipped.sum()))


@pytest.mark.parametrize("clip", [None, 0.5])
def test_bce_dense_mimic_comm_bf16_steps_match_jax(clip):
    """configs/default.yaml's structure (BCE, dense mimic tables on AdamW,
    sparse ID tables), the clip off and binding; beside it the port's
    float32 step, which the rounding moves."""
    (jcfg, jt, jstate, jdata), (pcfg, pt, pstate, pdata), pos, rng = _setup("default")
    exact_state = _setup("default")[1][2]
    jt = jt._replace(comm_dtype="bfloat16", gradient_clip_norm=clip)
    pt = pt._replace(gradient_clip_norm=clip)
    jstep = jax_step.make_train_step(jcfg, jt)
    pstep, fstep = make_train_step(pcfg, pt._replace(comm_dtype="bfloat16")), make_train_step(pcfg, pt)
    for s in range(STEPS):
        key = jax.random.fold_in(jax.random.key(5), s)
        u, p, neg = (torch.from_numpy(a) for a in _batch(rng, pos, key))
        jstate, jm = jstep(jstate, jdata, jnp.asarray(u.numpy()), jnp.asarray(p.numpy()), key)
        pstate, pm = pstep(pstate, pdata, u, p, generator=None, negatives=neg)
        exact_state, _ = fstep(exact_state, pdata, u, p, generator=None, negatives=neg)
        for name in jm:
            np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    got = train_state_to_flat(pstate)
    _assert_leaves_close(got, jax_ckpt.state_to_host(jstate))
    exact = train_state_to_flat(exact_state)
    for key in ("tables/item_id", "tables/user_aug"):  # a sparse and a dense table rounded
        assert not np.array_equal(exact[key], got[key]), key


def test_in_batch_sparse_mimic_comm_bf16_steps_match_jax():
    """configs/pod_2x4.yaml's loss and tables: the in-batch softmax with a
    pool, sparse mimic tables, the clip binding."""
    jx, pt, pos, rng = ts.setup(mimic_sparse=True, clip=0.5, mixed=5)
    jx = jx._replace(tscfg=jx.tscfg._replace(comm_dtype="bfloat16"))
    pt = pt._replace(tscfg=pt.tscfg._replace(comm_dtype="bfloat16"))
    losses, want, got = ts.run_steps(jx, pt, pos, rng, steps=STEPS)
    for jm, pm in losses:
        for name in jm:
            np.testing.assert_allclose(pm[name], jm[name], rtol=1e-5, atol=1e-7, err_msg=name)
    _assert_leaves_close(got, want)


@pytest.mark.parametrize("layout", ["duplicates", "distinct"])
def test_sparse_rounding_point_matches_jax(layout):
    """The sparse tables' rounding point from identical float32 lanes: the
    JAX step hands ``comm_cast(lanes)`` to ``sparse_adam_update``, which
    widens before the coalesce; the port's ``_Lanes.on_wire`` and
    ``sparse_adam_update`` the same, two steps."""
    rng = np.random.default_rng(3)
    rows, d, n = 80, 128, 64
    table = rng.standard_normal((rows + 1, d)).astype(np.float32)
    table[-1] = 0.0
    j_table, j_state = jnp.asarray(table), jax_sparse.init_sparse_adam(jnp.asarray(table))
    t_table = torch.from_numpy(table.copy())
    t_state = init_sparse_adam(t_table)
    for _ in range(2):
        idx = rng.integers(0, rows, n).astype(np.int32)
        if layout == "duplicates":
            idx[: n // 3] = idx[0]
        else:
            idx = rng.permutation(rows)[:n].astype(np.int32)
        g = (rng.standard_normal((idx.size, d)) * 1e-3).astype(np.float32)
        j_table, j_state = jax_sparse.sparse_adam_update(
            j_table, j_state, jnp.asarray(idx), jnp.asarray(g).astype(jnp.bfloat16), lr=LR,
            use_pallas=True,
        )
        sparse_adam_update(t_table, t_state, torch.from_numpy(idx),
                           torch.from_numpy(g).to(torch.bfloat16), lr=LR)
    for got, want in ((t_table, j_table), (t_state.m, j_state.m), (t_state.v, j_state.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_dense_rounding_point_matches_jax():
    """A dense table's rounding point: each lane rounded, widened, then
    summed into the table-shaped gradient (the JAX step's
    ``zeros.at[idx].add(comm_cast(g).astype(f32))``), duplicates included."""
    rng = np.random.default_rng(4)
    rows, d, n = 50, 16, 96
    idx = rng.integers(0, rows, n).astype(np.int32)
    idx[:20] = 7
    g = rng.standard_normal((n, d)).astype(np.float32)
    want = jnp.zeros((rows, d), jnp.float32).at[jnp.asarray(idx)].add(
        jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    layout = _OneDevice(TrainStepConfig(num_items=1, comm_dtype="bfloat16"))
    got = layout.table_grad(torch.from_numpy(g), torch.from_numpy(idx), torch.zeros(rows, d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    exact = _OneDevice(TrainStepConfig(num_items=1)).table_grad(
        torch.from_numpy(g), torch.from_numpy(idx), torch.zeros(rows, d))
    assert not torch.equal(exact, got)


def test_bf16_feature_encodes_match_jax():
    """bf16 feature matrices (``data.features_dtype``): the corpus encode
    and the eval's user encode widen the gathered rows as JAX does."""
    jx, pt, _, _ = ts.setup(mimic_sparse=True)
    jdata = jx.data._replace(user_features=jx.data.user_features.astype(jnp.bfloat16),
                             item_features=jx.data.item_features.astype(jnp.bfloat16))
    pdata = BatchData(pt.data.user_features.to(torch.bfloat16),
                      pt.data.item_features.to(torch.bfloat16),
                      pt.data.positive_rows, pt.data.category_ids, pt.data.item_log_q)
    for side, rows in (("user", ts.NU), ("item", ts.NI)):
        want = jax_step.encode_corpus(jx.state, jdata, jx.cfg, side, num_rows=rows, chunk_size=64)
        feats = pdata.user_features if side == "user" else pdata.item_features
        got = encode_corpus(pt.state.model.eval(), side, feats, chunk_size=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    idx = np.array([0, 5, 17, 299, 5], np.int32)
    want = jax_encode_user_batch(jx.state, jdata, jx.cfg, jnp.asarray(idx))
    got = encode_user_batch(pt.state.model, pdata, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the float32 features give other embeddings: the bf16 rows were read
    f32 = encode_user_batch(pt.state.model, pt.data, torch.from_numpy(idx))
    assert not torch.equal(f32, got)


def test_unknown_wire_dtypes_raise():
    """As the JAX package: an unknown ``comm_dtype`` or
    ``embedding_exchange`` refuses the step, an unknown
    ``data.features_dtype`` the run."""
    with pytest.raises(ValueError, match="Unknown comm_dtype"):
        make_train_step(_setup("default")[1][0], TrainStepConfig(num_items=4, comm_dtype="fp8"))
    with pytest.raises(ValueError, match="Unknown embedding_exchange"):
        make_train_step(_setup("default")[1][0],
                        TrainStepConfig(num_items=4, embedding_exchange="ring"))
    with pytest.raises(ValueError, match="Unsupported data.features_dtype"):
        run_single_experiment({"data": {"features_dtype": "float16"}}, device="cpu")
