"""``model.precision: bfloat16`` in the port against the JAX package, on the
CPU (mirrors tests/test_precision.py).

- The tower's forward and both gradients against ``jax.grad`` of the JAX
  ``tower_forward``, for a gated tower (MLP and gate), a concat tower (MLP
  and projection) and a sum tower (linear), and the gate values. The JAX
  ``_dot`` rounds the operands to bf16 and sums in float32; its gradients
  are rounded to bf16 and widened. Tolerances: forward atol 1e-5 (the f32
  sums run in another order); every dense weight gradient of the port is
  bf16-representable, as JAX's are, and the two agree within one bf16 ulp
  of the larger (2^-7 relative: the order of the sums may move a value
  across a rounding boundary), with at least 95% of them equal bit for bit.
  The row and feature gradients atol 1e-5 + 2^-7 relative.
- Three train steps of ``configs/default.yaml``'s structure (BCE with
  injected negatives, dropout 0, sparse ID tables, dense mimic tables,
  category alignment; D = 128) at ``precision: bfloat16``: losses rtol
  1e-4, every state leaf atol 5e-5. Adam moves a parameter by about
  ``lr * g / (|g| + eps)``, at most ~lr = 1e-3 a step; where a gradient is
  within a few eps of zero, a bf16 rounding that went the other way on one
  side changes that step by a visible part of lr (the largest leaf gap in
  three steps is 3.3e-5, on a gate weight).
- Encode of the corpus from the steps' starting state against the JAX
  ``encode_corpus``, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.models import from_jax_params
from ttamm_torch.models import parse_model_config as port_parse
from ttamm_torch.models.convert import train_state_from_flat, train_state_to_flat
from ttamm_torch.models.encoders import bf16_dot, tower_gate_values
from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
from ttamm_torch.train import encode_corpus as port_encode_corpus
from ttamm_torch.train.optim import DenseOptConfig
from ttamm_tpu.models import encoders as jax_encoders
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.ops.sampling import sample_negative_items as jax_sample
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import optim as jax_optim
from ttamm_tpu.train import state as jax_state
from ttamm_tpu.train import step as jax_step

BF16_REL = 2.0**-7
NU, NI, FU, FI, D, B, NEG, C = 120, 90, 12, 9, 32, 16, 5, 16
# the step's width: D = 128 and C = 16 meet the JAX second-moment kernel's
# gate, whose bf16-operand semantics the port's moments follow
STEP_D = 128
STEP_ATOL = 5e-5


def _tower(fusion, dim=D):
    tower = {"type": "tower", "id_embedding": {"params": {"embedding_dim": dim, "sparse": True}},
             "fusion": fusion}
    if fusion == "gated":
        tower["feature_encoder"] = {"type": "mlp", "hidden_dims": [24], "output_dim": dim,
                                    "dropout": 0.0}
        tower["adaptive_mimic"] = {"hidden_dim": 20}
    elif fusion == "concat":
        tower["feature_encoder"] = {"type": "mlp", "hidden_dims": [24], "output_dim": 16,
                                    "activation": "gelu"}
        tower["output_dim"] = dim
    else:
        tower["feature_encoder"] = {"type": "linear", "output_dim": dim}
    return tower


def _model_yaml(fusion, precision="bfloat16"):
    return {"user_encoder": _tower(fusion), "item_encoder": _tower(fusion),
            "similarity": "cosine", "adaptive_mimic": {"enabled": True},
            "precision": precision}


def _twins(fusion):
    yaml = _model_yaml(fusion)
    jcfg = jax_parse(yaml, user_feature_dim=FU, item_feature_dim=FI)
    pcfg = port_parse(yaml, user_feature_dim=FU, item_feature_dim=FI)
    assert pcfg.user_tower.compute_dtype == "bfloat16"
    state = jax_state.create_train_state(jax.random.key(3), jcfg, num_users=NU, num_items=NI)
    tables, dense = jax.device_get((state.tables, state.dense))
    model = from_jax_params(pcfg, tables, dense, device="cpu")
    return jcfg, state, model


def _assert_bf16_grads_match(got, want, name):
    assert np.array_equal(got, np.asarray(torch.from_numpy(got).bfloat16().float())), (
        f"{name}: the port's gradient is not bf16-representable")
    np.testing.assert_array_equal(want, np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))
    scale = np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= BF16_REL * scale).all(), name
    assert (got == want).mean() >= 0.95, (name, (got == want).mean())


@pytest.mark.parametrize("fusion", ["gated", "concat", "sum"])
def test_tower_forward_and_gradients_match_jax_grad(fusion):
    jcfg, state, model = _twins(fusion)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, NU, 40)
    rows = np.asarray(state.tables["user_id"])[idx]
    feats = rng.normal(0, 1, (40, FU)).astype(np.float32)
    cot = rng.normal(0, 1, (40, D)).astype(np.float32)
    jdense = state.dense["user_tower"]
    tcfg = jcfg.user_tower

    def jax_loss(dense, r, f):
        out = jax_encoders.tower_forward(dense, tcfg, r, f)
        return jnp.sum(out * cot), out

    (_, jout), (g_dense, g_rows, g_feats) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(jdense, jnp.asarray(rows), jnp.asarray(feats))

    tower = model.user_tower
    for p in tower.parameters():
        p.requires_grad_(True)
    r = torch.from_numpy(rows).requires_grad_(True)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = tower.forward_rows(r, f)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)

    layers = list(zip(tower.feature_layers, g_dense["feature_encoder"]["layers"]))
    if fusion == "gated":
        layers += [(tower.gate_fc1, g_dense["gate"]["fc1"]), (tower.gate_fc2, g_dense["gate"]["fc2"])]
    if fusion == "concat":
        layers.append((tower.projection, g_dense["projection"]))
    assert len(layers) == {"gated": 4, "concat": 3, "sum": 1}[fusion]
    for i, (layer, g) in enumerate(layers):
        # the weight's gradient comes out of the tower in float32; the train
        # step rounds it to bf16 (after its sum over the data shards)
        dw = layer.weight.grad.bfloat16().float()
        _assert_bf16_grads_match(dw.numpy().T.copy(), np.asarray(g["w"]), f"w{i}")
        np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(g["b"]), rtol=BF16_REL,
                                   atol=1e-5, err_msg=f"b{i}")
    for got, want in ((r.grad, g_rows), (f.grad, g_feats)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16_REL, atol=1e-5)

    if fusion == "gated":
        want = jax_encoders.tower_gate_values(jdense, tcfg, jnp.asarray(rows), jnp.asarray(feats))
        got = tower_gate_values(tower, torch.from_numpy(rows), torch.from_numpy(feats))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_bf16_dot_rounds_like_jax_dot():
    """The one op alone, on inputs whose f32 sums are exact (multiples of
    2^-6 with few terms): forward and both gradients bit for bit."""
    rng = np.random.default_rng(2)
    x = (rng.integers(-64, 65, (7, 5)) / 64).astype(np.float32) + np.float32(1e-3)
    w = (rng.integers(-64, 65, (5, 3)) / 64).astype(np.float32) - np.float32(1e-3)
    g = rng.normal(0, 1, (7, 3)).astype(np.float32)

    def f(a, b):
        return jax_encoders._dot(a, b, "bfloat16")

    jy, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w.T.copy()).requires_grad_(True)  # nn.Linear's [out, in]
    y = bf16_dot(xt, wt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))
    # the weight's gradient as the train step rounds it
    np.testing.assert_array_equal(wt.grad.bfloat16().float().numpy().T, np.asarray(jdw))


def _step_setup():
    yaml = {
        "user_encoder": dict(_tower("gated", STEP_D), adaptive_mimic={"hidden_dim": 32}),
        "item_encoder": dict(_tower("gated", STEP_D), adaptive_mimic={"hidden_dim": 32}),
        "similarity": "cosine", "adaptive_mimic": {"enabled": True}, "precision": "bfloat16",
    }
    jcfg = jax_parse(yaml, user_feature_dim=FU, item_feature_dim=FI)
    pcfg = port_parse(yaml, user_feature_dim=FU, item_feature_dim=FI)
    rng = np.random.default_rng(0)
    feats = (rng.normal(0, 1, (NU, FU)).astype(np.float32),
             rng.normal(0, 1, (NI, FI)).astype(np.float32))
    cats = np.minimum(rng.geometric(0.3, NI) - 1, 20).astype(np.int32)
    pos = np.full((NU, 6), NI, np.int32)
    for u in range(NU):
        k = rng.integers(1, 6)
        pos[u, :k] = rng.choice(NI, k, replace=False)
    opt = dict(name="adamw", lr=1e-3, weight_decay=0.01)
    common = dict(num_items=NI, negatives_per_positive=NEG, lambda_mimic_user=0.15,
                  lambda_mimic_item=0.15, lambda_category_alignment=0.01, cal_max_categories=C)
    jt = jax_step.TrainStepConfig(**common, use_pallas=True, cal_use_pallas=True,
                                  opt=jax_optim.DenseOptConfig(**opt))
    pt = TrainStepConfig(**common, opt=DenseOptConfig(**opt))
    jstate = jax_state.create_train_state(jax.random.key(1), jcfg, num_users=NU, num_items=NI)
    pstate = create_train_state(pcfg, num_users=NU, num_items=NI, seed=0, device="cpu")
    train_state_from_flat(pstate, jax_ckpt.state_to_host(jstate))
    jdata = jax_state.BatchData(*(jnp.asarray(a) for a in (*feats, pos, cats)))
    pdata = BatchData(*(torch.from_numpy(a) for a in (*feats, pos, cats)))
    return (jcfg, jt, jstate, jdata), (pcfg, pt, pstate, pdata), pos, rng


def test_three_bf16_train_steps_match_jax():
    (jcfg, jt, jstate, jdata), (pcfg, pt, pstate, pdata), pos, rng = _step_setup()
    jstep, pstep = jax_step.make_train_step(jcfg, jt), make_train_step(pcfg, pt)
    for s in range(3):
        key = jax.random.fold_in(jax.random.key(5), s)
        u = rng.integers(0, NU, B).astype(np.int32)
        neg = np.array(jax_sample(jax.random.split(key)[0], jnp.asarray(pos[u]), num_items=NI,
                                  num_negatives=NEG, num_rounds=8))
        jstate, jm = jstep(jstate, jdata, jnp.asarray(u), jnp.asarray(pos[u, 0]), key)
        pstate, pm = pstep(pstate, pdata, torch.from_numpy(u), torch.from_numpy(pos[u, 0]),
                           generator=None, negatives=torch.from_numpy(neg))
        assert set(pm) == set(jm)
        for name in jm:
            np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    want, got = jax_ckpt.state_to_host(jstate), train_state_to_flat(pstate)
    assert set(got) == set(want) and pstate.step == 3
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=STEP_ATOL,
                                   err_msg=key)
    # the weights stay float32, as in the JAX package
    assert all(p.dtype == torch.float32 for _, p in pstate.model.dense_parameters())


def test_bf16_encode_matches_jax():
    """The corpus encode (eval, export) takes the same bf16 tower path."""
    (jcfg, _, jstate, jdata), (_, _, pstate, pdata), _, _ = _step_setup()
    for side, n in (("user", NU), ("item", NI)):
        want = jax_step.encode_corpus(jstate, jdata, jcfg, side, num_rows=n)
        got = port_encode_corpus(pstate.model, side, pdata.user_features if side == "user"
                                 else pdata.item_features)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=side)
