"""Port towers, similarity and corpus encoding against the JAX package, with
JAX-initialised parameters brought across by ttamm_torch.models.convert.

Tolerance: atol 1e-5 (float32 on both sides; the matmuls sum in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.models import TwoTower, from_jax_checkpoint, from_jax_params
from ttamm_torch.models import parse_model_config as port_parse
from ttamm_torch.models import similarity_scores as port_similarity
from ttamm_torch.train import encode_corpus as port_encode_corpus
from ttamm_tpu.models.two_tower import encode_tower, parse_model_config
from ttamm_tpu.models.two_tower import similarity_scores as jax_similarity
from ttamm_tpu.train.checkpoint import save_checkpoint
from ttamm_tpu.train.state import BatchData, create_train_state
from ttamm_tpu.train.step import encode_corpus

NUM_USERS, NUM_ITEMS, FU, FI, DIM = 70, 90, 12, 9, 16


def _tower(fusion, max_norm):
    params = {"embedding_dim": DIM, "sparse": max_norm is None}
    if max_norm is not None:
        params["max_norm"] = max_norm
    tower = {"type": "tower", "id_embedding": {"params": params}, "fusion": fusion}
    if fusion == "sum":
        tower["feature_encoder"] = {"type": "linear", "output_dim": DIM}
    elif fusion == "concat":
        tower["feature_encoder"] = {
            "type": "mlp", "hidden_dims": [32], "output_dim": 8, "activation": "gelu",
        }
        tower["output_dim"] = DIM
    elif fusion == "gated":
        tower["feature_encoder"] = {"type": "mlp", "hidden_dims": [32], "output_dim": DIM}
        tower["adaptive_mimic"] = {"hidden_dim": 24}
    return tower


def _model_yaml(fusion, max_norm, similarity="cosine"):
    return {
        "user_encoder": _tower(fusion, max_norm),
        "item_encoder": _tower(fusion, max_norm),
        "similarity": similarity,
        "adaptive_mimic": {"enabled": True, "init_std": 0.05},
    }


def _setup(fusion, max_norm, similarity="cosine"):
    feat_dims = (0, 0) if fusion == "identity" else (FU, FI)
    yaml = _model_yaml(fusion, max_norm, similarity)
    jcfg = parse_model_config(yaml, user_feature_dim=feat_dims[0], item_feature_dim=feat_dims[1])
    pcfg = port_parse(yaml, user_feature_dim=feat_dims[0], item_feature_dim=feat_dims[1])
    state = create_train_state(jax.random.key(7), jcfg, num_users=NUM_USERS, num_items=NUM_ITEMS)
    tables, dense = jax.device_get((state.tables, state.dense))
    model = from_jax_params(pcfg, tables, dense, device="cpu")
    rng = np.random.default_rng(0)
    feats = {
        "user": rng.normal(0, 1, (NUM_USERS, feat_dims[0])).astype(np.float32),
        "item": rng.normal(0, 1, (NUM_ITEMS, feat_dims[1])).astype(np.float32),
    }
    return jcfg, state, model, feats


MODES = [
    (fusion, max_norm)
    for fusion in ("identity", "sum", "concat", "gated")
    for max_norm in (None, 0.05)
]


@pytest.mark.parametrize("fusion,max_norm", MODES)
def test_encode_tower_matches_jax(fusion, max_norm):
    jcfg, state, model, feats = _setup(fusion, max_norm)
    rng = np.random.default_rng(1)
    for side, n in (("user", NUM_USERS), ("item", NUM_ITEMS)):
        idx = rng.integers(0, n, 33).astype(np.int32)
        f = feats[side][idx] if feats[side].size else None
        for aug in (False, True):
            want = encode_tower(
                state.tables, state.dense, jcfg, side, jnp.asarray(idx),
                None if f is None else jnp.asarray(f), augment_with_mimic=aug,
            )
            got = model.encode_tower(
                side, torch.from_numpy(idx).long(),
                None if f is None else torch.from_numpy(f), augment_with_mimic=aug,
            )
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fusion,max_norm", MODES)
def test_encode_corpus_matches_jax(fusion, max_norm):
    jcfg, state, model, feats = _setup(fusion, max_norm)
    data = BatchData(
        user_features=jnp.asarray(feats["user"]) if feats["user"].size else None,
        item_features=jnp.asarray(feats["item"]) if feats["item"].size else None,
        positive_rows=jnp.zeros((1, 1), jnp.int32),
        category_ids=None,
    )
    for side, n in (("user", NUM_USERS), ("item", NUM_ITEMS)):
        want = encode_corpus(state, data, jcfg, side, num_rows=n, chunk_size=32)
        got = port_encode_corpus(
            model, side, torch.from_numpy(feats[side]), chunk_size=32
        )
        assert got.shape == (n, DIM)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
def test_similarity_and_forward_match_jax(similarity):
    from ttamm_tpu.models.two_tower import model_forward

    jcfg, state, model, feats = _setup("gated", None, similarity)
    rng = np.random.default_rng(2)
    u = rng.normal(0, 1, (11, DIM)).astype(np.float32)
    v = rng.normal(0, 1, (11, DIM)).astype(np.float32)
    want = jax_similarity(jcfg, jnp.asarray(u), jnp.asarray(v))
    got = port_similarity(model.cfg, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

    ui = rng.integers(0, NUM_USERS, 9).astype(np.int32)
    ii = rng.integers(0, NUM_ITEMS, 9).astype(np.int32)
    want = model_forward(
        state.tables, state.dense, jcfg,
        {"indices": jnp.asarray(ui), "features": jnp.asarray(feats["user"][ui])},
        {"indices": jnp.asarray(ii), "features": jnp.asarray(feats["item"][ii])},
        return_embeddings=True,
    )
    got = model(
        {"indices": torch.from_numpy(ui).long(), "features": torch.from_numpy(feats["user"][ui])},
        {"indices": torch.from_numpy(ii).long(), "features": torch.from_numpy(feats["item"][ii])},
        return_embeddings=True,
    )
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0)


def test_checkpoint_conversion_matches_params(tmp_path):
    jcfg, state, model, feats = _setup("gated", None)
    path = save_checkpoint(
        tmp_path, state, experiment_name="port", epoch=1, metric_name=None,
        metric_value=None,
    )
    from_ckpt = from_jax_checkpoint(path, model.cfg, device="cpu")
    # one table layout on both sides: sparse tables keep their scratch row
    assert (from_ckpt.num_users, from_ckpt.num_items) == (NUM_USERS, NUM_ITEMS)
    assert from_ckpt.user_tower.id_embedding.weight.shape == (NUM_USERS + 1, DIM)
    np.testing.assert_array_equal(
        from_ckpt.user_tower.id_embedding.weight.numpy(), np.asarray(state.tables["user_id"])
    )
    for a, b in zip(model.state_dict().values(), from_ckpt.state_dict().values()):
        assert torch.equal(a, b)


def test_seeded_init_follows_jax_distributions():
    pcfg = port_parse(_model_yaml("gated", None), user_feature_dim=FU, item_feature_dim=FI)
    a = TwoTower(pcfg, num_users=4000, num_items=3000, seed=5, device="cpu")
    b = TwoTower(pcfg, num_users=4000, num_items=3000, seed=5, device="cpu")
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    table = a.user_tower.id_embedding.weight
    assert table.shape == (4001, DIM) and not table[4000].any()  # zero scratch row
    assert abs(float(table[:4000].std()) - 0.02) < 1e-3  # normal(0, init std 0.02)
    assert abs(float(a.mimic.item_aug.weight.std()) - 0.05) < 2e-3
    fc1 = a.user_tower.gate_fc1  # xavier-uniform weight, ±1/sqrt(fan_in) bias
    assert float(fc1.weight.abs().max()) <= (6.0 / (2 * DIM + 24)) ** 0.5
    assert float(fc1.bias.abs().max()) <= 1.0 / (2 * DIM) ** 0.5


def test_bfloat16_precision_encode_matches_jax():
    """``model.precision: bfloat16`` was refused here until it was ported
    (tests/test_torch_port_precision.py holds it to JAX in full). Now a bf16
    model builds with float32 weights, and its encode matches the JAX
    package's bf16 encode (atol 1e-5: bf16 operands, f32 sums in another
    order)."""
    yaml = dict(_model_yaml("gated", None), precision="bfloat16")
    pcfg = port_parse(yaml, user_feature_dim=FU, item_feature_dim=FI)
    assert all(p.dtype == torch.float32 for p in
               TwoTower(pcfg, num_users=5, num_items=5, seed=0, device="cpu").parameters())
    jcfg = parse_model_config(yaml, user_feature_dim=FU, item_feature_dim=FI)
    state = create_train_state(jax.random.key(7), jcfg, num_users=NUM_USERS, num_items=NUM_ITEMS)
    tables, dense = jax.device_get((state.tables, state.dense))
    model = from_jax_params(pcfg, tables, dense, device="cpu")
    rng = np.random.default_rng(2)
    idx = rng.integers(0, NUM_USERS, 33).astype(np.int32)
    f = rng.normal(0, 1, (33, FU)).astype(np.float32)
    want = encode_tower(state.tables, state.dense, jcfg, "user", jnp.asarray(idx), jnp.asarray(f),
                        augment_with_mimic=True)
    got = model.encode_tower("user", torch.from_numpy(idx).long(), torch.from_numpy(f),
                             augment_with_mimic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fn", ["gate_values", "apply_gate"])
def test_gate_matches_jax(fn):
    from ttamm_tpu.models import encoders as jax_encoders

    jcfg, state, model, _ = _setup("gated", None)
    rng = np.random.default_rng(3)
    id_repr = rng.normal(0, 0.1, (13, DIM)).astype(np.float32)
    feat_repr = rng.normal(0, 1, (13, DIM)).astype(np.float32)
    for side in ("user", "item"):
        want = getattr(jax_encoders, fn)(
            state.dense[f"{side}_tower"], jnp.asarray(id_repr), jnp.asarray(feat_repr)
        )
        got = getattr(model.tower(side), fn)(torch.from_numpy(id_repr), torch.from_numpy(feat_repr))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("loader", ["model", "params", "checkpoint"])
def test_models_default_to_the_card(loader, tmp_path, monkeypatch):
    """``device=None`` means the CUDA card: without one, building or loading
    a model raises instead of landing on the CPU."""
    jcfg, state, model, _ = _setup("gated", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables, dense = jax.device_get((state.tables, state.dense))
    build = {
        "model": lambda: TwoTower(model.cfg, num_users=NUM_USERS, num_items=NUM_ITEMS, seed=1),
        "params": lambda: from_jax_params(model.cfg, tables, dense),
        "checkpoint": lambda: from_jax_checkpoint(
            save_checkpoint(tmp_path, state, experiment_name="port", epoch=1,
                            metric_name=None, metric_value=None),
            model.cfg,
        ),
    }[loader]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
