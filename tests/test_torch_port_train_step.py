"""The port's training step, eval-loss step, state conversion and
checkpoints against the JAX package, on the CPU.

Both sides start from one state: the JAX ``create_train_state`` output moved
into a port state by ``ttamm_torch.models.convert``. The JAX step draws its
negatives from ``jax.random.split(rng)[0]``; the test draws the same ones
outside and injects them into the port's step. Dropout is 0 and the JAX
step runs its Pallas kernels in interpret mode (``use_pallas=True``,
``cal_use_pallas=True``; D = 128 and C = 16 meet the second-moment kernel's
gate).

Tolerance: losses rtol 1e-5; every leaf of the state (tables, dense
parameters, both optimizers' moments) atol 2e-5 after three steps. Both
sides compute in float32 and round the category-moment operands to bf16;
the sums run in another order, and Adam's step lr * m / (sqrt(v) + eps)
turns gradient differences into parameter differences of at most ~1e-5
(lr = 1e-3).
"""

from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_ranks import free_port
from ttamm_torch.models import parse_model_config as port_parse
from ttamm_torch.models.convert import train_state_from_flat, train_state_to_flat
from ttamm_torch.parallel import MeshConfig, build_mesh, gather_state_flat, place_data, place_state
from ttamm_torch.pipelines.training import run_single_experiment
from ttamm_torch.train import (
    BatchData,
    TrainStepConfig,
    create_train_state,
    make_eval_loss_step,
    make_train_step,
)
from ttamm_torch.train import checkpoint as port_ckpt
from ttamm_torch.train.optim import DenseOptConfig
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.ops.sampling import sample_negative_items as jax_sample
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import optim as jax_optim
from ttamm_tpu.train import state as jax_state
from ttamm_tpu.train import step as jax_step

NU, NI, FU, FI, D, B, NEG, C = 300, 200, 12, 9, 128, 16, 5, 16
STEP_ATOL = 2e-5


def _tower(sparse=True):
    return {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": D, "sparse": sparse}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": D, "dropout": 0.0},
        "fusion": "gated",
        "adaptive_mimic": {"hidden_dim": 32},
    }


VARIANTS = {
    # configs/default.yaml's structure at small widths
    "default": dict(item_sparse=True, clip=None, sparse_wd=0.0),
    # a dense (AdamW) item ID table, the global-norm clip and decoupled
    # weight decay on the sparse user table's touched rows
    "dense_item_table_clip": dict(item_sparse=False, clip=0.5, sparse_wd=0.01),
}


def _setup(variant):
    v = VARIANTS[variant]
    model_yaml = {
        "user_encoder": _tower(), "item_encoder": _tower(v["item_sparse"]),
        "similarity": "cosine", "adaptive_mimic": {"enabled": True},
    }
    jcfg = jax_parse(model_yaml, user_feature_dim=FU, item_feature_dim=FI)
    pcfg = port_parse(model_yaml, user_feature_dim=FU, item_feature_dim=FI)
    rng = np.random.default_rng(0)
    feats = (
        rng.normal(0, 1, (NU, FU)).astype(np.float32),
        rng.normal(0, 1, (NI, FI)).astype(np.float32),
    )
    cats = np.minimum(rng.geometric(0.3, NI) - 1, 20).astype(np.int32)  # some >= C
    pos = np.full((NU, 6), NI, np.int32)
    for u in range(NU):
        k = rng.integers(1, 6)
        pos[u, :k] = rng.choice(NI, k, replace=False)
    opt = dict(name="adamw", lr=1e-3, weight_decay=0.01)
    common = dict(
        num_items=NI, negatives_per_positive=NEG, lambda_mimic_user=0.15,
        lambda_mimic_item=0.15, lambda_category_alignment=0.01, cal_max_categories=C,
        gradient_clip_norm=v["clip"], sparse_weight_decay=v["sparse_wd"],
    )
    jt = jax_step.TrainStepConfig(
        **common, use_pallas=True, cal_use_pallas=True, opt=jax_optim.DenseOptConfig(**opt)
    )
    pt = TrainStepConfig(**common, opt=DenseOptConfig(**opt))
    jstate = jax_state.create_train_state(jax.random.key(1), jcfg, num_users=NU, num_items=NI)
    pstate = create_train_state(pcfg, num_users=NU, num_items=NI, seed=0, device="cpu")
    train_state_from_flat(pstate, jax_ckpt.state_to_host(jstate))
    jdata = jax_state.BatchData(
        jnp.asarray(feats[0]), jnp.asarray(feats[1]), jnp.asarray(pos), jnp.asarray(cats)
    )
    pdata = BatchData(
        torch.from_numpy(feats[0]), torch.from_numpy(feats[1]), torch.from_numpy(pos),
        torch.from_numpy(cats),
    )
    return (jcfg, jt, jstate, jdata), (pcfg, pt, pstate, pdata), pos, rng


def _batch(rng, pos, key):
    u = rng.integers(0, NU, B).astype(np.int32)
    rng_neg, _ = jax.random.split(key)  # what the JAX step draws with
    neg = jax_sample(rng_neg, jnp.asarray(pos[u]), num_items=NI, num_negatives=NEG, num_rounds=8)
    return u, pos[u, 0], np.array(neg)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_jax_for_three_steps(variant):
    (jcfg, jt, jstate, jdata), (pcfg, pt, pstate, pdata), pos, rng = _setup(variant)
    jstep, pstep = jax_step.make_train_step(jcfg, jt), make_train_step(pcfg, pt)
    for s in range(3):
        key = jax.random.fold_in(jax.random.key(5), s)
        u, p, neg = _batch(rng, pos, key)
        jstate, jm = jstep(jstate, jdata, jnp.asarray(u), jnp.asarray(p), key)
        pstate, pm = pstep(
            pstate, pdata, torch.from_numpy(u), torch.from_numpy(p),
            generator=None, negatives=torch.from_numpy(neg),
        )
        assert set(pm) == set(jm)
        for name in jm:
            np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=1e-5, atol=1e-7)
    want = jax_ckpt.state_to_host(jstate)
    got = train_state_to_flat(pstate)
    assert set(got) == set(want)  # the same leaves, under the same keys
    assert pstate.step == 3 and int(want["step"]) == 3
    for key in want:
        np.testing.assert_allclose(
            got[key], np.asarray(want[key]), rtol=0, atol=STEP_ATOL, err_msg=key
        )


def test_eval_loss_step_matches_jax():
    (jcfg, jt, jstate, jdata), (pcfg, pt, pstate, pdata), pos, rng = _setup("default")
    key = jax.random.key(9)
    u = rng.integers(0, NU, B).astype(np.int32)
    neg = jax_sample(key, jnp.asarray(pos[u]), num_items=NI, num_negatives=NEG, num_rounds=8)
    want = jax_step.make_eval_loss_step(jcfg, jt)(
        jstate, jdata, jnp.asarray(u), jnp.asarray(pos[u, 0]), key
    )
    got = make_eval_loss_step(pcfg, pt)(
        pstate, pdata, torch.from_numpy(u), torch.from_numpy(pos[u, 0]),
        generator=None, negatives=torch.from_numpy(np.array(neg)),
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_port_checkpoint_read_by_jax_and_back(tmp_path):
    (jcfg, _, jstate, _), (pcfg, pt, pstate, pdata), pos, rng = _setup("default")
    u, p, neg = _batch(rng, pos, jax.random.key(2))
    make_train_step(pcfg, pt)(
        pstate, pdata, torch.from_numpy(u), torch.from_numpy(p),
        generator=None, negatives=torch.from_numpy(neg),
    )
    path = port_ckpt.save_checkpoint(
        tmp_path, pstate, experiment_name="port", epoch=4, metric_name="recall@10",
        metric_value=0.5, template="{experiment}_{metric}_epoch{epoch}.pt",
    )
    assert path.name == "port_recallat10_epoch4.pt"
    restored, meta = jax_ckpt.load_checkpoint(path, jstate)
    assert meta["epoch"] == 4 and int(restored.step) == 1
    flat = train_state_to_flat(pstate)
    for key, value in jax_ckpt.state_to_host(restored).items():
        np.testing.assert_array_equal(np.asarray(value), flat[key], err_msg=key)
    # and the port reads it back into a fresh state, bit for bit
    fresh = create_train_state(pcfg, num_users=NU, num_items=NI, seed=3, device="cpu")
    fresh, meta = port_ckpt.load_checkpoint(path, fresh)
    assert meta["metric_value"] == 0.5 and fresh.step == 1
    for key, value in train_state_to_flat(fresh).items():
        np.testing.assert_array_equal(value, flat[key], err_msg=key)


def test_jax_checkpoint_read_by_port(tmp_path):
    (jcfg, jt, jstate, jdata), (pcfg, _, _, _), pos, rng = _setup("default")
    u = rng.integers(0, NU, B).astype(np.int32)
    jstate, _ = jax_step.make_train_step(jcfg, jt)(
        jstate, jdata, jnp.asarray(u), jnp.asarray(pos[u, 0]), jax.random.key(3)
    )
    path = jax_ckpt.save_checkpoint(
        tmp_path, jstate, experiment_name="jax", epoch=2, metric_name=None, metric_value=None,
    )
    state = create_train_state(pcfg, num_users=NU, num_items=NI, seed=0, device="cpu")
    state, meta = port_ckpt.load_checkpoint(path, state)
    assert meta["epoch"] == 2 and state.step == 1 and state.opt_sparse["item_id"].step == 1
    flat = train_state_to_flat(state)
    for key, value in jax_ckpt.state_to_host(jstate).items():
        np.testing.assert_array_equal(flat[key], np.asarray(value), err_msg=key)
    # the scratch row is kept in the training layout
    assert state.tables["user_id"].shape == (NU + 1, D)
    assert state.model.user_tower.num_embeddings == NU


def test_options_are_ported_and_tensor_parallel_on_one_rank_is_the_plain_step():
    model_yaml = {
        "user_encoder": _tower(), "item_encoder": _tower(),
        "adaptive_mimic": {"enabled": True, "sparse": True},
    }
    pcfg = port_parse(model_yaml, user_feature_dim=FU, item_feature_dim=FI)
    assert pcfg.mimic_sparse
    # sparse mimic tables and the in-batch softmax are ported
    # (tests/test_torch_port_sparse_mimic.py, tests/test_torch_port_in_batch.py)
    state = create_train_state(pcfg, num_users=NU, num_items=NI, seed=0, device="cpu")
    assert state.tables["user_aug"].shape == (NU + 1, D)
    make_train_step(pcfg, TrainStepConfig(num_items=NI, loss_type="in_batch_softmax"))
    with pytest.raises(ValueError, match="Unsupported training.loss"):
        make_train_step(pcfg, TrainStepConfig(num_items=NI, loss_type="softmax"))
    # the wire options (tests/test_torch_port_comm_bf16.py,
    # tests/test_torch_port_exchange.py), packed moments
    # (tests/test_torch_port_packed_moments.py) and model.precision: bfloat16
    # (tests/test_torch_port_precision.py) are ported, and so is tensor
    # parallelism (tests/test_torch_port_tensor_parallel.py)
    packed = create_train_state(pcfg, num_users=NU, num_items=NI, seed=0, device="cpu",
                                packed_moments=True)
    assert packed.packed_moments and packed.opt_sparse["user_id"].m.shape == (NU + 1, D)
    bf16 = port_parse(dict(model_yaml, precision="bfloat16"), user_feature_dim=FU,
                      item_feature_dim=FI)
    create_train_state(bf16, num_users=NU, num_items=NI, seed=0, device="cpu")
    # the JAX package builds no mesh at one device, so the flag changes
    # nothing there; on a one-rank mesh (1x1) a tensor-parallel placement
    # steps as the non-TP placement, bit for bit, with one step for both
    # (each all-reduce over model has one rank), the clip on
    _, (pcfg, pt, pstate, pdata), pos, rng = _setup("dense_item_table_clip")
    flat = train_state_to_flat(pstate)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = build_mesh(MeshConfig(1, 1), "cpu")
        step, data = make_train_step(pcfg, pt, mesh=mesh), place_data(mesh, pdata)
        states = {tp: place_state(mesh, train_state_from_flat(create_train_state(
            pcfg, num_users=NU, num_items=NI, seed=0, device="cpu"), flat), tensor_parallel=tp)
            for tp in (True, False)}
        assert states[True].tensor_parallel and not states[False].tensor_parallel
        for s in range(2):
            u, p, neg = _batch(rng, pos, jax.random.fold_in(jax.random.key(5), s))
            losses = {tp: {k: float(v) for k, v in step(
                state, data, torch.from_numpy(u), torch.from_numpy(p), generator=None,
                negatives=torch.from_numpy(neg))[1].items()} for tp, state in states.items()}
            assert losses[True] == losses[False]
        want = gather_state_flat(states[False], mesh)
        for key, value in gather_state_flat(states[True], mesh).items():
            np.testing.assert_array_equal(value, want[key], err_msg=key)
    finally:
        dist.destroy_process_group()
    # the mesh itself is ported: it needs its processes (torchrun)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        run_single_experiment({"mesh": {"data_parallel": 2}}, device="cpu")
