"""One small training setup built twice, in the JAX package and in the port,
for the parity tests of the in-batch softmax and the sparse mimic tables
(tests/test_torch_port_in_batch.py, tests/test_torch_port_sparse_mimic.py).

Both sides start from one state: the JAX ``create_train_state`` output moved
into a port state by ``ttamm_torch.models.convert``. Dropout is 0 and the
JAX step runs its Pallas kernels in interpret mode (``use_pallas=True``,
``cal_use_pallas=True``; D = 128 and C = 16 meet the second-moment kernel's
gate). The JAX step draws its pool of mixed negatives from
``jax.random.split(key)[0]`` (the eval step from ``key``); :func:`jax_pool`
draws the same ids for the port's step to take as ``negatives``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ttamm_torch.models import parse_model_config as port_parse
from ttamm_torch.models.convert import train_state_from_flat, train_state_to_flat
from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
from ttamm_torch.train.optim import DenseOptConfig
from ttamm_tpu.models.two_tower import parse_model_config as jax_parse
from ttamm_tpu.train import checkpoint as jax_ckpt
from ttamm_tpu.train import optim as jax_optim
from ttamm_tpu.train import state as jax_state
from ttamm_tpu.train import step as jax_step

NU, NI, FU, FI, D, C = 300, 200, 12, 9, 128, 16
# every state leaf after three steps (as tests/test_torch_port_train_step.py)
STEP_ATOL = 2e-5


class Side(NamedTuple):
    cfg: Any
    tscfg: Any
    state: Any
    data: Any


def tower(sparse: bool = True) -> dict:
    return {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": D, "sparse": sparse}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": D, "dropout": 0.0},
        "fusion": "gated",
    }


def model_yaml(mimic_sparse: bool = True) -> dict:
    return {
        "user_encoder": tower(), "item_encoder": tower(), "similarity": "cosine",
        "adaptive_mimic": {"enabled": True, "sparse": mimic_sparse},
    }


def setup(*, mimic_sparse=True, clip=None, mixed=0, logq=True, temperature=1.0, sparse_wd=0.0):
    """``(jax Side, port Side, positives [NU, 6] padded with NI, rng)`` of an
    in-batch softmax config (``configs/in_batch_softmax.yaml``'s structure
    at small widths), one state on both sides."""
    jcfg = jax_parse(model_yaml(mimic_sparse), user_feature_dim=FU, item_feature_dim=FI)
    pcfg = port_parse(model_yaml(mimic_sparse), user_feature_dim=FU, item_feature_dim=FI)
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
    # log train frequency as the trainer builds it: skewed counts, some
    # items unseen (floored at one occurrence)
    counts = np.maximum(np.floor(rng.pareto(1.2, NI) * 3), 1.0)
    counts[rng.choice(NI, 20, replace=False)] = 1.0
    log_q = np.log(counts / counts.sum()).astype(np.float32)
    opt = dict(name="adamw", lr=1e-3, weight_decay=0.01)
    common = dict(
        num_items=NI, loss_type="in_batch_softmax", lambda_mimic_user=0.15,
        lambda_mimic_item=0.15, lambda_category_alignment=0.01, cal_max_categories=C,
        gradient_clip_norm=clip, sparse_weight_decay=sparse_wd, mixed_negatives=mixed,
        logq_correction=logq, softmax_temperature=temperature,
    )
    jt = jax_step.TrainStepConfig(
        **common, use_pallas=True, cal_use_pallas=True, opt=jax_optim.DenseOptConfig(**opt)
    )
    pt = TrainStepConfig(**common, opt=DenseOptConfig(**opt))
    jstate = jax_state.create_train_state(jax.random.key(1), jcfg, num_users=NU, num_items=NI)
    pstate = create_train_state(pcfg, num_users=NU, num_items=NI, seed=0, device="cpu")
    train_state_from_flat(pstate, jax_ckpt.state_to_host(jstate))
    jdata = jax_state.BatchData(
        jnp.asarray(feats[0]), jnp.asarray(feats[1]), jnp.asarray(pos), jnp.asarray(cats),
        jnp.asarray(log_q),
    )
    pdata = BatchData(
        torch.from_numpy(feats[0]), torch.from_numpy(feats[1]), torch.from_numpy(pos),
        torch.from_numpy(cats), torch.from_numpy(log_q),
    )
    return Side(jcfg, jt, jstate, jdata), Side(pcfg, pt, pstate, pdata), pos, rng


def jax_pool(key, m: int) -> np.ndarray:
    """The ``m`` uniform ids JAX draws from ``key`` (the train step passes
    ``jax.random.split(key)[0]``)."""
    if m == 0:
        return np.zeros(0, np.int32)
    return np.array(jax.random.randint(key, (m,), 0, NI, dtype=jnp.int32))


def batch(rng, pos, b: int, duplicate: bool = True):
    """``b`` random users and their first positives, one positive repeated
    (an accidental hit inside the batch)."""
    u = rng.integers(0, NU, b).astype(np.int32)
    p = pos[u, 0].copy()
    if duplicate:
        p[b // 2] = p[1]
    return u, p


def run_steps(jx, pt, pos, rng, steps: int = 3, b: int = 16):
    """``steps`` train steps on both sides with the same batches and pool
    draws; the JAX and the port losses of each step, and both final
    states as flat host arrays."""
    jstep, pstep = jax_step.make_train_step(jx.cfg, jx.tscfg), make_train_step(pt.cfg, pt.tscfg)
    jstate, pstate, losses = jx.state, pt.state, []
    for s in range(steps):
        key = jax.random.fold_in(jax.random.key(5), s)
        u, p = batch(rng, pos, b)
        pool = jax_pool(jax.random.split(key)[0], pt.tscfg.mixed_negatives)
        jstate, jm = jstep(jstate, jx.data, jnp.asarray(u), jnp.asarray(p), key)
        pstate, pm = pstep(
            pstate, pt.data, torch.from_numpy(u), torch.from_numpy(p), generator=None,
            negatives=torch.from_numpy(pool),
        )
        assert set(pm) == set(jm)
        losses.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in pm.items()}))
    assert pstate.step == steps
    return losses, jax_ckpt.state_to_host(jstate), train_state_to_flat(pstate)


def assert_steps_match(losses, want, got):
    for jm, pm in losses:
        for name in jm:
            np.testing.assert_allclose(pm[name], jm[name], rtol=1e-5, atol=1e-7, err_msg=name)
    assert set(got) == set(want)  # the same leaves, under the same keys
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=STEP_ATOL,
                                   err_msg=key)
