"""``training.steps_per_call``: the port's multi-step train and eval-loss
calls on the CPU, and the per-step optimizer scalars they read.

- ``_pick_steps_per_call`` (``auto``) equals the JAX trainer's rule.
- ``make_multi_train_step`` at K = 3 equals the same three single steps
  bit for bit (every state leaf, every loss, the generator's state after),
  with dropout on and a cosine schedule, at ``configs/default.yaml``'s and
  ``configs/in_batch_softmax.yaml``'s structure at test widths;
  ``make_multi_eval_loss_step`` equals its single steps.
- The trainer with ``steps_per_call`` 1, 4 and ``auto`` writes the same
  checkpoints, bit for bit (the meta but its timestamp).
- The scalar table: each row holds the step's dense scalars and each
  sparse table's Adam scalars, formed in double and rounded once, as the
  by-value forms form them; ``sparse_adam_rows_plain`` on such a row equals
  its by-value form bit for bit.
- The native search library, once loaded, leaves the process's float mode
  as it was (subnormals survive).

On the CPU the multi-step calls are the loop of single steps; on a card
they replay a captured CUDA graph of the step, which
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` phase 4e hold to the
eager steps.
"""

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_port_async_checkpoint import assert_same_flat
from test_torch_port_trainer import _config
from ttamm_torch.data import write_synthetic_csvs
from ttamm_torch.models import parse_model_config
from ttamm_torch.models.convert import train_state_to_flat
from ttamm_torch.ops import kernels
from ttamm_torch.pipelines.training import _pick_steps_per_call, run_single_experiment
from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
from ttamm_torch.train import optim
from ttamm_torch.train.step import (
    make_eval_loss_step,
    make_multi_eval_loss_step,
    make_multi_train_step,
    step_scalars,
)
from ttamm_tpu.pipelines.training import _pick_steps_per_call as jax_pick_steps_per_call

REPO = Path(__file__).resolve().parents[1]
NU, NI, FU, FI, B, K = 60, 50, 7, 6, 16, 3


@pytest.mark.parametrize("cap", [8192, 128, 7])
def test_pick_steps_per_call_is_the_jax_rule(cap):
    for n in range(0, 2001):
        assert _pick_steps_per_call(n, cap) == jax_pick_steps_per_call(n, cap), n


def _setup(config_name: str):
    """A seeded state, its data and step config at ``config_name``'s
    structure (dropout, sparse tables, loss, loss weights) with test widths
    and a cosine schedule over 5 steps."""
    cfg_yaml = yaml.safe_load((REPO / "configs" / config_name).read_text())
    model = copy.deepcopy(cfg_yaml["model"])
    for side in ("user_encoder", "item_encoder"):
        enc = model[side]
        enc["id_embedding"]["params"]["embedding_dim"] = 16
        enc["feature_encoder"].update(hidden_dims=[24], output_dim=16)
        enc["output_dim"] = 16
    cfg = parse_model_config(model, user_feature_dim=FU, item_feature_dim=FI)
    training = dict(cfg_yaml["training"], lr_schedule={"type": "cosine", "final_factor": 0.1})
    weights = training["loss_weights"]
    tscfg = TrainStepConfig(
        num_items=NI, negatives_per_positive=int(training["negatives_per_positive"]),
        loss_type=training["loss"], lambda_mimic_user=weights["mimic_user"],
        lambda_mimic_item=weights["mimic_item"],
        lambda_category_alignment=weights["category_alignment"], cal_max_categories=8,
        opt=optim.parse_dense_opt_config(training, total_steps=5),
    )
    rng = np.random.default_rng(4)
    pos = np.full((NU, 4), NI, np.int32)
    for u in range(NU):
        k = rng.integers(1, 4)
        pos[u, :k] = rng.choice(NI, k, replace=False)
    counts = np.maximum(np.floor(rng.pareto(1.2, NI) * 3), 1.0)
    data = BatchData(
        torch.from_numpy(rng.normal(0, 1, (NU, FU)).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 1, (NI, FI)).astype(np.float32)),
        torch.from_numpy(pos),
        torch.from_numpy(rng.integers(0, 10, NI).astype(np.int32)),
        torch.from_numpy(np.log(counts / counts.sum()).astype(np.float32)),
    )
    state = create_train_state(cfg, num_users=NU, num_items=NI, seed=2, device="cpu")
    users = torch.from_numpy(rng.integers(0, NU, (K, B)).astype(np.int32))
    items = data.positive_rows[users.long(), 0].contiguous()
    return cfg, tscfg, state, data, users, items


@pytest.mark.parametrize("config_name", ["default.yaml", "in_batch_softmax.yaml"])
def test_multi_train_step_equals_single_steps_bit_for_bit(config_name):
    cfg, tscfg, state, data, users, items = _setup(config_name)
    assert cfg.user_tower.feature_encoder.dropout > 0  # dropout on: the generator draws masks
    eager, replayed = copy.deepcopy(state), copy.deepcopy(state)
    gen_eager = torch.Generator().manual_seed(9)
    gen_multi = torch.Generator().manual_seed(9)
    single = make_train_step(cfg, tscfg)
    losses = []
    for k in range(K):
        _, metrics = single(eager, data, users[k], items[k], generator=gen_eager)
        losses.append(metrics["loss"])
    _, got = make_multi_train_step(cfg, tscfg)(replayed, data, users, items, generator=gen_multi)
    assert got.shape == (K,) and torch.equal(got, torch.stack(losses))
    assert replayed.step == eager.step == K
    assert replayed.opt_dense.step == eager.opt_dense.step == K
    assert all(replayed.opt_sparse[n].step == s.step == K for n, s in eager.opt_sparse.items())
    want, have = train_state_to_flat(eager), train_state_to_flat(replayed)
    assert list(have) == list(want)
    for key in want:
        assert np.asarray(have[key]).tobytes() == np.asarray(want[key]).tobytes(), key
    assert torch.equal(gen_multi.get_state(), gen_eager.get_state())


@pytest.mark.parametrize("config_name", ["default.yaml", "in_batch_softmax.yaml"])
def test_multi_eval_loss_step_equals_single_steps(config_name):
    cfg, tscfg, state, data, users, items = _setup(config_name)
    gen_eager, gen_multi = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    single = make_eval_loss_step(cfg, tscfg)
    want = torch.stack([single(state, data, users[k], items[k], generator=gen_eager)
                        for k in range(K)])
    got = make_multi_eval_loss_step(cfg, tscfg)(state, data, users, items, generator=gen_multi)
    assert torch.equal(got, want)
    assert torch.equal(gen_multi.get_state(), gen_eager.get_state())


def test_trainer_checkpoints_are_the_same_for_each_steps_per_call(tmp_path):
    write_synthetic_csvs(tmp_path / "data", num_users=300, num_items=200, num_interactions=4000,
                         seed=3)
    results = {}
    for spc in (1, 4, "auto"):
        config = _config(tmp_path / str(spc))
        config["data"]["root"] = str(tmp_path / "data")
        config["training"].update(steps_per_call=spc, lr_schedule="cosine")
        config["training"]["checkpointing"].update(save_best_only=False)
        results[spc] = run_single_experiment(config, device="cpu")
    want = results[1]
    files = sorted(p.name for p in want.checkpoint_path.parent.iterdir())
    assert len(files) >= 3
    steps_per_epoch = want.steps // len(want.train_loss)
    assert steps_per_epoch > 4  # chunks of 4 and a shorter one, and the remainder batch
    for spc in (4, "auto"):
        got = results[spc]
        assert got.steps == want.steps and got.train_loss == want.train_loss
        for split in ("val_loss", "test_loss"):  # NaN where a split is empty
            assert np.array_equal(getattr(got, split), getattr(want, split), equal_nan=True)
        assert sorted(p.name for p in got.checkpoint_path.parent.iterdir()) == files
        for name in files:
            assert_same_flat(got.checkpoint_path.parent / name, want.checkpoint_path.parent / name)


def test_scalar_table_rows_are_the_by_value_scalars():
    cfg, tscfg, state, *_ = _setup("in_batch_softmax.yaml")
    tscfg = tscfg._replace(sparse_weight_decay=0.01)
    state.step, state.opt_dense.step = 7, 7
    for i, opt_state in enumerate(state.opt_sparse.values()):
        opt_state.step = 7 + i  # each table at its own count
    table = step_scalars(state, tscfg, 4)
    names = list(state.opt_sparse)
    assert table.dtype == np.float32
    assert table.shape == (4, optim.DENSE_SCALARS + kernels.ADAM_SCALARS * len(names))
    opt = tscfg.opt
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    for k in range(4):
        t = 8 + k
        lr = opt.lr * optim.lr_scale(opt, t)
        assert table[k, 0] == f32(1.0 - lr * opt.weight_decay)
        assert table[k, 1] == f32(-lr / (1.0 - opt.b1**t))
        assert table[k, 2] == f32(1.0 - opt.b2**t)
        for i, name in enumerate(names):
            st = state.opt_sparse[name].step + 1 + k
            lo = optim.DENSE_SCALARS + i * kernels.ADAM_SCALARS
            # the by-value kernel's scalars: each Python scalar cast to f32
            # once, the bias corrections' reciprocals formed in double
            by_value = [f32(x) for x in (
                opt.b1, 1.0 - opt.b1, opt.b2, 1.0 - opt.b2, 1.0 / (1.0 - opt.b1**st),
                1.0 / (1.0 - opt.b2**st), 1e-8, lr, lr * 0.01,
            )]
            assert table[k, lo : lo + kernels.ADAM_SCALARS].tolist() == by_value
            assert np.array_equal(
                table[k, lo : lo + kernels.ADAM_SCALARS],
                kernels.adam_scalars(step=st, lr=lr, b1=opt.b1, b2=opt.b2, eps=1e-8,
                                     weight_decay=0.01),
            )


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("step", [1, 1000])
def test_sparse_adam_rows_plain_on_a_scalar_row_equals_the_by_value_form(step, weight_decay):
    rng = np.random.default_rng(step)
    table = torch.from_numpy(rng.standard_normal((41, 32)).astype(np.float32))
    m = torch.from_numpy(np.abs(rng.standard_normal(table.shape)).astype(np.float32)) * 0.1
    v = torch.from_numpy(np.abs(rng.standard_normal(table.shape)).astype(np.float32)) * 0.01
    idx = torch.from_numpy(np.where(rng.random(24) < 0.2, -1, rng.permutation(40)[:24]).astype(np.int32))
    grads = torch.from_numpy(rng.standard_normal((24, 32)).astype(np.float32))
    hyper = dict(step=step, lr=3e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)
    before = table.clone()
    by_value = [t.clone() for t in (table, m, v)]
    kernels.sparse_adam_rows_plain(*by_value, idx, grads, **hyper)
    row = torch.from_numpy(kernels.adam_scalars(**hyper))
    kernels.sparse_adam_rows_plain(table, m, v, idx, grads, scalars=row, decay=bool(weight_decay))
    for got, want in zip((table, m, v), by_value):
        assert torch.equal(got, want)
    assert not torch.equal(table, before)


def test_native_library_keeps_subnormals(tmp_path):
    """Loading the port's host search library leaves flush-to-zero and
    denormals-are-zero off: it is linked without crtfastmath.o."""
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from ttamm_torch.serve import native_bridge\n"
        "assert np.float32(1e-38) * np.float32(0.1) != 0\n"
        "ctypes.CDLL(str(native_bridge.build_native_library(Path(sys.argv[1]))))\n"
        "print(repr(float(np.float32(1e-38) * np.float32(0.1))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.strip()) != 0.0
