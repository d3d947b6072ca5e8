"""The fused sparse-row Adam update (``kernels.sparse_adam_rows``) and the
sparse ID tables' reads through ``gather_rows``, on the CPU.

On the CPU the wrapper runs its plain version: the masked plain gathers,
``adam_rows`` and the masked plain scatters. ``sparse_adam_update`` masks
the non-head lanes of each duplicate run (idx = -1) instead of sending them
to the table's scratch row, so that row is never touched.

Tolerances: against the JAX ``sparse_adam_update`` on its row-kernel path
(``use_pallas=True``, the Pallas kernels interpreted) rtol 1e-5, atol 1e-6
after three steps, as in ``test_torch_port_train_ops.py`` (float32 on both
sides; the bias corrections are computed in another precision). Against the
port's own unfused composition, and between the step's table reads and
``index_select``: bit for bit (the same operations on the same values).

The JAX comparison also holds table, m and v after each step, both sides
against a float64 numpy oracle of the same update (coalesce, then Adam with
the bias corrections and lr of the step), at the same tolerance, so that a
mismatch names the step, the array, its first rows and each side's distance
from the oracle. Each case's three steps run once per process, on first
use, and record both sides' arrays after every step before anything is
asserted; ``test_sadam_vs_oracle`` then holds one side at one step to the
oracle, so a failure's id alone (``[port-s2-duplicates-0.0-constant]``)
names the side and the step. Each side gets its own copies of the table
and of each step's ids and gradients; each JAX step is waited for before
the port's runs, and after each step the ids and gradients both sides were
given must still equal saved copies (neither side writes its inputs). Under
JAX 0.9, ``interpret=True`` runs a Pallas kernel through the HLO
interpreter (``pallas_call_hlo_interpret``): the kernel's state effects
discharged and its grid walked by a sequential loop inside one XLA
computation, its DMAs plain copies, so no thread or timing enters the JAX
side. The port's side rounds its square root to nearest on the CPU
(``sparse_adam.sqrt_rn``), which PyTorch's CPU ``torch.sqrt`` does not
always do (``test_adam_rows_rounds_every_operation_to_nearest``).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.ops import kernels
from ttamm_torch.ops.sparse_adam import (
    adam_rows,
    coalesce_row_grads,
    init_sparse_adam,
    sparse_adam_update,
    unfused_row_update,
)
from ttamm_torch.train import optim
from ttamm_tpu.ops import sparse_adam as jax_sparse

ROWS, D, N = 40, 128, 64  # table rows before the scratch row


def _lanes(layout, rng):
    """Update lanes (int32 ids) of one step."""
    if layout == "duplicates":  # a third of the lanes on one row, the rest random
        idx = rng.integers(0, ROWS, N).astype(np.int32)
        idx[: N // 3] = idx[0]
        return idx
    if layout == "one_row":
        return np.full(N, 7, np.int32)
    return np.array([rng.integers(0, ROWS)], np.int32)  # "one_lane": N = 1


def _table(rng):
    """A table whose last row is the zero scratch row, as the models build it."""
    table = rng.standard_normal((ROWS + 1, D)).astype(np.float32)
    table[-1] = 0.0
    return table


TOL = dict(rtol=1e-5, atol=1e-6)


def _oracle_step(table, m, v, idx, g, *, lr, step, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
    """One sparse Adam step in float64 numpy, in place: the lanes of each row
    summed, then Adam on the touched rows at ``step``'s bias corrections,
    decoupled decay on the touched rows."""
    rows = np.unique(idx)
    summed = np.zeros((table.shape[0], g.shape[1]))
    np.add.at(summed, idx, g.astype(np.float64))
    gr = summed[rows]
    m[rows] = b1 * m[rows] + (1.0 - b1) * gr
    v[rows] = b2 * v[rows] + (1.0 - b2) * gr * gr
    m_hat, v_hat = m[rows] / (1.0 - b1**step), v[rows] / (1.0 - b2**step)
    delta = lr * m_hat / (np.sqrt(v_hat) + eps)
    table[rows] -= delta + lr * weight_decay * table[rows]


def _check_sides(step, name, port, jax_side, oracle):
    """``port`` and ``jax_side`` equal within TOL, and each within TOL of the
    float64 ``oracle``; the message names the step, the array, the first
    rows off and each side's distance from the oracle."""
    off = {"port-jax": ~np.isclose(port, jax_side, **TOL),
           "port-oracle": ~np.isclose(port, oracle, **TOL),
           "jax-oracle": ~np.isclose(jax_side, oracle, **TOL)}
    if not any(o.any() for o in off.values()):
        return
    rows = np.unique(np.nonzero(np.logical_or.reduce(list(off.values())))[0])[:6]
    per_row = {int(r): (float(np.abs(port[r] - oracle[r]).max()),
                        float(np.abs(jax_side[r] - oracle[r]).max())) for r in rows}
    raise AssertionError(
        f"step {step}, {name}: elements off {({k: int(o.sum()) for k, o in off.items()})}; "
        f"first rows {rows.tolist()}; max |port - oracle|, |jax - oracle| by row {per_row}; "
        f"whole array: port - oracle {np.abs(port - oracle).max():.4e}, "
        f"jax - oracle {np.abs(jax_side - oracle).max():.4e}, "
        f"port - jax {np.abs(port - jax_side).max():.4e}")


_RUNS = {}  # (layout, weight_decay, schedule) -> _Run, filled on first use in this process


class _Run(NamedTuple):
    """One case's three steps as they ran: per step, each side's and the
    oracle's (table, m, v) and whether each side's ids and gradients came
    back unchanged; the step each side counted; the lanes of each
    ``sparse_adam_rows`` call."""

    arrays: list  # per step: {"jax": (table, m, v), "port": ..., "oracle": ...}
    inputs_kept: list  # per step: {"jax": bool, "port": bool}
    steps: tuple  # (port, jax)
    lanes: list


def _run_case(layout, weight_decay, schedule):
    """The case's three steps, computed once per process on first use, so
    every assertion on them reads one record."""
    key = (layout, weight_decay, schedule)
    if key not in _RUNS:
        _RUNS[key] = _three_steps(layout, weight_decay, schedule)
    return _RUNS[key]


def _three_steps(layout, weight_decay, schedule):
    """For each step: the JAX update, waited for, then the port's on its own
    copies of the table, ids and gradients, the input checks and the
    float64 oracle's step; each side's table, m and v copied after each
    step, before anything is asserted."""
    lanes = []
    fused = kernels.sparse_adam_rows

    def spy(table, m, v, idx, grads, **hyper):
        lanes.append(idx)
        fused(table, m, v, idx, grads, **hyper)

    rng = np.random.default_rng(11)
    table = _table(rng)
    j_table = jnp.array(table.copy())
    j_state = jax_sparse.init_sparse_adam(j_table)
    t_table = torch.from_numpy(table.copy())
    t_state = init_sparse_adam(t_table)
    oracle = [table.astype(np.float64), np.zeros(table.shape), np.zeros(table.shape)]
    cfg = optim.DenseOptConfig(
        lr=0.01, lr_schedule=schedule, lr_total_steps=3, lr_final_factor=0.1
    )
    arrays, inputs_kept = [], []
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(kernels, "sparse_adam_rows", spy)
        for step in range(1, 4):
            idx = _lanes(layout, rng)
            g = rng.standard_normal((idx.shape[0], D)).astype(np.float32)
            saved = (idx.copy(), g.copy())
            j_inputs, t_inputs = (idx.copy(), g.copy()), (idx.copy(), g.copy())
            lr = cfg.lr * optim.lr_scale(cfg, step)
            j_table, j_state = jax_sparse.sparse_adam_update(
                j_table, j_state, jnp.array(j_inputs[0]), jnp.array(j_inputs[1]), lr=lr,
                weight_decay=weight_decay, use_pallas=True,
            )
            jax.block_until_ready((j_table, j_state))
            sparse_adam_update(
                t_table, t_state, torch.from_numpy(t_inputs[0]), torch.from_numpy(t_inputs[1]),
                lr=lr, weight_decay=weight_decay,
            )
            inputs_kept.append({
                side: np.array_equal(i, saved[0]) and np.array_equal(x, saved[1])
                for side, (i, x) in (("jax", j_inputs), ("port", t_inputs))
            })
            _oracle_step(*oracle, saved[0], saved[1], lr=lr, step=step, weight_decay=weight_decay)
            arrays.append({
                "jax": tuple(np.array(a) for a in (j_table, j_state.m, j_state.v)),
                "port": tuple(t.numpy().copy() for t in (t_table, t_state.m, t_state.v)),
                "oracle": tuple(a.copy() for a in oracle),
            })
    return _Run(arrays, inputs_kept, (t_state.step, int(j_state.step)), lanes)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("layout", ["duplicates", "one_row", "one_lane"])
def test_sparse_adam_update_matches_jax(layout, weight_decay, schedule):
    """Three steps against the JAX update on its row-kernel path (N = 1 takes
    the JAX package's sorted path: no DMA block divides one lane), every row
    compared after each step, both sides against the float64 oracle too,
    the scratch row exactly zero in table, m and v. Each step is one
    ``sparse_adam_rows`` call whose lanes hold each touched row once and -1
    on every other lane."""
    run = _run_case(layout, weight_decay, schedule)
    for step, (kept, arrays) in enumerate(zip(run.inputs_kept, run.arrays), 1):
        for side in ("jax", "port"):
            assert kept[side], f"step {step}: the {side} side wrote its inputs"
        for name, got, want, ref in zip(("table", "m", "v"), arrays["port"], arrays["jax"],
                                        arrays["oracle"]):
            _check_sides(step, name, got, want, ref)
    port_step, jax_step = run.steps
    assert port_step == jax_step == 3
    for got, want in zip(run.arrays[-1]["port"], run.arrays[-1]["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert not got[-1].any()  # the scratch row: +0.0 everywhere
    assert len(run.lanes) == 3
    for idx in run.lanes:
        live = idx[idx >= 0]
        assert live.numel() == torch.unique(live).numel() and not (idx < -1).any()
        assert int(live.max()) < ROWS


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("layout", ["duplicates", "one_row", "one_lane"])
@pytest.mark.parametrize("step", [1, 2, 3], ids=lambda s: f"s{s}")
@pytest.mark.parametrize("side", ["jax", "port"])
def test_sadam_vs_oracle(side, step, layout, weight_decay, schedule):
    """One side's table, m and v after one step of a case, against the
    float64 oracle at TOL (the test above holds the same distances): the id
    names the side that left the oracle and the step, as in
    ``[port-s2-duplicates-0.0-constant]``."""
    arrays = _run_case(layout, weight_decay, schedule).arrays[step - 1]
    for name, got, ref in zip(("table", "m", "v"), arrays[side], arrays["oracle"]):
        off = ~np.isclose(got, ref, **TOL)
        assert int(off.sum()) == 0, (
            f"{side}, step {step}, {name}: {int(off.sum())} elements off the oracle, rows "
            f"{np.unique(np.nonzero(off)[0]).tolist()}, max |{side} - oracle| "
            f"{np.abs(got - ref).max():.4e}")


def _old_composition(table, m, v, idx, grads, **hyper):
    """The update before the fusion: duplicate lanes on the scratch row,
    unmasked plain gathers and scatters."""
    target, g = coalesce_row_grads(idx, grads, scratch_row=table.shape[0] - 1)
    unfused_row_update(table, m, v, target, g, gather=kernels.gather_rows_plain,
                       scatter=kernels.scatter_set_rows_plain, **hyper)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("step", [1, 1000])
@pytest.mark.parametrize("layout", ["duplicates", "one_row", "one_lane"])
def test_plain_version_equals_the_old_composition(layout, step, weight_decay):
    """The coalesce with masked non-head lanes and ``sparse_adam_rows_plain``
    give the scratch-row composition's bits over every row, the scratch row
    included (a zero gradient on a zero row keeps it zero)."""
    rng = np.random.default_rng(step)
    table = torch.from_numpy(_table(rng))
    m = torch.from_numpy(np.abs(rng.standard_normal(table.shape)).astype(np.float32)) * 0.1
    v = torch.from_numpy(np.abs(rng.standard_normal(table.shape)).astype(np.float32)) * 0.01
    m[-1], v[-1] = 0.0, 0.0
    idx = torch.from_numpy(_lanes(layout, rng))
    grads = torch.from_numpy(rng.standard_normal((idx.shape[0], D)).astype(np.float32))
    hyper = dict(step=step, lr=0.01, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)
    old = [t.clone() for t in (table, m, v)]
    _old_composition(*old, idx, grads, **hyper)
    target, g = coalesce_row_grads(idx, grads, scratch_row=-1)
    kernels.sparse_adam_rows_plain(table, m, v, target, g, **hyper)
    for got, want in zip((table, m, v), old):
        assert torch.equal(got, want)
    assert not table[-1].any() and not m[-1].any() and not v[-1].any()


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("step", [1, 2, 1000])
def test_adam_rows_rounds_every_operation_to_nearest(step, weight_decay):
    """On the CPU, ``adam_rows`` gives the bits of its arithmetic with every
    f32 operation rounded to nearest, the square root too (``sqrt_rn``, the
    kernel's ``__fsqrt_rn``), as numpy's float32 operations round."""
    rng = np.random.default_rng(step)
    w = rng.standard_normal((N, D)).astype(np.float32)
    m = (0.1 * rng.standard_normal((N, D))).astype(np.float32)
    v = (0.01 * rng.random((N, D))).astype(np.float32)
    g = rng.standard_normal((N, D)).astype(np.float32)
    hyper = dict(step=step, lr=0.01, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)
    got = adam_rows(*(torch.from_numpy(a.copy()) for a in (w, m, v, g)), **hyper)
    b1, one_b1, b2, one_b2, inv_bc1, inv_bc2, eps, lr, lr_wd = kernels.adam_scalars(**hyper)
    m_new = b1 * m + one_b1 * g
    v_new = b2 * v + one_b2 * np.square(g)
    delta = lr * (m_new * inv_bc1) / (np.sqrt(v_new * inv_bc2) + eps)
    if weight_decay:
        delta = delta + lr_wd * w
    for name, a, want in zip(("w", "m", "v"), got, (w - delta, m_new, v_new)):
        np.testing.assert_array_equal(a.numpy(), want, err_msg=name)


def test_masked_lanes_touch_nothing():
    """Lanes with idx < 0 read and write nothing; the update masks every
    non-head lane of a duplicate run."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(_table(rng))
    m, v = torch.zeros_like(table), torch.zeros_like(table)
    before = table.clone()
    idx = torch.tensor([5, -1, 9, -1, -1], dtype=torch.int32)
    kernels.sparse_adam_rows(
        table, m, v, idx, torch.ones((5, D)), step=1, lr=0.1, b1=0.9, b2=0.999, eps=1e-8,
        weight_decay=0.0,
    )
    changed = (table != before).any(dim=1).nonzero().flatten().tolist()
    assert changed == [5, 9]
    assert (m.any(dim=1).nonzero().flatten().tolist()) == [5, 9]
    target, _ = coalesce_row_grads(torch.tensor([4, 2, 4, 4, 2]), torch.ones((5, 3)), scratch_row=-1)
    assert target.tolist() == [2, -1, 4, -1, -1]


def test_cpu_update_launches_nothing():
    rng = np.random.default_rng(5)
    table = torch.from_numpy(_table(rng))
    state = init_sparse_adam(table)
    kernels.reset_launch_counts()
    sparse_adam_update(
        table, state, torch.from_numpy(_lanes("duplicates", rng)), torch.randn(N, D), lr=0.01
    )
    assert state.step == 1
    counts = kernels.launch_counts()
    assert "sparse_adam_rows" in counts and all(n == 0 for n in counts.values())


def _args(d=8, rows=6, n=4):
    table = torch.randn(rows, d)
    return [table, torch.zeros_like(table), torch.zeros_like(table),
            torch.arange(n, dtype=torch.int32), torch.randn(n, d)]


HYPER = dict(step=1, lr=0.01, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)


@pytest.mark.parametrize(
    "case,match",
    [
        ("m_is_table", "distinct"),
        ("v_is_m", "distinct"),
        ("v_overlaps_table", "distinct"),
        ("idx_int64", "idx must be 1-D int32"),
        ("grads_shape", "grads"),
        ("m_shape", "m "),
    ],
)
def test_argument_checks(case, match):
    """The plain version and the kernel's wrapper refuse aliased or
    overlapping w / m / v, int64 ids and mismatched shapes."""
    args = _args()
    if case == "m_is_table":
        args[1] = args[0]
    elif case == "v_is_m":
        args[2] = args[1]
    elif case == "v_overlaps_table":
        buf = torch.zeros(7, 8)
        args[0], args[2] = buf[:6], buf[1:]
    elif case == "idx_int64":
        args[3] = args[3].long()
    elif case == "grads_shape":
        args[4] = torch.randn(3, 8)
    else:
        args[1] = torch.zeros(5, 8)
    for fn in (kernels.sparse_adam_rows_plain, kernels.sparse_adam_rows_cuda):
        with pytest.raises(ValueError, match=match):
            fn(*args, **HYPER)


def test_kernel_wrapper_refuses_rows_not_a_multiple_of_4_and_cpu_tensors():
    with pytest.raises(ValueError, match="D % 4 == 0"):
        kernels.sparse_adam_rows_cuda(*_args(d=6), **HYPER)
    with pytest.raises(ValueError, match="CUDA kernel given a tensor on cpu"):
        kernels.sparse_adam_rows_cuda(*_args(), **HYPER)
    # the plain version takes any D
    args = _args(d=6)
    kernels.sparse_adam_rows_plain(*args, **HYPER)
    assert args[1][:4].any()


def _small_step(tmp_gen_seed=0):
    """A gated-tower model (D = 8, two sparse ID tables, mimic on, C = 4)
    with its batch: (cfg, tscfg, state, data, u, p, negatives)."""
    from ttamm_torch.models import parse_model_config
    from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state
    from ttamm_torch.train.optim import DenseOptConfig

    tower = {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [16], "output_dim": 8, "dropout": 0.0},
        "fusion": "gated",
        "adaptive_mimic": {"hidden_dim": 8},
    }
    cfg = parse_model_config(
        {"user_encoder": tower, "item_encoder": tower, "adaptive_mimic": {"enabled": True}},
        user_feature_dim=5, item_feature_dim=3,
    )
    rng = np.random.default_rng(tmp_gen_seed)
    nu, ni, b = 30, 20, 8
    data = BatchData(
        user_features=torch.from_numpy(rng.standard_normal((nu, 5)).astype(np.float32)),
        item_features=torch.from_numpy(rng.standard_normal((ni, 3)).astype(np.float32)),
        positive_rows=torch.from_numpy(rng.integers(0, ni, (nu, 3)).astype(np.int32)),
        category_ids=torch.from_numpy(rng.integers(0, 4, ni).astype(np.int32)),
    )
    tscfg = TrainStepConfig(
        num_items=ni, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
        lambda_category_alignment=0.01, cal_max_categories=4,
        opt=DenseOptConfig(name="adamw", lr=1e-2, weight_decay=0.01),
    )
    state = create_train_state(cfg, num_users=nu, num_items=ni, seed=1, device="cpu")
    u = torch.from_numpy(rng.integers(0, nu, b).astype(np.int32))
    p = torch.from_numpy(rng.integers(0, ni, b).astype(np.int32))
    neg = torch.from_numpy(rng.integers(0, ni, (b, 5)).astype(np.int32))
    return cfg, tscfg, state, data, u, p, neg


def test_sparse_table_reads_go_through_gather_rows(monkeypatch):
    """The one-device train step reads each sparse ID table once through
    ``kernels.gather_rows`` and updates it with one ``sparse_adam_rows``
    call; the eval-loss step reads them the same way. Replacing the reads by
    ``index_select`` changes no bit of the state or the losses."""
    from ttamm_torch.train import make_eval_loss_step, make_train_step

    calls = {"gather_rows": [], "sparse_adam_rows": []}
    real = {n: getattr(kernels, n) for n in calls}

    def spy(name):
        def fn(table, *args, **kw):
            calls[name].append(table)
            return real[name](table, *args, **kw)
        return fn

    def run(reads):
        cfg, tscfg, state, data, u, p, neg = _small_step()
        monkeypatch.setattr(kernels, "gather_rows", reads)
        monkeypatch.setattr(kernels, "sparse_adam_rows", spy("sparse_adam_rows"))
        state, metrics = make_train_step(cfg, tscfg)(state, data, u, p, generator=None, negatives=neg)
        loss = make_eval_loss_step(cfg, tscfg)(state, data, u, p, generator=None, negatives=neg)
        return state, metrics, loss

    got = run(spy("gather_rows"))
    tables = got[0].tables
    sparse = [tables["user_id"], tables["item_id"]]
    assert [t is s for t, s in zip(calls["gather_rows"], sparse + sparse)] == [True] * 4
    assert len(calls["gather_rows"]) == 4  # two a step, train and eval
    assert [t is s for t, s in zip(calls["sparse_adam_rows"], sparse)] == [True, True]
    assert len(calls["sparse_adam_rows"]) == 2
    want = run(lambda table, idx, masked=False: torch.index_select(table, 0, idx))
    for name in tables:
        assert torch.equal(got[0].tables[name], want[0].tables[name]), name
    for (key, a), (_, b) in zip(got[0].dense_targets(), want[0].dense_targets()):
        assert torch.equal(a.detach(), b.detach()), key
    for name in got[1]:
        assert torch.equal(got[1][name], want[1][name]), name
    assert torch.equal(got[2], want[2])
