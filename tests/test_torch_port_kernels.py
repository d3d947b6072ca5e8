"""The port's kernel functions (ttamm_torch/ops/kernels.py) against the JAX
Pallas kernels they replace, run in interpret mode on the CPU.

On the CPU each wrapper takes its plain PyTorch version, so these tests pin
the plain versions' semantics to the TPU kernels'; the CUDA kernels are held
against the plain versions on the card (tests/test_torch_port_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttamm_torch.ops import kernels
from ttamm_tpu.ops.pallas.fused_mips import groupmax_matmul, rescore_groups
from ttamm_tpu.ops.pallas.topk import small_k_topk


def _topk_rows(case: str) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(0)
    if case == "random":
        return rng.standard_normal((33, 257)).astype(np.float32), 7
    if case == "k1":
        return rng.standard_normal((8, 130)).astype(np.float32), 1
    if case == "k128":
        return rng.standard_normal((8, 130)).astype(np.float32), 128
    x = np.full((6, 300), -np.inf, np.float32)
    x[0, :] = 1.5  # all tied
    x[1, 5] = 2.0  # fewer than k finite values
    x[2, 10:20] = np.arange(10, dtype=np.float32)
    x[3, ::3] = np.finfo(np.float32).min  # the masked-score sentinels
    x[4, ::5] = -3.0e38
    x[4, 7] = 0.25
    # row 5 stays all -inf
    return x, 12


@pytest.mark.parametrize("case", ["random", "k1", "k128", "ties_and_sentinels"])
def test_small_k_topk_plain_bit_identical_to_jax(case):
    x, k = _topk_rows(case)
    want_v, want_i = small_k_topk(jnp.asarray(x), k, interpret=True)
    got_v, got_i = kernels.small_k_topk(torch.from_numpy(x), k)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(
        got_v.numpy().view(np.int32), np.asarray(want_v).view(np.int32)
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _bf16_values(rng, shape):
    """bf16-representable values, so every product is exact in f32."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_items", [4096, 3000])
def test_groupmax_matmul_plain_matches_jax(dtype, num_items):
    rng = np.random.default_rng(1)
    b, npad, d = 128, 4096, 32  # the TPU kernel's tiling: B % 128, Np % 2048
    q = _bf16_values(rng, (b, d))
    items = _bf16_values(rng, (npad, d))
    if num_items < npad:
        items[num_items:] = 0.0  # zero pad rows, as the callers pad
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = groupmax_matmul(
        jnp.asarray(q).astype(jdt), jnp.asarray(items).astype(jdt),
        num_items=num_items, interpret=True,
    )
    tdt = getattr(torch, dtype)
    got = kernels.groupmax_matmul(
        torch.from_numpy(q).to(tdt), torch.from_numpy(items).to(tdt), num_items
    )
    assert got.shape == (b, npad // 128)
    # Exact products; only the order of the f32 sums differs.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    # pad-only groups report the TPU kernel's -3e38 sentinel exactly
    full = num_items // 128 + (num_items % 128 > 0)
    assert np.all(got.numpy()[:, full:] == np.float32(-3.0e38))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rescore_groups_plain_matches_jax(dtype):
    rng = np.random.default_rng(2)
    b, ng, d, kg = 8, 6, 32, 3  # one 8-query grid step of the TPU kernel
    q = _bf16_values(rng, (b, d))
    items = _bf16_values(rng, (ng, 128, d))
    gids = np.stack([rng.permutation(ng)[:kg] for _ in range(b)]).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = rescore_groups(
        jnp.asarray(q).astype(jdt), jnp.asarray(items).astype(jdt),
        jnp.asarray(gids), interpret=True,
    )
    tdt = getattr(torch, dtype)
    got = kernels.rescore_groups(
        torch.from_numpy(q).to(tdt), torch.from_numpy(items).to(tdt),
        torch.from_numpy(gids),
    )
    assert got.shape == (b, kg * 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_plain_versions_do_not_count_launches():
    kernels.reset_launch_counts()
    x = torch.randn(4, 300)
    kernels.small_k_topk(x, 3)
    kernels.select_topk_from_groups(
        torch.randn(4, 384), torch.zeros(4, 2, dtype=torch.int32), k=3, num_items=300
    )
    kernels.groupmax_matmul(torch.randn(4, 16), torch.randn(300, 16), 300)
    kernels.rescore_groups(
        torch.randn(4, 16), torch.randn(3, 128, 16), torch.zeros(4, 2, dtype=torch.int32)
    )
    x = torch.randn(40, 8)
    ids = torch.randint(0, 3, (40,), dtype=torch.int32)
    kernels.gather_rows(x, ids)
    kernels.scatter_set_rows(x, ids[:4], torch.randn(4, 8))
    kernels.gather_rows(x, ids - 1, masked=True)
    kernels.scatter_set_rows(x, ids[:4] - 1, torch.randn(4, 8), masked=True)
    kernels.sparse_adam_rows(
        x, torch.zeros_like(x), torch.zeros_like(x), torch.tensor([2, -1, 0], dtype=torch.int32),
        torch.randn(3, 8), step=1, lr=0.01, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
    )
    kernels.segment_second_moments(ids, x, 3)
    kernels.segment_second_moments_bwd(ids, x, torch.randn(3, 8, 8))
    assert kernels.category_grouping(ids, 3) is None
    kernels.dense_adam(
        [x], [torch.randn(40, 8)], [torch.zeros_like(x)], [torch.zeros_like(x)],
        scalars=torch.tensor([0.99, -0.01, 0.001]), b1=0.9, b2=0.999, eps=1e-8,
        weight_decay=0.01, decoupled=True,
    )
    counts = kernels.launch_counts()
    assert set(counts) == {
        "small_k_topk", "select_topk_from_groups", "groupmax_matmul", "rescore_groups",
        "gather_rows", "gather_rows_masked", "scatter_set_rows", "scatter_set_rows_masked",
        "sparse_adam_rows", "dense_adam", "segment_second_moments", "segment_second_moments_bwd",
        "category_grouping",
    }
    assert all(n == 0 for n in counts.values())


@pytest.mark.parametrize(
    "call",
    [
        lambda: kernels.small_k_topk_cuda(torch.randn(4, 300), 3),
        lambda: kernels.select_topk_from_groups_cuda(
            torch.randn(4, 384), torch.zeros(4, 2, dtype=torch.int32), k=3, num_items=300
        ),
        lambda: kernels.groupmax_matmul_cuda(torch.randn(4, 16), torch.randn(300, 16), 300),
        lambda: kernels.rescore_groups_cuda(
            torch.randn(4, 16), torch.randn(3, 128, 16),
            torch.zeros(4, 2, dtype=torch.int32),
        ),
        lambda: kernels.gather_rows_cuda(torch.randn(5, 8), torch.zeros(2, dtype=torch.int32)),
        lambda: kernels.scatter_set_rows_cuda(
            torch.randn(5, 8), torch.zeros(2, dtype=torch.int32), torch.randn(2, 8)
        ),
        lambda: kernels.segment_second_moments_cuda(
            torch.zeros(4, dtype=torch.int32), torch.randn(4, 8), 2
        ),
        lambda: kernels.segment_second_moments_bwd_cuda(
            torch.zeros(4, dtype=torch.int32), torch.randn(4, 8), torch.randn(2, 8, 8)
        ),
    ],
    ids=[
        "small_k_topk", "select_topk_from_groups", "groupmax_matmul", "rescore_groups", "gather_rows",
        "scatter_set_rows", "segment_second_moments", "segment_second_moments_bwd",
    ],
)
def test_cuda_entry_points_refuse_cpu_tensors(call):
    """No hidden fallback: the CUDA path never runs the plain version."""
    with pytest.raises(ValueError, match="CUDA kernel given a tensor on cpu"):
        call()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_library(tmp_path)


def test_argument_checks():
    with pytest.raises(ValueError, match="k=0"):
        kernels.small_k_topk(torch.randn(2, 8), 0)
    with pytest.raises(ValueError, match="float32"):
        kernels.small_k_topk(torch.randn(2, 8, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="num_items"):
        kernels.groupmax_matmul(torch.randn(2, 8), torch.randn(10, 8), 11)
    with pytest.raises(ValueError, match="int32"):
        kernels.rescore_groups(
            torch.randn(2, 8), torch.randn(1, 128, 8), torch.zeros(2, 1, dtype=torch.int64)
        )


def test_resolving_cuda_without_a_card_raises(monkeypatch):
    """The card is the default: without one, ``None`` raises as ``cuda``
    does, and only an explicit ``cpu`` runs on the CPU."""
    from ttamm_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
