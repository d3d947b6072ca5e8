"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where there is no
Hopper card. Run on a machine with one (``--noconftest``: tests/conftest.py
imports jax, which the port does not need):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances: small_k_topk is bit-identical; groupmax_matmul and
rescore_groups multiply bf16-rounded operands exactly and differ from the
plain f32 matmul only in the order of the f32 sums (rtol 1e-6, atol 1e-5
at O(1) scores).
"""

import pytest
import torch

from ttamm_torch.ops import kernels
from ttamm_torch.ops.topk import mips_topk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _rows(width, seed, device):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((64, width), generator=gen)
    x[0] = 1.5  # all tied
    x[1] = float("-inf")
    x[1, 3] = 2.0  # one finite value
    x[2, ::3] = torch.finfo(torch.float32).min
    x[3, ::5] = -3.0e38
    x[4] = torch.round(x[4] * 2) / 2  # many ties
    return x.to(device)


@pytest.mark.parametrize("width,k", [(782, 20), (2560, 20), (15625, 24), (60000, 7), (130, 128), (300, 1)])
def test_small_k_topk_kernel_bit_identical(cuda, width, k):
    x = _rows(width, width, cuda)
    kv, ki = kernels.small_k_topk_cuda(x, k)
    pv, pi = kernels.small_k_topk_plain(x, k)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupmax_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(1)
    q = torch.nn.functional.normalize(torch.randn((200, 40), generator=gen), dim=1)
    items = torch.nn.functional.normalize(torch.randn((3000, 40), generator=gen), dim=1)
    q, items = q.to(cuda, dtype), items.to(cuda, dtype)
    got = kernels.groupmax_matmul_cuda(q, items, 2900)
    want = kernels.groupmax_matmul_plain(q, items, 2900)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rescore_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(2)
    q = torch.nn.functional.normalize(torch.randn((50, 72), generator=gen), dim=1)
    items = torch.randn((30, 128, 72), generator=gen) / 8
    gids = torch.stack([torch.randperm(30, generator=gen)[:9] for _ in range(50)])
    q, items = q.to(cuda, dtype), items.to(cuda, dtype)
    gids = gids.to(cuda, torch.int32)
    got = kernels.rescore_groups_cuda(q, items, gids)
    want = kernels.rescore_groups_plain(q, items, gids)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize(
    "algorithm,score_dtype",
    [("group_exact", "float32"), ("group_exact", "bfloat16"), ("fused", "bfloat16")],
)
def test_mips_topk_on_the_card_counts_launches(cuda, algorithm, score_dtype):
    gen = torch.Generator().manual_seed(3)
    q = torch.nn.functional.normalize(torch.randn((33, 64), generator=gen), dim=1)
    items = torch.nn.functional.normalize(torch.randn((5000, 64), generator=gen), dim=1)
    kernels.reset_launch_counts()
    gs, gi = mips_topk(q.to(cuda), items.to(cuda), k=20, algorithm=algorithm, score_dtype=score_dtype)
    counts = kernels.launch_counts()
    assert counts["small_k_topk"] == 2
    assert counts["groupmax_matmul"] == counts["rescore_groups"] == int(algorithm == "fused")
    ws, wi = mips_topk(q, items, k=20, algorithm=algorithm, score_dtype=score_dtype)
    # A bf16 slab rounds each f32 sum to bf16: another summation order on
    # the card may land one bf16 step (2^-8 at |s| < 1) away.
    tol = 4e-3 if (algorithm, score_dtype) == ("group_exact", "bfloat16") else 1e-5
    torch.testing.assert_close(gs.cpu(), ws, rtol=0, atol=tol)
    # ids may differ only where the scores tie within the tolerance
    differ = gi.cpu() != wi
    assert torch.all((gs.cpu() - ws).abs()[differ] <= tol)
