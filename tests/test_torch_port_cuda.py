"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where there is no
Hopper card. Run on a machine with one (``--noconftest``: tests/conftest.py
imports jax, which the port does not need):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances: small_k_topk, select_topk_from_groups, gather_rows,
scatter_set_rows, sparse_adam_rows and dense_adam are bit-identical (the
last two's arithmetic is the eager or _foreach_ composition's, each op
rounded as PyTorch rounds it); groupmax_matmul and rescore_groups multiply bf16-rounded
operands exactly and differ from the plain f32 matmul only in the order of
the f32 sums (rtol 1e-6, atol 1e-5 at O(1) scores); segment_second_moments
forward and backward likewise, summing up to N products: 2e-5 of the
largest entry of each category (forward) or of dx (backward); the forward
sums in f64 and is also the f64 einsum rounded to f32, bit for bit.
"""

import pytest
import torch

from ttamm_torch.ops import kernels
from ttamm_torch.ops.losses import SegmentSecondMoments
from ttamm_torch.ops.sparse_adam import init_sparse_adam, sparse_adam_update
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


def _select_case(b, num_items, kg, seed, device):
    """A slab with a ragged tail, finfo.min blocked columns and rows rounded
    to quarters (ties); each row's group ids distinct, the tail group among
    them in every other row."""
    gen = torch.Generator().manual_seed(seed)
    ng = -(-num_items // 128)
    s = torch.randn((b, ng * 128), generator=gen)
    s[::3] = torch.round(s[::3] * 4) / 4
    blocked = torch.randint(0, num_items, (b, 32), generator=gen)
    s.scatter_(1, blocked, torch.finfo(torch.float32).min)
    s[:, num_items:] = 0.0
    gi = torch.stack([torch.randperm(ng, generator=gen)[:kg] for _ in range(b)])
    force = (torch.arange(b) % 2 == 0) & ~(gi == ng - 1).any(dim=1)
    gi[force, -1] = ng - 1
    return s.to(device), gi.to(device, torch.int32)


@pytest.mark.parametrize(
    "b,num_items,k,kg",
    [(2685, 99880, 21, 21), (64, 1000, 20, 20), (5, 129, 5, 2), (33, 4096, 32, 32), (17, 777, 1, 7)],
)
def test_select_topk_kernel_bit_identical(cuda, b, num_items, k, kg):
    s, gi = _select_case(b, num_items, kg, b + kg, cuda)
    kv, ki = kernels.select_topk_from_groups_cuda(s, gi, k=k, num_items=num_items)
    pv, pi = kernels.select_topk_from_groups_plain(s, gi, k=k, num_items=num_items)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(ki, pi)


def _select_edge_case(layout, device):
    """(slab, group ids, k, num_items) of the select kernel's other paths:
    rows tied at the top (all equal, all finfo.min: T = L and the ordered
    selection), one group, 32 groups at k = 32, k = 600 beyond the 512
    ranked candidates (radix select, then the bitonic sort in the output
    row), and group ids outside [0, NG) (scored finfo.min, ids wrapped as
    the plain version's int64 -> int32 cast)."""
    num_items, kg, k = 5000, 21, 21
    if layout == "kg1":
        kg, k = 1, 20
    elif layout == "kg1_k128":
        kg, k = 1, 128
    elif layout == "kg32_k32":
        kg, k = 32, 32
    elif layout == "k600":
        kg, k = 8, 600
    elif layout == "kg32_k600":
        kg, k = 32, 600
    s, gi = _select_case(64, num_items, kg, kg + k, device)
    if layout == "all_equal":
        s[:, :num_items] = 1.5
    elif layout == "all_min":
        s[:, :num_items] = torch.finfo(torch.float32).min
    elif layout == "gids_out_of_range":
        ng = s.shape[1] // 128
        gi[::2, 3] = -1
        gi[1::4, 5] = ng
        gi[3::4, 5] = ng + 7
        gi[5::8, 7] = 2**30  # its ids wrap past 2^31
    return s, gi, k, num_items


@pytest.mark.parametrize(
    "layout",
    ["all_equal", "all_min", "kg1", "kg1_k128", "kg32_k32", "k600", "kg32_k600", "gids_out_of_range"],
)
def test_select_topk_kernel_edges_bit_identical(cuda, layout):
    s, gi, k, num_items = _select_edge_case(layout, cuda)
    kv, ki = kernels.select_topk_from_groups_cuda(s, gi, k=k, num_items=num_items)
    pv, pi = kernels.select_topk_from_groups_plain(s, gi, k=k, num_items=num_items)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(ki, pi)


def test_select_topk_kernel_domain(cuda):
    s = torch.zeros((4, 40 * 128), device=cuda)
    gi = torch.arange(33, dtype=torch.int32, device=cuda).repeat(4, 1)
    two = gi[:, :2].contiguous()
    with pytest.raises(ValueError, match="33 groups"):
        kernels.select_topk_from_groups_cuda(s, gi, k=3, num_items=5000)
    with pytest.raises(ValueError, match="groups of 128"):
        kernels.select_topk_from_groups_cuda(s, two, k=3, num_items=5000, group=64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.select_topk_from_groups_cuda(
            s.view(-1)[1 : 1 + 4 * 39 * 128].view(4, 39 * 128), two, k=3, num_items=4000
        )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupmax_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(1)
    q = torch.nn.functional.normalize(torch.randn((200, 40), generator=gen), dim=1)
    items = torch.nn.functional.normalize(torch.randn((3000, 40), generator=gen), dim=1)
    q, items = q.to(cuda, dtype), items.to(cuda, dtype)
    got = kernels.groupmax_matmul_cuda(q, items, 2900)
    want = kernels.groupmax_matmul_plain(q, items, 2900)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def _edge_rows(layout, width, k, device):
    """The layouts of tests/test_torch_port_kernel_edges.py at card widths."""
    gen = torch.Generator().manual_seed(width + k)
    if layout == "ties_at_kth_scattered":
        x = torch.randn((16, width), generator=gen)
        kth = torch.sort(x, dim=1, descending=True).values[:, k - 1 : k]
        spots = torch.rand((16, width), generator=gen) < 0.01
        x = torch.where(spots, kth, x)
    elif layout == "one_top_digit":
        x = 1.0 + torch.randint(0, 48, (16, width), generator=gen).float() * 2.0**-23
    elif layout == "signed_zeros":
        x = torch.where(torch.rand((16, width), generator=gen) < 0.5, 0.0, -0.0)
        x[:, ::17] = torch.randn(x[:, ::17].shape, generator=gen) * 1e-30
    elif layout == "fewer_finite_than_k":
        x = torch.full((16, width), float("-inf"))
        x[0, [3, width // 2, width - 1]] = torch.tensor([0.5, -0.25, 0.5])
        x[1, ::50] = torch.finfo(torch.float32).min
        x[2, ::40] = -3.0e38
    else:  # random rows
        x = torch.randn((16, width), generator=gen)
    return x.to(device)


@pytest.mark.parametrize(
    "layout", ["ties_at_kth_scattered", "one_top_digit", "signed_zeros", "fewer_finite_than_k"]
)
@pytest.mark.parametrize("width,k", [(782, 20), (3072, 128), (15625, 24), (60000, 600)])
def test_small_k_topk_kernel_edges_bit_identical(cuda, layout, width, k):
    """Narrow rows (128-thread blocks), wide rows in shared memory and beyond
    it, the candidate path, the tied-top path and the radix path, rank
    counting and the bitonic sort."""
    x = _edge_rows(layout, width, k, cuda)
    kv, ki = kernels.small_k_topk_cuda(x, k)
    pv, pi = kernels.small_k_topk_plain(x, k)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("width", [1, 40, 128, 700, 7000])
def test_small_k_topk_kernel_k_equals_width(cuda, width):
    x = _edge_rows("random", width, width, cuda)
    x[:, ::3] = torch.round(x[:, ::3])  # ties
    kv, ki = kernels.small_k_topk_cuda(x, width)
    pv, pi = kernels.small_k_topk_plain(x, width)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,n,d,num_items",
    [
        (1, 3000, 128, 2999),
        (63, 1000, 36, 1000),
        (65, 4100, 40, 4000),
        (1024, 5000, 128, 4870),
        (200, 2000, 496, 1999),  # warpgroups in lockstep (128-query tile)
        (300, 3000, 256, 2990),  # in lockstep (256-query tile); 128 and below take turns
        (1024, 600_000, 128, 599_990),  # a stripe walk of ~36 groups a block
    ],
)
def test_groupmax_kernel_ragged_shapes_match_plain(cuda, dtype, b, n, d, num_items):
    gen = torch.Generator().manual_seed(b + n + d)
    q = torch.nn.functional.normalize(torch.randn((b, d), generator=gen), dim=1)
    items = torch.nn.functional.normalize(torch.randn((n, d), generator=gen), dim=1)
    if b % 2:  # all-negative scores, so pad rows must not win a tail group
        q, items = q.abs(), -items.abs()
    q, items = q.to(cuda, dtype), items.to(cuda, dtype)
    got = kernels.groupmax_matmul_cuda(q, items, num_items)
    want = kernels.groupmax_matmul_plain(q, items, num_items)
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
    # float32 group_exact at k <= 32: the group top-k, then the select kernel
    select = (algorithm, score_dtype) == ("group_exact", "float32")
    assert counts["small_k_topk"] == 2 - select
    assert counts["select_topk_from_groups"] == select
    assert counts["groupmax_matmul"] == counts["rescore_groups"] == int(algorithm == "fused")
    ws, wi = mips_topk(q, items, k=20, algorithm=algorithm, score_dtype=score_dtype)
    # A bf16 slab rounds each f32 sum to bf16: another summation order on
    # the card may land one bf16 step (2^-8 at |s| < 1) away.
    tol = 4e-3 if (algorithm, score_dtype) == ("group_exact", "bfloat16") else 1e-5
    torch.testing.assert_close(gs.cpu(), ws, rtol=0, atol=tol)
    # ids may differ only where the scores tie within the tolerance
    differ = gi.cpu() != wi
    assert torch.all((gs.cpu() - ws).abs()[differ] <= tol)


def test_bf16_search_beyond_the_groupmax_kernel_takes_the_slab(cuda):
    """At D = 648 groupmax_matmul refuses the shape, so a bf16 'auto' search
    of 500k items (which would go to 'fused') answers through group_exact."""
    from ttamm_torch.ops import topk

    gen = torch.Generator(device=cuda).manual_seed(648)
    items = torch.randn((topk.BF16_FUSED_MIN_ITEMS, 648), generator=gen, device=cuda)
    items = torch.nn.functional.normalize(items, dim=1).to(torch.bfloat16)
    q = torch.nn.functional.normalize(torch.randn((64, 648), generator=gen, device=cuda), dim=1)
    kernels.reset_launch_counts()
    got = mips_topk(q, items, k=20, score_dtype="bfloat16")
    assert kernels.launch_counts()["groupmax_matmul"] == 0
    want = mips_topk(q, items, k=20, algorithm="group_exact", score_dtype="bfloat16")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [21, 40])
def test_masked_float32_search_on_the_card_matches_the_cpu(cuda, k):
    """The eval's search: float32 group_exact with each query's blocked ids
    (the select kernel at k <= 32, the gather route beyond)."""
    gen = torch.Generator().manual_seed(k)
    q = torch.nn.functional.normalize(torch.randn((300, 64), generator=gen), dim=1)
    items = torch.nn.functional.normalize(torch.randn((5000, 64), generator=gen), dim=1)
    mask = torch.randint(0, 5100, (300, 40), generator=gen, dtype=torch.int32)
    mask[:, :8] = torch.topk(q @ items.T, 8).indices  # blocked ids that bite
    gs, gi = mips_topk(q.to(cuda), items.to(cuda), k=k, mask_rows=mask.to(cuda))
    ws, wi = mips_topk(q, items, k=k, mask_rows=mask)
    torch.testing.assert_close(gs.cpu(), ws, rtol=0, atol=1e-5)
    differ = gi.cpu() != wi
    assert torch.all((gs.cpu() - ws).abs()[differ] <= 1e-5)
    assert not (gi.cpu()[:, :, None] == mask[:, None, :].long()).any()


@pytest.mark.parametrize("n", [1, 33, 12288])
def test_row_kernels_bit_identical(cuda, n):
    gen = torch.Generator().manual_seed(n)
    table = torch.randn((5001, 128), generator=gen).to(cuda)  # last row: scratch
    idx = torch.randint(0, 5000, (n,), generator=gen, dtype=torch.int32).to(cuda)
    idx[: n // 3] = 17  # duplicates
    assert torch.equal(kernels.gather_rows_cuda(table, idx), kernels.gather_rows_plain(table, idx))
    if n <= 5000:
        uniq = torch.randperm(5000, generator=gen)[:n].to(cuda, torch.int32)
    else:  # unique rows, and every repeat on the scratch row
        uniq = torch.arange(n, dtype=torch.int32, device=cuda) % 4000
        uniq[4000:] = 5000
    rows = torch.randn((n, 128), generator=gen).to(cuda)
    a, b = table.clone(), table.clone()
    kernels.scatter_set_rows_cuda(a, uniq, rows)
    kernels.scatter_set_rows_plain(b, uniq, rows)
    assert torch.equal(a[:5000], b[:5000])


def _m2_case(cuda, n, c, d, seed):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.clamp((torch.empty(n).exponential_(generator=gen) * 4).int(), max=c + 2)
    ids[ids == 3] = 4  # an empty category
    x = torch.randn((n, d), generator=gen)
    return ids.to(cuda), x.to(cuda)


@pytest.mark.parametrize("n,c,d", [(12288, 64, 128), (70, 16, 40), (0, 8, 128)])
def test_segment_second_moments_kernels_match_plain(cuda, n, c, d):
    ids, x = _m2_case(cuda, n, c, d, n + d)
    got = kernels.segment_second_moments_cuda(ids, x, c)
    want = kernels.segment_second_moments_plain(ids, x, c)
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((got - want).abs() <= 2e-5 * scale).all())
    h = torch.randn((c, d, d), device=cuda)
    h = (h + h.transpose(1, 2)).contiguous()
    got_b = kernels.segment_second_moments_bwd_cuda(ids, x, h)
    want_b = kernels.segment_second_moments_bwd_plain(ids, x, h)
    if n:
        assert bool(((got_b - want_b).abs() <= 2e-5 * want_b.abs().max()).all())
        assert bool((got_b[ids >= c] == 0).all())


def test_segment_second_moments_autograd_matches_plain_backward(cuda):
    """The autograd function on the card (both kernels) against the plain
    versions' autograd (the einsums), for the same cotangent."""
    ids, x = _m2_case(cuda, 3000, 16, 128, 5)
    g = torch.randn((16, 128, 128), device=cuda)
    xk = x.clone().requires_grad_()
    (gk,) = torch.autograd.grad(SegmentSecondMoments.apply(ids, xk, 16), xk, g)
    xp = x.clone().requires_grad_()
    m2 = kernels.segment_second_moments_plain(ids, xp, 16)
    (gp,) = torch.autograd.grad(m2, xp, g)  # autograd through the f32 einsum
    # the einsum's own gradient keeps x unrounded in dx; the kernels round
    # H and x to bf16 as the TPU kernel does: agreement to bf16 precision
    torch.testing.assert_close(gk, gp, rtol=2e-2, atol=2e-2 * float(gp.abs().max()))
    want = kernels.segment_second_moments_bwd_plain(ids, x, (g + g.transpose(1, 2)).contiguous())
    assert bool(((gk - want).abs() <= 2e-5 * want.abs().max()).all())


def _m2_edge_ids(layout, c, seed):
    """Ids of the moments' edge layouts (R = the shipped chunk rows)."""
    gen = torch.Generator().manual_seed(seed)
    r = kernels.M2_CHUNK_ROWS
    if layout == "one_category":  # every row in one category
        return torch.full((3 * r + 5,), 3, dtype=torch.int32)
    if layout == "run_lengths":  # runs of R - 1, R, R + 1 and 2R + 1 rows, and ids outside
        ids = torch.repeat_interleave(torch.arange(4), torch.tensor([r - 1, r, r + 1, 2 * r + 1]))
        ids = torch.cat([ids, torch.tensor([-1, c, c + 9])])
        return ids[torch.randperm(ids.numel(), generator=gen)].to(torch.int32)
    if layout == "all_outside":
        return torch.tensor([-1, c, c + 3, -7] * 50, dtype=torch.int32)
    # skewed: the largest category ~30% of the rows, an empty one, a single member
    ids = torch.clamp((torch.empty(700).exponential_(generator=gen) * 6).int(), max=c - 3)
    ids[ids == 7] = 8
    ids[0] = c - 2
    return ids


@pytest.mark.parametrize("layout", ["one_category", "run_lengths", "all_outside", "skewed"])
@pytest.mark.parametrize("d", [8, 9, 30, 40, 128, 136, 512])
def test_segment_second_moments_kernel_edges(cuda, d, layout):
    """Both kernels against the einsums at narrow, ragged (D % 4 != 0: the
    scalar loads and stores) and the widest D, over the chunking's edge
    layouts: 2e-5 of each category's largest |M2| entry (exactly 0 for an
    empty category) and of the largest |dx|; rows with ids outside [0, C)
    get exactly 0."""
    c = 16
    ids = _m2_edge_ids(layout, c, d).to(cuda)
    gen = torch.Generator().manual_seed(d)
    x = (torch.randn((ids.numel(), d), generator=gen) * 0.3).to(cuda)
    got = kernels.segment_second_moments_cuda(ids, x, c)
    want = kernels.segment_second_moments_plain(ids, x, c)
    assert bool(((got - want).abs() <= 2e-5 * want.abs().amax(dim=(1, 2), keepdim=True)).all())
    h = torch.randn((c, d, d), generator=gen).to(cuda)
    h = (h + h.transpose(1, 2)).contiguous()
    got_b = kernels.segment_second_moments_bwd_cuda(ids, x, h)
    want_b = kernels.segment_second_moments_bwd_plain(ids, x, h)
    assert bool(((got_b - want_b).abs() <= 2e-5 * want_b.abs().max()).all())
    assert bool((got_b[(ids < 0) | (ids >= c)] == 0).all())


def test_segment_second_moments_kernels_repeat_their_bits(cuda):
    """Two calls of each direction give the same bits: the chunk partials
    are summed in chunk order and nothing uses atomics."""
    ids, x = _m2_case(cuda, 12288, 64, 128, 9)
    assert torch.equal(kernels.segment_second_moments_cuda(ids, x, 64),
                       kernels.segment_second_moments_cuda(ids, x, 64))
    h = torch.randn((64, 128, 128), device=cuda)
    h = (h + h.transpose(1, 2)).contiguous()
    assert torch.equal(kernels.segment_second_moments_bwd_cuda(ids, x, h),
                       kernels.segment_second_moments_bwd_cuda(ids, x, h))


@pytest.mark.parametrize("layout", ["one_category", "run_lengths", "skewed"])
@pytest.mark.parametrize("d", [40, 128])
def test_segment_second_moments_forward_is_the_rounded_exact_sum(cuda, d, layout):
    """The forward sums each chunk on the f64 tensor cores and the chunks in
    f64, then rounds once: M2 is the f64 einsum rounded to f32 bit for bit
    (one chunk, several chunks of one category, and both), and symmetric."""
    c = 16
    ids = _m2_edge_ids(layout, c, d).to(cuda)
    gen = torch.Generator().manual_seed(d + 1)
    x = (torch.randn((ids.numel(), d), generator=gen) * 0.3).to(cuda)
    xb = kernels._bf16(x).double()
    want = torch.einsum("cn,nd,ne->cde", kernels._selector(ids, c).double(), xb, xb).float()
    got = kernels.segment_second_moments_cuda(ids, x, c)
    assert torch.equal(got, want)
    assert torch.equal(got, got.transpose(1, 2))


def test_segment_second_moments_groups_once_per_loss_call(cuda, monkeypatch):
    """One forward + backward through the autograd function builds the row
    grouping once (one launch of the grouping kernel, its stable sort, and
    no other sort): the backward reuses the forward's."""
    groupings, sorts = [], []
    group, sort = kernels._group_by_category_cuda, torch.sort
    monkeypatch.setattr(kernels, "_group_by_category_cuda",
                        lambda *a, **k: groupings.append(1) or group(*a, **k))
    monkeypatch.setattr(torch, "sort", lambda *a, **k: sorts.append(1) or sort(*a, **k))
    ids, x = _m2_case(cuda, 3000, 16, 128, 5)
    xk = x.clone().requires_grad_()
    kernels.reset_launch_counts()
    m2 = SegmentSecondMoments.apply(ids, xk, 16)
    torch.autograd.grad(m2, xk, torch.randn_like(m2))
    torch.cuda.synchronize()
    assert len(groupings) == 1 and len(sorts) == 0
    counts = kernels.launch_counts()
    assert counts["category_grouping"] == 1
    assert counts["segment_second_moments"] == 1 and counts["segment_second_moments_bwd"] == 1


def _grouping_ids(layout):
    """Category ids and C of the grouping's layouts."""
    gen = torch.Generator().manual_seed(len(layout))
    r = kernels.M2_CHUNK_ROWS
    if layout == "canonical":  # 10 populated ids of 64, near-uniform
        return torch.randint(0, 10, (12288,), generator=gen), 64
    if layout == "skewed":  # one category with ~30% of the rows, ids >= C
        return (torch.empty(12288).exponential_(generator=gen) * 6).long(), 64
    if layout == "one_category":
        return torch.full((5 * r + 3,), 7), 64
    if layout == "run_lengths":  # R - 1, R, R + 1, 2R + 1 rows, shuffled, ids outside
        return _m2_edge_ids("run_lengths", 64, 1), 64
    if layout == "all_outside":
        return _m2_edge_ids("all_outside", 64, 1), 64
    if layout == "ragged_n":  # rows not a multiple of the block's 32 warps x 32 lanes
        return torch.randint(-2, 20, (1001,), generator=gen), 16
    if layout == "wide_c":  # C + 1 = 301 runs: the counts in shared memory
        return torch.randint(-2, 303, (3000,), generator=gen), 300
    if layout == "widest_c":  # C + 1 = 1001 runs: the counts in a scratch buffer
        return torch.randint(-2, 1003, (5000,), generator=gen), 1000
    return torch.zeros(0, dtype=torch.int64), 64  # "empty": N = 0


@pytest.mark.parametrize(
    "layout",
    ["canonical", "skewed", "one_category", "run_lengths", "all_outside", "ragged_n", "wide_c",
     "widest_c", "empty"],
)
def test_category_grouping_kernel_matches_plain(cuda, layout):
    """The grouping kernel gives its plain version's order (a stable sort),
    run offsets, chunk offsets and work list, bit for bit, for int32 and
    int64 ids, and the same bits on a second call."""
    ids, c = _grouping_ids(layout)
    for dtype in (torch.int32, torch.int64):
        dev_ids = ids.to(cuda, dtype)
        got = kernels.category_grouping(dev_ids, c)
        want = kernels._group_by_category(dev_ids, c)
        for name, a, b in zip(got._fields, got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert all(torch.equal(a, b) for a, b in zip(got, kernels.category_grouping(dev_ids, c)))


def _adam_case(dim, layout, seed, device):
    """Table, m, v (1000 rows) and lanes of sparse_adam_rows: live lanes on
    distinct rows, in the given layout."""
    gen = torch.Generator().manual_seed(seed)
    rows = 1000
    table = torch.randn((rows, dim), generator=gen)
    m = torch.randn((rows, dim), generator=gen) * 0.1
    v = torch.rand((rows, dim), generator=gen) * 0.01
    v[::7] = 0.0  # rows never touched before: sqrt(0) + eps
    n = {"all_live": 777, "every_other": 777, "all_masked": 300, "empty": 0, "one_lane": 1,
         "foreign_head_tail": 777, "owner_tail": 777}[layout]
    idx = torch.randperm(rows, generator=gen)[:n].to(torch.int32)
    if layout == "every_other":
        idx[1::2] = -1
    elif layout == "all_masked":
        idx[:] = -1
    elif layout == "foreign_head_tail":  # a shard's sorted lanes, the allgather routing
        idx = torch.sort(idx).values
        idx[:200], idx[600:] = -1, -1
    elif layout == "owner_tail":  # the owner buffer at one data shard
        idx = torch.sort(idx[:500]).values
        idx = torch.cat([idx, torch.full((n - 500,), -1, dtype=torch.int32)])
    grads = torch.randn((n, dim), generator=gen)
    grads[: n // 5] *= 1e-6  # |g| near eps
    return [t.to(device) for t in (table, m, v, idx, grads)]


ADAM_LAYOUTS = ["all_live", "every_other", "all_masked", "empty", "one_lane",
                "foreign_head_tail", "owner_tail"]
ADAM_DIMS = [4, 8, 36, 128, 132, 512]


@pytest.mark.parametrize("layout", ADAM_LAYOUTS)
@pytest.mark.parametrize("dim", ADAM_DIMS)
def test_sparse_adam_rows_kernel_bit_identical(cuda, dim, layout):
    """The fused row update gives its plain version's table, m and v over
    every row, at steps 1, 2 and 1000 with and without weight decay, and the
    same bits on a second run; masked lanes touch nothing."""
    table, m, v, idx, grads = _adam_case(dim, layout, dim, cuda)
    for step in (1, 2, 1000):
        for wd in (0.0, 0.01):
            hyper = dict(step=step, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
            runs = []
            for fn in (kernels.sparse_adam_rows_cuda, kernels.sparse_adam_rows_cuda,
                       kernels.sparse_adam_rows_plain):
                out = [t.clone() for t in (table, m, v)]
                kernels.reset_launch_counts()
                fn(*out, idx, grads, **hyper)
                torch.cuda.synchronize()
                assert kernels.launch_counts()["sparse_adam_rows"] == (
                    int(fn is kernels.sparse_adam_rows_cuda and idx.numel() > 0))
                runs.append(out)
            for got, again, want in zip(*runs):
                assert torch.equal(got, want), (step, wd)
                assert torch.equal(got, again), (step, wd)
            live = torch.zeros(table.shape[0], dtype=torch.bool, device=cuda)
            live[idx[idx >= 0].long()] = True
            for got, before in zip(runs[0], (table, m, v)):
                assert torch.equal(got[~live], before[~live])


@pytest.mark.parametrize("shape", [(2048, 105, 256), (12288, 256, 128), (7, 33, 5)])
def test_bf16_dot_gemm_on_the_card(cuda, shape):
    """model.precision: bfloat16's matmul on the card (one bf16 GEMM with
    float32 output) against the widened float32 product it stands for, and
    its gradients against the same on the CPU: float32 sums of exact bf16
    products in another order (rtol 1e-5, atol 1e-5 x the row's scale); the
    gradients round to bf16 (the weight's where the train step rounds it),
    so at most one bf16 ulp apart (rtol 2^-7)."""
    from ttamm_torch.models.encoders import bf16_dot

    n, k, out = shape
    gen = torch.Generator().manual_seed(n + k)
    x = torch.randn((n, k), generator=gen)
    w = torch.randn((out, k), generator=gen) / k**0.5
    g = torch.randn((n, out), generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        xd, wd = x.to(dev).clone().requires_grad_(), w.to(dev).clone().requires_grad_()
        y = bf16_dot(xd, wd)
        y.backward(g.to(dev))
        grads.append((y.detach().cpu(), xd.grad.cpu(), wd.grad.cpu()))
    (y0, dx0, dw0), (y1, dx1, dw1) = grads
    assert y1.dtype == torch.float32
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5 * float(y0.abs().max()))
    for got, want in ((dx1, dx0), (dw1.bfloat16().float(), dw0.bfloat16().float())):
        assert torch.equal(got, got.to(torch.bfloat16).float())  # bf16-representable
        torch.testing.assert_close(got, want, rtol=2**-7, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_search_on_the_card_matches_plain(cuda, masked):
    """The chunked search (ragged last chunk, k wider than one chunk's share
    of the corpus' rows) gives the ids and scores of the same scan with
    small_k_topk's plain version, two small_k_topk launches a chunk."""
    from ttamm_torch.ops import topk

    gen = torch.Generator().manual_seed(12)
    items = torch.randn((5000, 64), generator=gen).to(cuda)
    q = torch.randn((300, 64), generator=gen).to(cuda)
    mask = torch.randint(0, 5010, (300, 32), generator=gen, dtype=torch.int32).to(cuda) if masked else None
    kernels.reset_launch_counts()
    got = mips_topk(q, items, k=20, algorithm="chunked", chunk_size=768, mask_rows=mask)
    assert kernels.launch_counts()["small_k_topk"] == 2 * 7
    want = topk._chunked_topk(q, items, 20, 5000, mask_rows=mask, chunk_size=768, plain=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sparse_adam_on_the_card_counts_launches(cuda):
    """One sparse_adam_rows launch a table update and no row-kernel launch;
    the kernel path and the plain path agree bit for bit over every row, the
    (untouched) last row included."""
    gen = torch.Generator().manual_seed(6)
    table = torch.randn((1001, 128), generator=gen).to(cuda)
    ref = table.clone()
    state, ref_state = init_sparse_adam(table), init_sparse_adam(ref)
    idx = torch.randint(0, 1000, (777,), generator=gen, dtype=torch.int32).to(cuda)
    grads = torch.randn((777, 128), generator=gen).to(cuda)
    kernels.reset_launch_counts()
    sparse_adam_update(table, state, idx, grads, lr=0.01)
    counts = kernels.launch_counts()
    assert counts["sparse_adam_rows"] == 1
    assert counts["gather_rows"] == counts["scatter_set_rows"] == 0
    saved = kernels.sparse_adam_rows
    try:
        kernels.sparse_adam_rows = kernels.sparse_adam_rows_plain
        sparse_adam_update(ref, ref_state, idx, grads, lr=0.01)
    finally:
        kernels.sparse_adam_rows = saved
    # the duplicate rows are summed in a fixed order (no atomics) and the
    # kernel rounds each op as the eager composition does: kernel and plain
    # runs agree bit for bit
    for a, b in ((table, ref), (state.m, ref_state.m), (state.v, ref_state.v)):
        assert torch.equal(a, b)


STEP_KERNELS = ("gather_rows", "sparse_adam_rows", "segment_second_moments", "segment_second_moments_bwd")


def _one_step(cuda, plain, seeds=(8, 4), swap=None, in_batch=None, wire=False):
    """One step of a gated-tower model (D = 128, C = 16) from a seeded state
    (``seeds``: data, state) with injected negatives and no dropout, with the
    kernels or with their plain versions on the card, and any kernel
    replaced by the function ``swap`` maps its name to: (state, metrics,
    launch counts). ``in_batch`` (M): the recommended configuration instead,
    the logQ-corrected in-batch softmax over the batch and an injected pool
    of M ids (one of them a positive), with sparse mimic tables. ``wire``:
    configs/pod_2x4.yaml's bf16 gradient wire and bf16 feature matrices."""
    from ttamm_torch.models import parse_model_config
    from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state, make_train_step
    from ttamm_torch.train.optim import DenseOptConfig

    tower = {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": 128, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [64], "output_dim": 128},
        "fusion": "gated",
    }
    model = {"user_encoder": tower, "item_encoder": tower}
    if in_batch is not None:
        model["adaptive_mimic"] = {"enabled": True, "sparse": True}
    cfg = parse_model_config(model, user_feature_dim=12, item_feature_dim=9)
    gen = torch.Generator().manual_seed(seeds[0])
    nu, ni, b, neg = 500, 400, 64, 5
    data = BatchData(
        user_features=torch.randn((nu, 12), generator=gen).to(cuda),
        item_features=torch.randn((ni, 9), generator=gen).to(cuda),
        positive_rows=torch.randint(0, ni, (nu, 4), generator=gen, dtype=torch.int32).to(cuda),
        category_ids=torch.clamp(torch.randint(0, 40, (ni,), generator=gen) // 3, max=20)
        .to(cuda, torch.int32),
    )
    tscfg = TrainStepConfig(
        num_items=ni, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
        lambda_category_alignment=0.01, cal_max_categories=16,
        opt=DenseOptConfig(name="adamw", lr=1e-3, weight_decay=0.01),
    )
    u = torch.randint(0, nu, (b,), generator=gen, dtype=torch.int32).to(cuda)
    p = torch.randint(0, ni, (b,), generator=gen, dtype=torch.int32).to(cuda)
    negs = torch.randint(0, ni, (b, neg), generator=gen, dtype=torch.int32).to(cuda)
    if in_batch is not None:
        tscfg = tscfg._replace(loss_type="in_batch_softmax", mixed_negatives=in_batch)
        p[b // 2] = p[1]  # a duplicate positive
        negs = torch.randint(0, ni, (in_batch,), generator=gen, dtype=torch.int32).to(cuda)
        negs[: min(in_batch, 1)] = p[0]  # a pool draw equal to a positive
        data.item_log_q = torch.log_softmax(torch.randn(ni, generator=gen) * 2, 0).to(cuda)
    if wire:
        tscfg = tscfg._replace(comm_dtype="bfloat16")
        data.user_features = data.user_features.to(torch.bfloat16)
        data.item_features = data.item_features.to(torch.bfloat16)
    step = make_train_step(cfg, tscfg)
    state = create_train_state(cfg, num_users=nu, num_items=ni, seed=seeds[1], device=cuda)
    saved = {n: getattr(kernels, n) for n in STEP_KERNELS}
    kernels.reset_launch_counts()
    try:
        if plain:
            for n in STEP_KERNELS:
                setattr(kernels, n, getattr(kernels, f"{n}_plain"))
        for n, fn in (swap or {}).items():
            setattr(kernels, n, fn)
        state, metrics = step(state, data, u, p, generator=None, negatives=negs)
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)
    return state, metrics, kernels.launch_counts()


def test_train_step_on_the_card_matches_plain(cuda):
    """The step with the kernels and with their plain versions: the same
    losses and, within lr / 100, the same parameters (Adam's first step
    amplifies summation-order differences where |g| is near eps). Every
    kernel of the step launches: one read and one fused update of each
    sparse table, and one moments pass each way; the standalone scatter
    does not run."""
    (sk, mk, ck), (sp, mp, cp) = _one_step(cuda, False), _one_step(cuda, True)
    assert [ck[n] for n in STEP_KERNELS] == [2, 2, 1, 1]
    assert ck["scatter_set_rows"] == 0
    assert all(cp[n] == 0 for n in STEP_KERNELS)
    for name in mk:
        torch.testing.assert_close(mk[name], mp[name], rtol=1e-5, atol=1e-7)
    for name in ("user_id", "item_id", "user_aug", "item_aug"):
        torch.testing.assert_close(sk.tables[name], sp.tables[name], rtol=0, atol=1e-5)
    for (_, a), (_, bb) in zip(sk.dense_targets(), sp.dense_targets()):
        torch.testing.assert_close(a.detach(), bb.detach(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [0, 256])
def test_in_batch_step_on_the_card_matches_plain(cuda, m):
    """The recommended configuration's step (in-batch softmax, sparse mimic
    tables) with the kernels and with their plain versions: the same losses
    and, within lr / 100, the same tables (the mimic tables' scratch rows
    untouched) and dense parameters. One read and one fused update of each
    of the four sparse tables, one moments pass each way, no scatter."""
    (sk, mk, ck), (sp, mp, cp) = (_one_step(cuda, plain, in_batch=m) for plain in (False, True))
    assert [ck[n] for n in STEP_KERNELS] == [4, 4, 1, 1]
    assert ck["scatter_set_rows"] == 0
    assert all(cp[n] == 0 for n in STEP_KERNELS)
    for name in mk:
        assert torch.isfinite(mk[name])
        torch.testing.assert_close(mk[name], mp[name], rtol=1e-5, atol=1e-7)
    for name in ("user_id", "item_id", "user_aug", "item_aug"):
        torch.testing.assert_close(sk.tables[name], sp.tables[name], rtol=0, atol=1e-5)
        torch.testing.assert_close(sk.opt_sparse[name].v, sp.opt_sparse[name].v, rtol=1e-4, atol=1e-9)
    for name in ("user_aug", "item_aug"):
        assert not sk.tables[name][-1].any()
    for (_, a), (_, bb) in zip(sk.dense_targets(), sp.dense_targets()):
        torch.testing.assert_close(a.detach(), bb.detach(), rtol=0, atol=1e-5)


def test_pod_step_on_the_card_matches_plain(cuda):
    """configs/pod_2x4.yaml's step (in-batch softmax, sparse mimic tables,
    the bf16 gradient wire, bf16 features) with the kernels and with their
    plain versions: the same launches as the recommended step, the same
    losses, and tables within lr / 100 but for elements a bf16 rounding
    flip moved (the two runs sum a lane's float32 gradient in another
    order, so a lane near a rounding boundary may round the other way: at
    most 1e-4 of a table's elements, each within 2.5 lr); the rounding
    happened (the float32 wire's tables differ)."""
    (sk, mk, ck), (sp, mp, cp) = (_one_step(cuda, plain, in_batch=0, wire=True)
                                  for plain in (False, True))
    exact, _, _ = _one_step(cuda, False, in_batch=0)
    assert [ck[n] for n in STEP_KERNELS] == [4, 4, 1, 1]
    assert ck["scatter_set_rows"] == 0 and all(cp[n] == 0 for n in STEP_KERNELS)
    for name in mk:
        torch.testing.assert_close(mk[name], mp[name], rtol=1e-5, atol=1e-7)
    for name in ("user_id", "item_id", "user_aug", "item_aug"):
        err = (sk.tables[name] - sp.tables[name]).abs()
        assert int((err > 1e-5).sum()) <= 1e-4 * err.numel() and float(err.max()) <= 2.5e-3, name
        assert not torch.equal(sk.tables[name], exact.tables[name]), name
    for (_, a), (_, bb) in zip(sk.dense_targets(), sp.dense_targets()):
        torch.testing.assert_close(a.detach(), bb.detach(), rtol=0, atol=1e-5)


def test_exchange_owner_read_on_the_card(cuda):
    """The all-to-all exchange's owner-local read (``parallel/exchange.py``):
    one gather_rows launch at the received ids, shard-localised and clipped
    (slots past a bucket's count carry id 0), bit-identical to indexing the
    shard with the clipped ids."""
    from ttamm_torch.parallel.exchange import _owner_rows, route_by_owner

    gen = torch.Generator().manual_seed(21)
    rows, shards, me = 25_000, 4, 2
    local = torch.randn((rows, 128), generator=gen).to(cuda)
    got = torch.randint(me * rows, (me + 1) * rows, (6144,), generator=gen)
    got[::7] = 0  # empty slots of the dense layout
    got[5::11] = got[3]  # duplicates
    got = got.to(cuda, torch.int32)
    kernels.reset_launch_counts()
    out = _owner_rows(local, got, me)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_rows"] == 1
    lane = torch.clamp(got.long() - me * rows, 0, rows - 1)
    assert torch.equal(out, local[lane])
    plan = route_by_owner(got, rows, shards, capacity=got.numel())
    host = route_by_owner(got.cpu(), rows, shards, capacity=got.numel())
    for a, b in zip(plan, host):
        assert torch.equal(a.cpu(), b)


def test_in_batch_step_on_the_card_is_deterministic(cuda):
    """Two runs of the recommended configuration's step give the same bits."""
    (s1, m1, _), (s2, m2, _) = (_one_step(cuda, False, in_batch=256) for _ in range(2))
    for name in m1:
        assert torch.equal(m1[name], m2[name]), name
    for name in ("user_id", "item_id", "user_aug", "item_aug"):
        for a, bb in ((s1.tables[name], s2.tables[name]),
                      (s1.opt_sparse[name].m, s2.opt_sparse[name].m)):
            assert torch.equal(a, bb), name
    for (key, a), (_, bb) in zip(s1.dense_targets(), s2.dense_targets()):
        assert torch.equal(a.detach(), bb.detach()), key


@pytest.mark.parametrize("m", [0, 256])
def test_row_kernels_at_the_in_batch_steps_mimic_lanes(cuda, m):
    """gather_rows and sparse_adam_rows on a sparse mimic table at the
    recommended step's lanes (B = 2048 user lanes; B + M item lanes, the
    positives Zipf-skewed, so duplicate-heavy), bit-identical to their
    plain versions; the scratch row untouched."""
    from ttamm_torch.ops.sparse_adam import coalesce_row_grads

    gen = torch.Generator().manual_seed(12 + m)
    b, rows, dim = 2048, 99_880, 128
    ranks = torch.multinomial(1.0 / torch.arange(1, rows + 1, dtype=torch.float64), b,
                              replacement=True, generator=gen)
    lanes = {"user": torch.randint(0, 199_449, (b,), generator=gen),
             "item": torch.cat([ranks, torch.randint(0, rows, (m,), generator=gen)])}
    for side, idx in lanes.items():
        n_rows = 199_449 if side == "user" else rows
        table = torch.cat([torch.randn((n_rows, dim), generator=gen) * 0.02,
                           torch.zeros((1, dim))]).to(cuda)
        idx = idx.to(cuda, torch.int32)
        assert torch.equal(kernels.gather_rows_cuda(table, idx), kernels.gather_rows_plain(table, idx))
        grads = (torch.randn((idx.numel(), dim), generator=gen) * 1e-2).to(cuda)
        target, summed = coalesce_row_grads(idx, grads, scratch_row=-1)
        m_, v_ = torch.zeros_like(table), torch.zeros_like(table)
        hyper = dict(step=1, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
        runs = []
        for fn in (kernels.sparse_adam_rows_cuda, kernels.sparse_adam_rows_plain):
            out = [t.clone() for t in (table, m_, v_)]
            fn(*out, target, summed, **hyper)
            runs.append(out)
        for got, want in zip(*runs):
            assert torch.equal(got, want), side
        assert not runs[0][0][-1].any()


def test_train_step_on_the_card_is_deterministic(cuda):
    """Two runs of the step with the kernels give the same bits: every sum
    over duplicate rows (sparse Adam, the dense-table gradients, the
    category sums) runs in a fixed order, and the kernels use no atomics."""
    (s1, m1, _), (s2, m2, _) = _one_step(cuda, False), _one_step(cuda, False)
    for name in m1:
        assert torch.equal(m1[name], m2[name]), name
    for name in ("user_id", "item_id", "user_aug", "item_aug"):
        assert torch.equal(s1.tables[name], s2.tables[name]), name
        if name in s1.opt_sparse:
            assert torch.equal(s1.opt_sparse[name].m, s2.opt_sparse[name].m), name
            assert torch.equal(s1.opt_sparse[name].v, s2.opt_sparse[name].v), name
    for (key, a), (_, bb) in zip(s1.dense_targets(), s2.dense_targets()):
        assert torch.equal(a.detach(), bb.detach()), key
    for a, bb in zip(s1.opt_dense.m + s1.opt_dense.v, s2.opt_dense.m + s2.opt_dense.v):
        assert torch.equal(a, bb)


@pytest.mark.parametrize("layout", ["lookup", "foreign_head_tail", "all_masked", "empty",
                                    "owner_tail"])
@pytest.mark.parametrize("dim", ADAM_DIMS)
def test_masked_gather_kernel_bit_identical(cuda, dim, layout):
    """The lookup gather of a shard (rows 300-799 of 1000 as a 500-row
    shard) equals its plain version on every lane, its zeros included: at
    a step's lookup lanes (global ids in batch order, foreign lanes
    everywhere) and at the sparse update's layouts (-1 lanes at the head
    and the tail, all masked, none, a sentinel tail)."""
    gen = torch.Generator().manual_seed(dim)
    rows, base = 500, 300
    local = torch.randn((rows, dim), generator=gen).to(cuda)
    if layout == "lookup":
        idx = torch.randint(0, 1000, (4096,), generator=gen, dtype=torch.int32)
    else:
        _, _, _, idx, _ = _adam_case(dim, layout, dim, "cpu")
        idx = torch.where(idx >= 0, idx % rows + base, idx)
    idx = idx.to(cuda)
    kernels.reset_launch_counts()
    got = kernels.gather_rows_cuda(local, idx, masked=True, base=base)
    again = kernels.gather_rows_cuda(local, idx, masked=True, base=base)
    want = kernels.gather_rows_plain(local, idx, masked=True, base=base)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_rows_masked"] == 2 * int(idx.numel() > 0)
    assert torch.equal(got, want) and torch.equal(got, again)
    own = (idx >= base) & (idx < base + rows)
    assert not got[~own].any()
    assert torch.equal(got[own], local[(idx[own] - base).long()])


@pytest.mark.parametrize("layout", ["head_and_tail", "tail", "all_masked", "duplicates"])
def test_masked_row_kernels_bit_identical(cuda, layout):
    """gather_rows_masked and scatter_set_rows_masked equal their plain
    versions, the gather on every lane (zeros on the masked ones), the
    scatter on every row; masked lanes of the scatter write nothing."""
    gen = torch.Generator().manual_seed(11)
    table = torch.randn((5000, 128), generator=gen).to(cuda)
    idx = torch.sort(torch.randint(0, 5000, (4096,), generator=gen)).values.to(torch.int32)
    if layout == "head_and_tail":
        idx[:1000], idx[3000:] = -1, -1
    elif layout == "tail":
        idx[2500:] = -1
    elif layout == "all_masked":
        idx[:] = -1
    else:
        idx = (torch.arange(4096) // 4).to(torch.int32)
    idx = idx.to(cuda)
    live = idx >= 0
    kernels.reset_launch_counts()
    got = kernels.gather_rows_cuda(table, idx, masked=True)
    want = kernels.gather_rows_plain(table, idx, masked=True)
    assert torch.equal(got, want) and not got[~live].any()
    src = got * 0.5  # lanes of one row carry identical bytes
    t_kernel, t_plain = table.clone(), table.clone()
    kernels.scatter_set_rows_cuda(t_kernel, idx, src, masked=True)
    kernels.scatter_set_rows_plain(t_plain, idx, src, masked=True)
    torch.cuda.synchronize()
    assert torch.equal(t_kernel, t_plain)
    counts = kernels.launch_counts()
    assert counts["gather_rows_masked"] == counts["scatter_set_rows_masked"] == 1


def test_shard_local_update_on_the_card_matches_one_device(cuda):
    """The allgather routing's update applied to 4 row slices (one
    sparse_adam_rows launch each, non-heads and foreign lanes -1) equals
    the single-device sparse_adam_update bit for bit (the scratch row
    aside)."""
    from ttamm_torch.ops.sparse_adam import SparseAdamState
    from ttamm_torch.parallel.sparse_update import _apply, _localize, sort_lanes

    gen = torch.Generator().manual_seed(5)
    rows, shards = 4001, 4  # 4000 rows + the scratch row
    table = torch.randn((rows, 128), generator=gen).to(cuda)
    idx = torch.randint(0, rows - 1, (3072,), generator=gen).to(cuda)
    grads = torch.randn((3072, 128), generator=gen).to(cuda)
    ref = init_sparse_adam(table)
    ref_table = table.clone()
    sparse_adam_update(ref_table, ref, idx, grads, lr=1e-3)
    rps = -(-(rows) // shards)
    pad = lambda t: torch.cat([t, t.new_zeros((rps * shards - rows, 128))])  # noqa: E731
    tab, m, v = pad(table), pad(torch.zeros_like(table)), pad(torch.zeros_like(table))
    lanes = sort_lanes(idx, grads, head_init=-2)
    scalars = torch.from_numpy(kernels.adam_scalars(
        step=1, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)).to(cuda)
    kernels.reset_launch_counts()
    for s in range(shards):
        sl = slice(s * rps, (s + 1) * rps)
        _apply(tab[sl], SparseAdamState(m=m[sl], v=v[sl]),
               _localize(lanes.idx, s * rps, rps, lanes.is_head), lanes.totals(),
               scalars=scalars, decay=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["sparse_adam_rows"] == shards
    assert counts["gather_rows_masked"] == counts["scatter_set_rows_masked"] == 0
    n = rows - 1
    assert torch.equal(tab[:n], ref_table[:n])
    assert torch.equal(m[:n], ref.m[:n]) and torch.equal(v[:n], ref.v[:n])


# ---------------------------------------------------------------------------
# training.steps_per_call: the multi-step calls as CUDA-graph replays
# ---------------------------------------------------------------------------


def _multi_case(cuda, in_batch: bool, steps: int = 16, b: int = 256):
    """A seeded state of the default structure (BCE, 5 negatives, dense
    mimic tables) or the recommended one (the logQ-corrected in-batch
    softmax, sparse mimic tables), gated towers with dropout 0.15, D = 128,
    C = 16, a cosine schedule; its data and ``steps`` batches."""
    from ttamm_torch.models import parse_model_config
    from ttamm_torch.train import BatchData, TrainStepConfig, create_train_state
    from ttamm_torch.train.optim import DenseOptConfig

    tower = {
        "type": "tower",
        "id_embedding": {"params": {"embedding_dim": 128, "sparse": True}},
        "feature_encoder": {"type": "mlp", "hidden_dims": [64], "output_dim": 128,
                            "dropout": 0.15},
        "fusion": "gated",
    }
    model = {"user_encoder": tower, "item_encoder": tower,
             "adaptive_mimic": {"enabled": True, "sparse": in_batch}}
    cfg = parse_model_config(model, user_feature_dim=12, item_feature_dim=9)
    gen = torch.Generator().manual_seed(21)
    nu, ni = 3000, 2000
    data = BatchData(
        user_features=torch.randn((nu, 12), generator=gen).to(cuda),
        item_features=torch.randn((ni, 9), generator=gen).to(cuda),
        positive_rows=torch.randint(0, ni, (nu, 4), generator=gen, dtype=torch.int32).to(cuda),
        category_ids=torch.clamp(torch.randint(0, 40, (ni,), generator=gen) // 3, max=20)
        .to(cuda, torch.int32),
        item_log_q=torch.log_softmax(torch.randn(ni, generator=gen) * 2, 0).to(cuda)
        if in_batch else None,
    )
    tscfg = TrainStepConfig(
        num_items=ni, lambda_mimic_user=0.15, lambda_mimic_item=0.15,
        lambda_category_alignment=0.01, cal_max_categories=16,
        loss_type="in_batch_softmax" if in_batch else "bce",
        opt=DenseOptConfig(name="adamw", lr=1e-3, weight_decay=0.01, lr_schedule="cosine",
                           lr_total_steps=2 * steps, lr_final_factor=0.1),
    )
    state = create_train_state(cfg, num_users=nu, num_items=ni, seed=3, device=cuda)
    users = torch.randint(0, nu, (steps, b), generator=gen, dtype=torch.int32).to(cuda)
    items = torch.randint(0, ni, (steps, b), generator=gen, dtype=torch.int32).to(cuda)
    return cfg, tscfg, state, data, users, items


def _flat(state):
    from ttamm_torch.models.convert import train_state_to_flat

    return {k: torch.as_tensor(v) for k, v in train_state_to_flat(state).items()}


@pytest.mark.parametrize("in_batch", [False, True], ids=["default", "in_batch"])
def test_replays_equal_eager_steps_bit_for_bit(cuda, in_batch):
    """Two multi-step calls of 8 (the first: one eager step, the capture,
    7 replays; the second: 8 replays) equal 16 eager single steps bit for
    bit, dropout on: every state leaf, the losses, the host counts and the
    generator's state; the launch counts equal the eager steps'."""
    import copy

    from ttamm_torch.train import make_train_step
    from ttamm_torch.train.step import make_multi_train_step

    cfg, tscfg, state, data, users, items = _multi_case(cuda, in_batch)
    eager, replayed = copy.deepcopy(state), copy.deepcopy(state)
    gen_e = torch.Generator(device=cuda).manual_seed(17)
    gen_r = torch.Generator(device=cuda).manual_seed(17)
    single = make_train_step(cfg, tscfg)
    kernels.reset_launch_counts()
    want = torch.stack([single(eager, data, users[k], items[k], generator=gen_e)[1]["loss"]
                        for k in range(16)])
    torch.cuda.synchronize()
    eager_counts = kernels.launch_counts()
    multi = make_multi_train_step(cfg, tscfg)
    kernels.reset_launch_counts()
    got = torch.cat([multi(replayed, data, users[k : k + 8], items[k : k + 8], generator=gen_r)[1]
                     for k in (0, 8)])
    torch.cuda.synchronize()
    assert kernels.launch_counts() == eager_counts
    assert eager_counts["sparse_adam_rows"] == 16 * (4 if in_batch else 2)
    assert torch.equal(got, want)
    assert (replayed.step, replayed.opt_dense.step) == (eager.step, eager.opt_dense.step) == (16, 16)
    a, b = _flat(replayed), _flat(eager)
    assert list(a) == list(b)
    for key in b:
        assert torch.equal(a[key], b[key]), key
    assert torch.equal(gen_r.get_state(), gen_e.get_state())


def test_eval_replays_equal_eager_steps_across_reseeds(cuda):
    """The multi-step eval loss: 6 batches a call, twice with the one
    generator object re-seeded (the trainer's per-epoch eval: one capture,
    then replays only), equal to the eager eval steps bit for bit."""
    from ttamm_torch.train.step import make_eval_loss_step, make_multi_eval_loss_step

    cfg, tscfg, state, data, users, items = _multi_case(cuda, True, steps=6)
    single, multi = make_eval_loss_step(cfg, tscfg), make_multi_eval_loss_step(cfg, tscfg)
    gen = torch.Generator(device=cuda)
    for seed in (5, 6):
        ref = torch.Generator(device=cuda).manual_seed(seed)
        want = torch.stack([single(state, data, users[k], items[k], generator=ref)
                            for k in range(6)])
        got = multi(state, data, users, items, generator=gen.manual_seed(seed))
        assert torch.equal(got, want), seed
        assert torch.equal(gen.get_state(), ref.get_state())


def test_sparse_adam_rows_reads_its_scalars_through_a_pointer(cuda):
    """The kernel given a row of a per-step scalar table (a pointer into
    the table's middle) equals its plain version on that row and the
    by-value form of the same step, bit for bit."""
    import numpy as np

    table, m, v, idx, grads = _adam_case(128, "all_live", 7, cuda)
    rows = np.stack([kernels.adam_scalars(step=s, lr=1e-3 * s, b1=0.9, b2=0.999, eps=1e-8,
                                          weight_decay=0.01) for s in (1, 2, 3)])
    scal = torch.from_numpy(rows).to(cuda)
    out = {}
    for label, fn, kw in (
        ("kernel", kernels.sparse_adam_rows_cuda, dict(scalars=scal[1], decay=True)),
        ("plain", kernels.sparse_adam_rows_plain, dict(scalars=scal[1], decay=True)),
        ("by value", kernels.sparse_adam_rows_cuda,
         dict(step=2, lr=2e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)),
    ):
        out[label] = [t.clone() for t in (table, m, v)]
        fn(*out[label], idx, grads, **kw)
    torch.cuda.synchronize()
    for got, plain, by_value in zip(out["kernel"], out["plain"], out["by value"]):
        assert torch.equal(got, plain) and torch.equal(got, by_value)


# (name, weight decay): AdamW with and without decay, Adam with L2 decay
DENSE_MODES = [("adamw", 0.01), ("adamw", 0.0), ("adam", 0.1)]
# default.train's two mimic tables scaled down, tower shapes, ragged sizes
DENSE_SHAPES = ((1995, 128), (999, 128), (256, 105), (256,), (128, 256), (1,), (3,), (5,), (127,))


def _dense_case(seed, device, shapes=DENSE_SHAPES):
    """``(params, grads, m, v)`` over ``shapes``, plus one tensor of 1,000
    elements that is a view at a 4-byte offset (not 16-byte aligned) in
    each list; m and v with zeros where a row was never touched, gradients
    near eps in places."""
    gen = torch.Generator().manual_seed(seed)

    def offset_view(scale, positive=False):
        base = torch.rand(1001, generator=gen) if positive else torch.randn(1001, generator=gen)
        return (base * scale).to(device)[1:]

    out = []
    for scale, positive in ((1.0, False), (1e-2, False), (1e-2, False), (1e-4, True)):
        ts = [(torch.rand(s, generator=gen) if positive else torch.randn(s, generator=gen))
              * scale for s in shapes]
        ts = [t.to(device) for t in ts] + [offset_view(scale, positive)]
        out.append(ts)
    params, grads, m, v = out
    for t in (*m, *v):
        t.view(-1)[::7] = 0.0
    for g in grads:
        g.view(-1)[::5] *= 1e-6
    assert grads[-1].data_ptr() % 16 == 4
    return params, grads, m, v


def _dense_run(fn, case, cfg, scalars):
    params, grads, m, v = ([t.clone() for t in ts] for ts in case)
    fn(params, grads, m, v, scalars=scalars, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
       weight_decay=cfg.weight_decay, decoupled=cfg.name == "adamw")
    return params, m, v


@pytest.mark.parametrize("step", [1, 2, 1000])
@pytest.mark.parametrize("name,wd", DENSE_MODES, ids=["adamw", "adamw_no_decay", "adam_l2"])
def test_dense_adam_kernel_bit_identical(cuda, name, wd, step):
    """One dense_adam launch over the whole list gives the _foreach_
    composition's p, m and v bit for bit (every element, the ragged sizes
    and the unaligned view included), and the same bits on a second run."""
    from ttamm_torch.train.optim import DenseOptConfig, dense_scalars

    cfg = DenseOptConfig(name=name, lr=1e-3, weight_decay=wd)
    case = _dense_case(step, cuda)
    scalars = torch.from_numpy(dense_scalars(cfg, step)).to(cuda)
    kernels.reset_launch_counts()
    got = _dense_run(kernels.dense_adam_cuda, case, cfg, scalars)
    again = _dense_run(kernels.dense_adam_cuda, case, cfg, scalars)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["dense_adam"] == 2
    want = _dense_run(kernels.dense_adam_plain, case, cfg, scalars)
    for label, a, b, c in zip(("p", "m", "v"), got, again, want):
        for i, (x, y, z) in enumerate(zip(a, b, c)):
            assert torch.equal(x, z), (label, i)
            assert torch.equal(x, y), (label, i)


def test_dense_adam_splits_a_long_list(cuda):
    """A list of more tensors than a launch takes (64) takes one launch
    for every 64 of them (empty tensors none) in one call, and the
    composition's bits."""
    from ttamm_torch.train.optim import DenseOptConfig, dense_scalars

    cfg = DenseOptConfig(name="adamw", lr=1e-3, weight_decay=0.01)
    assert kernels.load_library().ttamm_dense_adam_tensors_a_launch() == 64
    shapes = [(k % 9 + 1, 4 + k % 3) for k in range(2 * 64 + 5)]
    shapes[3] = (0, 4)
    case = _dense_case(3, cuda, shapes)
    scalars = torch.from_numpy(dense_scalars(cfg, 5)).to(cuda)
    kernels.reset_launch_counts()
    got = _dense_run(kernels.dense_adam_cuda, case, cfg, scalars)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["dense_adam"] == 3  # 2 x 64 + 5 live tensors, in 64s
    want = _dense_run(kernels.dense_adam_plain, case, cfg, scalars)
    for a, c in zip(got, want):
        for x, z in zip(a, c):
            assert torch.equal(x, z)


def test_dense_adam_replay_reads_its_step_through_a_pointer(cuda):
    """A dense_adam launch captured into a CUDA graph, replayed after its
    scalar row is rewritten with step 1000's, equals the eager kernel and
    the composition at step 1000, bit for bit."""
    from ttamm_torch.train.optim import DenseOptConfig, dense_scalars

    cfg = DenseOptConfig(name="adamw", lr=1e-3, weight_decay=0.01)
    case = _dense_case(11, cuda)
    row = torch.from_numpy(dense_scalars(cfg, 1)).to(cuda)
    captured = [[t.clone() for t in ts] for ts in case]
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay, decoupled=True)
    _dense_run(kernels.dense_adam_cuda, case, cfg, row)  # loads the library before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernels.dense_adam_cuda(*captured, scalars=row, **kw)
    row.copy_(torch.from_numpy(dense_scalars(cfg, 1000)))
    graph.replay()
    torch.cuda.synchronize()
    eager = _dense_run(kernels.dense_adam_cuda, case, cfg, row)
    want = _dense_run(kernels.dense_adam_plain, case, cfg, row)
    for got, e, w in zip((captured[0], captured[2], captured[3]), eager, want):
        for x, y, z in zip(got, e, w):
            assert torch.equal(x, y) and torch.equal(x, z)


def test_default_step_on_the_card_runs_one_dense_adam_launch(cuda, monkeypatch):
    """A default-configuration step (dense mimic tables on AdamW) updates
    its dense targets with one dense_adam launch and no _foreach_ pass."""

    def refuse(*args, **kwargs):
        raise AssertionError("torch._foreach_mul_ called in the dense update")

    monkeypatch.setattr(torch, "_foreach_mul_", refuse)
    state, _, counts = _one_step(cuda, False)
    assert counts["dense_adam"] == 1
    assert {n for n, _ in state.dense_targets()} >= {"tables/user_aug", "tables/item_aug"}


def test_a_capture_that_meets_a_host_sync_raises(cuda, monkeypatch):
    """A step that syncs the host (here a gather that reads a value) cannot
    be captured: the multi-step call raises, and nothing falls back to
    eager steps (the launch counts are the warm-up step's alone)."""
    from ttamm_torch.train.step import make_multi_train_step

    cfg, tscfg, state, data, users, items = _multi_case(cuda, False, steps=4)
    gather = kernels.gather_rows

    def syncing(table, idx, **kw):
        int(idx[0])  # a host read: cudaMemcpy + stream sync
        return gather(table, idx, **kw)

    monkeypatch.setattr(kernels, "gather_rows", syncing)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError):
        make_multi_train_step(cfg, tscfg)(state, data, users, items,
                                          generator=torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sparse_adam_rows"] == 2  # the eager warm-up step


def test_device_cond_takes_one_branch_eager_and_replayed(cuda):
    """``device_cond.cond`` on the card: the branch the device flag names
    runs, eagerly (its own small graph) and inside a captured graph at each
    replay, with no host read; one branch's launches are counted a call."""
    from ttamm_torch.ops import device_cond

    table = torch.arange(40 * 8, dtype=torch.float32, device=cuda).view(40, 8)
    out = torch.zeros(6, 8, device=cuda)

    def take(shift):
        def branch(idx, flag):
            out.copy_(kernels.gather_rows(table, idx) + shift)
        return branch

    def call(idx):
        flag = (idx.sum() > 100).to(torch.int32).reshape(1)
        device_cond.cond(flag, take(1.0), take(-1.0), (idx, flag), key=("cuda test", out.data_ptr()))

    def want(idx):
        return table[idx.long()] + (1.0 if int(idx.sum()) > 100 else -1.0)

    lanes = [torch.tensor(v, dtype=torch.int32, device=cuda) for v in
             ([1, 2, 3, 4, 5, 6], [30, 31, 32, 33, 34, 35], [0, 0, 0, 0, 0, 39])]
    kernels.reset_launch_counts()
    for idx in lanes:
        call(idx)
        assert torch.equal(out, want(idx))
    assert kernels.launch_counts()["gather_rows"] == len(lanes)
    static = lanes[0].clone()
    graph = torch.cuda.CUDAGraph()
    with device_cond.holding() as held, torch.cuda.graph(graph):
        call(static)
    assert len(held) == 1
    for idx in lanes * 2:
        static.copy_(idx)
        graph.replay()
        assert torch.equal(out, want(idx))
    device_cond.clear()


@pytest.fixture(scope="module")
def nccl_mesh(cuda):
    """A 1x1 ``DeviceMesh`` over a one-rank NCCL group on this card."""
    import datetime
    import socket

    import torch.distributed as dist

    from ttamm_torch.ops import device_cond
    from ttamm_torch.parallel import MeshConfig, build_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield build_mesh(MeshConfig(1, 1), "cuda")
    finally:
        device_cond.clear()
        torch.cuda.synchronize()
        dist.destroy_process_group()


@pytest.mark.parametrize("routing,factor", [("allgather", 2.0), ("owner", 2.0), ("owner", 1e-3)],
                         ids=["allgather", "owner", "owner_overflow"])
def test_mesh_replays_equal_eager_steps_bit_for_bit(cuda, nccl_mesh, routing, factor):
    """On a 1x1 NCCL mesh, two ``make_sharded_multi_train_step`` calls of 8
    equal 16 eager sharded steps bit for bit, dropout on (the trainer's
    dropout stream): every leaf, the losses, both generators, the launch
    counts; under the owner routing the device counters count every check,
    and at capacity factor 1e-3 the item table's (a 256-lane buffer
    against ~1,090 distinct rows a step) overflow at every step; the user
    table's 256 lanes fill the smallest buffer and cannot."""
    import copy

    from ttamm_torch.parallel import place_state
    from ttamm_torch.parallel.sparse_update import owner_stats, reset_owner_stats
    from ttamm_torch.parallel.step import make_sharded_multi_train_step, make_sharded_train_step
    from ttamm_torch.pipelines.training import dropout_generator

    cfg, tscfg, state, data, users, items = _multi_case(cuda, False)
    tscfg = tscfg._replace(update_routing=routing, update_capacity_factor=factor)
    eager = place_state(nccl_mesh, state)
    replayed = copy.deepcopy(eager)
    gens = [(torch.Generator(device=cuda).manual_seed(17), dropout_generator(3, nccl_mesh, cuda))
            for _ in range(2)]
    single = make_sharded_train_step(cfg, tscfg, nccl_mesh)
    reset_owner_stats()
    kernels.reset_launch_counts()
    want = torch.stack([single(eager, data, users[k], items[k], generator=gens[0][0],
                               dropout_generator=gens[0][1])[1]["loss"] for k in range(16)])
    torch.cuda.synchronize()
    eager_counts = kernels.launch_counts()
    multi = make_sharded_multi_train_step(cfg, tscfg, nccl_mesh)
    kernels.reset_launch_counts()
    got = torch.cat([multi(replayed, data, users[k : k + 8], items[k : k + 8],
                           generator=gens[1][0], dropout_generator=gens[1][1])[1] for k in (0, 8)])
    torch.cuda.synchronize()
    assert kernels.launch_counts() == eager_counts
    assert torch.equal(got, want)
    a, b = _flat(replayed), _flat(eager)
    for key in b:
        assert torch.equal(a[key], b[key]), key
    for replayed_gen, eager_gen in zip(gens[1], gens[0]):
        assert torch.equal(replayed_gen.get_state(), eager_gen.get_state())
    stats = owner_stats()
    checks = 2 * 16 * 2 if routing == "owner" else 0  # two ways, 16 steps, 2 sparse tables
    assert stats == {"checks": checks, "overflows": 2 * 16 if factor < 1 else 0}


def test_masked_plain_row_forms_in_a_capture_give_their_bits(cuda):
    """The masked plain gather and scatter called on the card inside a CUDA
    graph capture (a check's plain step in a branch graph) take their
    sync-free forms: replayed, the same bits as the eager plain versions."""
    gen = torch.Generator().manual_seed(5)
    table = torch.randn((50, 16), generator=gen).to(cuda)
    # global ids of a shard of rows [10, 60): foreign ids on either side
    ids = torch.tensor([3, -1, 60, 12, 7, 12, -1, 59, 10, 25], dtype=torch.int32, device=cuda)
    lanes = torch.where((ids >= 10) & (ids < 60), ids - 10, -1).to(torch.int32)  # shard-local
    rows = torch.randn((lanes.shape[0], 16), generator=gen).to(cuda)
    rows[5] = rows[3]  # the two lanes of local row 2 carry the same bytes
    want_gather = kernels.gather_rows_plain(table, ids, masked=True, base=10)
    want_table = kernels.scatter_set_rows_plain(table.clone(), lanes, rows, masked=True)
    got_table = table.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_gather = kernels.gather_rows_plain(table, ids, masked=True, base=10)
        kernels.scatter_set_rows_plain(got_table, lanes, rows, masked=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got_gather, want_gather) and torch.equal(got_table, want_table)


def test_the_ragged_exchange_refuses_a_capture(cuda, nccl_mesh):
    """The ragged all-to-all exchange reads its split sizes on the host: in
    a captured step it raises, naming itself; the dense one is captured."""
    from ttamm_torch.parallel import exchange

    table = torch.randn((64, 16), device=cuda)
    ids = torch.randint(0, 64, (32,), dtype=torch.int32, device=cuda)
    want = exchange.exchange_rows(table, ids, nccl_mesh, variant="ragged")
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="ragged"):
        with torch.cuda.graph(graph):
            exchange.exchange_rows(table, ids, nccl_mesh, variant="ragged")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = exchange.exchange_rows(table, ids, nccl_mesh, variant="dense")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
