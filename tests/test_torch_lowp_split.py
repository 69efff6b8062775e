"""The f32-accumulating products of `ops/lowp.py` and the split product of
`ops/split_mm.py`, on the CPU: the three-way split is exact, each part's
product with a bf16 value is exact, the split product's plain version is
the upcast product up to the order of its sums, and the wrappers take the
plain route on CPU tensors and count it.

Tolerance of the product comparisons: each of the two products sums the
same K exact f32 products (the split one as 3K parts of them) in f32, in
its own order. The f32 summation bound, K * 2**-24 * sum_k |a_ik||b_kj|
per entry, bounds each one's distance from the exact sum to first order
(the split product's extra terms are each 2**-8 or less of the one they
refine); the comparison holds the two to that bound, and each to the
exact sum in float64 as well.
"""

import numpy as np
import pytest
import torch

from diffusionsat_torch import cuda_graphs, tracing
from diffusionsat_torch.ops import lowp, split_mm

U = 2.0 ** -24
BF16_STEP = 2.0 ** -133     # bf16's smallest subnormal


def _f32_from_bits(bits):
    return torch.from_numpy(np.asarray(bits, dtype=np.uint32)
                            .view(np.float32).copy())


def _normal_values(seed, n=200_000):
    """Random f32 values with every normal exponent, both signs, random
    significands."""
    rng = np.random.default_rng(seed)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    exponent = rng.integers(1, 255, n, dtype=np.uint32) << 23
    significand = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    return _f32_from_bits(sign | exponent | significand)


def _summed(x):
    hi, mid, lo = split_mm.split3(x)
    return hi.double() + mid.double() + lo.double()


def test_the_split_gives_back_every_f32_exactly():
    x = _normal_values(0)
    back = _summed(x)
    # from 2**-110 up the lowest bit of x is one bf16 can hold, so the three
    # parts sum to x exactly; below it, in the normal range's last 16
    # binades, the third part meets bf16's subnormal step
    big = x.abs() >= 2.0 ** -110
    assert big.sum() > 0.9 * x.numel()
    assert torch.equal(back[big], x.double()[big])
    assert (back[~big] - x.double()[~big]).abs().max() <= BF16_STEP
    # the parts: truncations, so each has at most 8 significant bits and
    # none overflows
    for p in split_mm.split3(x):
        assert torch.isfinite(p).all()


@pytest.mark.parametrize("value", [0.0, -0.0, 3.4028234663852886e38,
                                   -3.4028234663852886e38,
                                   1.1754943508222875e-38, 1.0,
                                   -1.0000001192092896])
def test_the_split_of_edge_values(value):
    x = torch.tensor([value], dtype=torch.float32)
    hi, mid, lo = split_mm.split3(x)
    assert torch.equal(_summed(x), x.double())
    # the sign of zero stays with the first part
    assert torch.equal(torch.signbit(hi), torch.signbit(x))
    assert torch.isfinite(hi).all() and torch.isfinite(mid).all()


def test_each_part_times_a_bf16_value_is_exact_in_f32():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(100_000, generator=gen) * torch.exp2(
        torch.randint(-40, 40, (100_000,), generator=gen).float())
    v = (torch.randn(100_000, generator=gen) * torch.exp2(
        torch.randint(-40, 40, (100_000,), generator=gen).float())
         ).to(torch.bfloat16)
    for p in split_mm.split3(x):
        f32 = (p.float() * v.float()).double()
        assert torch.equal(f32, p.double() * v.double())


def _bound(a, b):
    """K * 2**-24 * sum_k |a_ik| |b_kj|, in float64."""
    k = a.shape[-1]
    return k * U * (a.double().abs() @ b.double().abs())


@pytest.mark.parametrize("wide", ["left", "right"])
@pytest.mark.parametrize("shape", [(1, 37, 300, 45), (3, 16, 64, 128),
                                   (5, 33, 17, 130)])
def test_the_plain_split_product_is_the_upcast_product(wide, shape):
    batch, m, k, n = shape
    gen = torch.Generator().manual_seed(batch * 1000 + m)
    a = torch.randn((batch, m, k), generator=gen) * 3
    b = torch.randn((batch, k, n), generator=gen) * 3
    if wide == "left":
        b = b.to(torch.bfloat16)
    else:
        a = a.to(torch.bfloat16)
    upcast = torch.bmm(a.float(), b.float())
    got = split_mm.split_mm_plain(a, b)
    exact = torch.bmm(a.double(), b.double())
    bound = _bound(a, b)
    assert got.dtype == torch.float32
    assert ((got.double() - upcast.double()).abs() <= bound).all()
    assert ((got.double() - exact).abs() <= bound).all()
    assert ((upcast.double() - exact).abs() <= bound).all()
    # 2-d operands, and the result in bf16
    got2 = split_mm.split_mm(a[0], b[0], torch.bfloat16)
    assert torch.equal(got2, got[0].to(torch.bfloat16))


# the card's checks (`tests/test_torch_split_mm_cuda.py`, chip_smoke phase
# 14) hold each product to 32 units of 2**-24 * sum_k |a_ik||b_kj| an
# entry, whatever K: f32 sums of exact products err by a few such units
CARD_UNITS = 32


def test_the_card_bound_parts_f32_sums_from_a_rounding_below_f32():
    """At the train step's longest weight-gradient reduction (24 576 clause
    rows, sliced on the card) the plain split product and the upcast one
    lie within the card's bound; the cotangent rounded to bf16, or the
    kernel's slices' partials rounded to bf16, lie beyond it."""
    gen = torch.Generator().manual_seed(4)
    k = 24_576
    a = torch.randn((k, 48), generator=gen).to(torch.bfloat16).t()
    b = torch.randn((k, 40), generator=gen)
    exact = a.double() @ b.double()
    bound = CARD_UNITS * 2.0 ** -24 * (a.double().abs() @ b.double().abs())

    def within(got):
        return bool(((got.double() - exact).abs() <= bound).all())

    assert within(split_mm.split_mm_plain(a, b))
    assert within(a.float() @ b)
    assert not within(a.double() @ b.to(torch.bfloat16).double())
    p = split_mm.plan(1, 40, 48, k)
    assert p["slices"] > 1
    ks = p["k_slice"]
    partials = sum((a[:, i:i + ks].double() @ b[i:i + ks].double())
                   .to(torch.bfloat16).double() for i in range(0, k, ks))
    assert not within(partials)


def test_split_mm_takes_one_f32_and_one_bf16_operand():
    f32 = torch.ones((2, 3))
    bf = torch.ones((3, 2), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        split_mm.split_mm(f32, f32.t().contiguous())
    with pytest.raises(TypeError):
        split_mm.split_mm(bf.t(), bf)
    with pytest.raises(TypeError):
        split_mm.split_mm(f32.half(), bf)
    with pytest.raises(TypeError):
        split_mm.split_mm(f32, bf, torch.float16)
    with pytest.raises(ValueError):
        split_mm.split_mm(f32, bf[:2])
    with pytest.raises(ValueError):
        split_mm.split_mm(f32[None], bf)
    meta = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError):
        split_mm.split_mm(meta, torch.empty((3, 2), dtype=torch.bfloat16,
                                            device="meta"))


@pytest.mark.parametrize("shape,slices", [
    # a weight's gradient: a few hundred by a few hundred over 16k rows
    ((1, 521, 230, 16_000), 15),
    # an activation's gradient: 16k rows, one wave and more
    ((1, 16_000, 521, 230), 1),
    # the incidence's batched products
    ((512, 12, 128, 40), 1),
    ((4, 40, 128, 12), 1),
])
def test_the_blocks_and_slices_come_from_the_shape(shape, slices):
    batch, m, n, k = shape
    p = split_mm.plan(batch, m, n, k)
    assert p["slices"] == slices
    assert p["BM"] == 64 and p["BN"] in (32, 64, 128)
    # the slices cover the reduction, each a whole number of BK steps and
    # none empty
    assert p["k_slice"] % p["BK"] == 0
    assert (p["slices"] - 1) * p["k_slice"] < k <= p["slices"] * \
        p["k_slice"]
    assert p == split_mm.plan(batch, m, n, k)


def _route_counts(fn):
    before = tracing.counters().get(lowp.ROUTE_FAMILY, {})
    fn()
    after = tracing.counters()[lowp.ROUTE_FAMILY]
    return {k: after[k] - before.get(k, 0) for k in after}


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_cpu_products_take_the_plain_route_and_count_it(needs):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 5, 7), generator=gen).to(torch.bfloat16)
    w = torch.randn((7, 3), generator=gen).to(torch.bfloat16)
    a = torch.randn((4, 6, 5), generator=gen).to(torch.bfloat16)
    b = torch.randn((4, 5, 3), generator=gen).to(torch.bfloat16)
    x.requires_grad_(needs[0])
    w.requires_grad_(needs[1])
    a.requires_grad_(needs[0])
    b.requires_grad_(needs[1])
    backward = sum(needs)

    def run_linear():
        out = lowp.linear_f32acc(x, w)
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, x.float() @ w.float(), rtol=0,
                                   atol=0)
        out.sum().backward()

    def run_bmm():
        out = lowp.bmm_f32acc(a, b)
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, torch.bmm(a.float(), b.float()),
                                   rtol=0, atol=0)
        out.sum().backward()

    for run in (run_linear, run_bmm):
        assert _route_counts(run) == {"tensor_core": 0, "split": 0,
                                      "plain": 1 + backward}
    for t in (x, w, a, b):
        if t.requires_grad:
            assert t.grad.dtype == torch.bfloat16


def test_the_split_kernel_counts_no_launch_on_the_cpu():
    before = dict(split_mm.LAUNCHES)
    split_mm.split_mm(torch.ones((4, 4)), torch.ones((4, 4),
                                                     dtype=torch.bfloat16))
    assert split_mm.LAUNCHES == before


def test_a_replay_span_carries_the_products_by_route():
    graph = cuda_graphs.CapturedGraph(lambda static, gen: None, (),
                                      torch.device("cpu"),
                                      with_generator=False)
    assert graph.replay_attrs(3) == {"replays": 3, "segsum_launches": 0}
    graph.counts = {lowp.ROUTE_FAMILY: {"tensor_core": 7, "split": 12},
                    "segsum.launches": {"lit_to_clause": 2}}
    assert graph.replay_attrs(3) == {
        "replays": 3, "segsum_launches": 6, "lowp_tensor_core": 21,
        "lowp_split": 36}
