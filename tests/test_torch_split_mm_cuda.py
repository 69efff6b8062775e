"""The split product's kernel and the f32-accumulating products on the
card: the kernel, its plain version and the upcast f32 product each
within UNITS * 2**-24 * sum_k |a_ik||b_kj| of the exact product, an entry;
the f32 operand rounded to bf16, and a sliced reduction's partials rounded
to bf16, each beyond it; two launches equal bit for bit; the routes
counted; what the card's routes do not take raises.

Tolerance: a sum of K exact products in f32 errs by a few units of 2**-24
of the sum of their magnitudes whatever K is, since its roundings fall on
partial sums of random sign; the kernel's tensor-core accumulation, which
truncates, read up to 16.6 such units over the dense train step's shapes,
the upcast cuBLAS product up to 11.3. A bf16 rounding of the f32 operand
(2**-8 of each term at most, of random sign) reads about 2**15 / sqrt(K)
units: 200 at the longest reduction of the train step (K = 24 576), far
more at short ones.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_split_mm_cuda.py
"""

import pytest
import torch

from diffusionsat_torch import tracing
from diffusionsat_torch.ops import lowp, split_mm

UNITS = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bound(a, b):
    return UNITS * 2.0 ** -24 * (a.double().abs() @ b.double().abs())


def _within_bound(got, want, a, b):
    return ((got.double() - want.double()).abs() <= _bound(a, b)).all(
    ).item()


def _within_bf16(got, want, a, b):
    """bf16 `got` against the bf16 rounding of the exact `want`: the value
    rounded lies within the bound of `want`, so the two roundings lie
    within it and one bf16 step (up to 2**-7 of the value)."""
    ref = want.to(torch.bfloat16).double()
    tol = want.double().abs() * 2.0 ** -7 + 2 * _bound(a, b)
    return ((got.double() - ref).abs() <= tol).all().item()


# (batch or None, m, k, n, which operand is f32, transposed layouts)
SHAPES = [
    (None, 3000, 230, 521, "left", True),    # an activation's gradient
    (None, 521, 16000, 230, "right", True),  # a weight's gradient, sliced
    (None, 137, 2500, 153, "right", True),
    (512, 12, 40, 128, "right", True),       # the incidence's gradient
    (512, 40, 12, 128, "right", False),
    (64, 33, 136, 128, "left", False),
    (None, 17, 9, 5, "left", False),
    (None, 4608, 8, 128, "left", False),     # the logits layer's gradient
    (None, 512, 24576, 521, "right", True),  # the longest weight gradient
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_the_kernel_is_the_f32_product(cuda, shape, out_dtype):
    batch, m, k, n, wide, transposed = shape
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + k)
    lead = () if batch is None else (batch,)
    if transposed:
        a = torch.randn(lead + (k, m), generator=gen, device=cuda)
        a = a.transpose(-1, -2)
    else:
        a = torch.randn(lead + (m, k), generator=gen, device=cuda)
    b = torch.randn(lead + (k, n), generator=gen, device=cuda)
    if wide == "left":
        b = b.to(torch.bfloat16)
    else:
        a = a.to(torch.bfloat16)
    got = split_mm.split_mm(a, b, out_dtype)
    again = split_mm.split_mm(a, b, out_dtype)
    plain = split_mm.split_mm_plain(a, b)
    upcast = a.float() @ b.float()
    exact = a.double() @ b.double()
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == upcast.shape
    assert torch.equal(got, again)
    # the kernel, its plain version and the upcast product each sum the
    # same exact products in f32: each lies within the bound of the exact
    # sum
    assert _within_bound(plain, exact, a, b)
    assert _within_bound(upcast, exact, a, b)
    if out_dtype == torch.float32:
        assert _within_bound(got, exact, a, b)
    else:
        assert _within_bf16(got, exact, a, b)


@pytest.mark.cuda
def test_what_the_card_does_not_take_raises(cuda):
    bf = torch.ones((4, 4), dtype=torch.bfloat16, device=cuda)
    f32 = torch.ones((4, 4), device=cuda)
    with pytest.raises(TypeError):
        split_mm.split_mm(bf, bf)
    with pytest.raises(TypeError):
        split_mm.split_mm(f32, f32)
    with pytest.raises(TypeError):
        split_mm.split_mm(f32.half(), bf)
    with pytest.raises(TypeError):
        lowp.linear_f32acc(f32, bf)
    with pytest.raises(TypeError):
        lowp.bmm_f32acc(bf[None], f32[None])
    with pytest.raises(ValueError):
        lowp.linear_f32acc(bf, bf.cpu())


@pytest.mark.cuda
def test_the_card_routes_are_counted(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((300, 137), generator=gen, device=cuda
                    ).to(torch.bfloat16).requires_grad_()
    w = torch.randn((137, 153), generator=gen, device=cuda
                    ).to(torch.bfloat16).requires_grad_()
    before = tracing.counters()
    out = lowp.linear_f32acc(x, w)
    out.square().sum().backward()
    moved = tracing.changes_since(before)
    assert moved[lowp.ROUTE_FAMILY] == {"tensor_core": 1, "split": 2}
    assert moved["split_mm.launches"]["product"] == 2
    assert out.dtype == torch.float32
    assert _within_bound(out, x.double() @ w.double(), x, w)
    g = 2 * out.detach()
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    assert _within_bf16(w.grad, x.double().t() @ g.double(), x.t(), g)
    assert _within_bf16(x.grad, g.double() @ w.double().t(), g, w.t())


@pytest.mark.cuda
def test_a_rounding_below_f32_lies_beyond_the_bound(cuda):
    """At the train step's longest weight gradient (the clause MLP's first
    layer, reduced over 24 576 clause rows, sliced): the kernel lies within
    the bound; the cotangent rounded to bf16, and the slices' partials
    rounded to bf16, do not."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((24576, 204), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    g = torch.randn((24576, 128), generator=gen, device=cuda)
    a, b = x.t(), g
    p = split_mm.plan(1, 128, 204, 24576)
    assert p["slices"] > 1
    exact = a.double() @ b.double()
    got = split_mm.split_mm(a, b)
    assert _within_bound(got, exact, a, b)
    assert not _within_bound(a.double() @ b.to(torch.bfloat16).double(),
                             exact, a, b)
    ks = p["k_slice"]
    partials = sum((a[:, i:i + ks].double() @ b[i:i + ks].double())
                   .to(torch.bfloat16).double()
                   for i in range(0, 24576, ks))
    assert not _within_bound(partials, exact, a, b)
