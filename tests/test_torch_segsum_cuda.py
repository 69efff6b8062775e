"""The CUDA segsum kernel against its plain PyTorch version, on the card.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_segsum_cuda.py
"""

import numpy as np
import pytest
import torch

from diffusionsat_torch.ops import segsum
from diffusionsat_torch.ops.segsum import (
    build_segsum_plan,
    gather_segsum,
    plan_clause_to_lit,
    plan_lit_to_clause,
    segsum_plain,
)

# the plain version sums with index_add_ atomics in no fixed order: the two
# agree to f32 summation order over a few dozen terms of magnitude ~1
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_plan(rng, num_segments, num_sources, max_deg=12):
    deg = rng.integers(0, max_deg + 1, size=num_segments)
    deg[rng.random(num_segments) < 0.2] = 0  # empty segments
    seg = np.repeat(np.arange(num_segments), deg)
    src = rng.integers(0, num_sources, size=seg.size)
    return build_segsum_plan("lit_to_clause", seg, src,
                             np.ones(seg.size, np.float32),
                             num_segments, num_sources)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [128, 1, 6, 130])
def test_kernel_matches_plain(cuda, F):
    rng = np.random.default_rng(F)
    plan = _random_plan(rng, 1000, 700).to(cuda)
    x = torch.from_numpy(rng.normal(size=(700, F)).astype(np.float32))
    x = x.to(cuda)
    before = segsum.LAUNCHES["lit_to_clause"]
    got = gather_segsum(x, plan)
    torch.cuda.synchronize()
    assert segsum.LAUNCHES["lit_to_clause"] == before + 1
    torch.testing.assert_close(got, segsum_plain(x, plan), **TOL)
    empty = plan.row_ptr.diff() == 0
    assert torch.all(got[empty] == 0)


@pytest.mark.cuda
def test_kernel_takes_row_strided_input(cuda):
    rng = np.random.default_rng(1)
    plan = _random_plan(rng, 300, 200).to(cuda)
    wide = torch.from_numpy(rng.normal(size=(200, 256)).astype(np.float32))
    x = wide.to(cuda)[:, :128]  # a column slice: row stride 256
    got = gather_segsum(x, plan)
    torch.testing.assert_close(got, segsum_plain(x.contiguous(), plan), **TOL)


@pytest.mark.cuda
def test_pair_backward_is_other_direction(cuda):
    rng = np.random.default_rng(2)
    C, L = 400, 300
    seg = np.sort(rng.integers(0, C, size=1200))
    src = rng.integers(0, L, size=1200)
    fwd = build_segsum_plan("lit_to_clause", seg, src, np.ones(1200), C, L)
    order = np.argsort(src, kind="stable")
    bwd = build_segsum_plan("clause_to_lit", src[order], seg[order],
                            np.ones(1200), L, C)
    plans = segsum.BatchPlans(fwd, bwd).to(cuda)
    x = torch.randn(L, 128, device=cuda, requires_grad=True)
    g = torch.randn(C, 128, device=cuda)
    (plan_lit_to_clause(x, plans) * g).sum().backward()
    torch.testing.assert_close(x.grad, segsum_plain(g, plans.clause_to_lit),
                               **TOL)
    y = torch.randn(C, 128, device=cuda, requires_grad=True)
    out = plan_clause_to_lit(y, plans)
    torch.testing.assert_close(out, segsum_plain(y.detach(),
                                                 plans.clause_to_lit), **TOL)


@pytest.mark.cuda
def test_backward_counts_launches_and_takes_sliced_cotangents(cuda):
    rng = np.random.default_rng(4)
    C, L = 400, 300
    seg = np.sort(rng.integers(0, C, size=1200))
    src = rng.integers(0, L, size=1200)
    fwd = build_segsum_plan("lit_to_clause", seg, src, np.ones(1200), C, L)
    order = np.argsort(src, kind="stable")
    bwd = build_segsum_plan("clause_to_lit", src[order], seg[order],
                            np.ones(1200), L, C)
    plans = segsum.BatchPlans(fwd, bwd).to(cuda)
    x0 = torch.randn(L, 128, device=cuda)
    w = torch.randn(128, C, device=cuda)
    for loss_of in (lambda o: (o.t() * w).sum(), lambda o: o.sum(),
                    lambda o: (o[:, :64] ** 2).sum() - o[: C // 2].sum()):
        grads = []
        for fn in (lambda x: plan_lit_to_clause(x, plans),
                   lambda x: segsum_plain(x, plans.lit_to_clause)):
            x = x0.clone().requires_grad_(True)
            segsum.reset_launch_counts()
            loss_of(fn(x)).backward()
            grads.append(x.grad)
            launched = dict(segsum.LAUNCHES)
        assert launched == {"lit_to_clause": 0, "clause_to_lit": 0}
        torch.testing.assert_close(grads[0], grads[1], **TOL)
    x = x0.clone().requires_grad_(True)
    segsum.reset_launch_counts()
    plan_lit_to_clause(x, plans).sum().backward()
    # the forward launches its own direction, the backward the other one
    assert segsum.LAUNCHES == {"lit_to_clause": 1, "clause_to_lit": 1}


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(cuda):
    rng = np.random.default_rng(3)
    plan = _random_plan(rng, 10, 8).to(cuda)
    with pytest.raises(TypeError):
        gather_segsum(torch.zeros(8, 4, dtype=torch.float64, device=cuda),
                      plan)
    with pytest.raises(ValueError):
        gather_segsum(torch.zeros(9, 4, device=cuda), plan)
    with pytest.raises(ValueError):  # column stride 8
        gather_segsum(torch.zeros(4, 8, device=cuda).t(), plan)
    with pytest.raises(ValueError):  # plan left on the host
        gather_segsum(torch.zeros(8, 4, device=cuda), plan.to("cpu"))
