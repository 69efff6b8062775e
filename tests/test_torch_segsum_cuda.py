"""The CUDA segsum kernel against its plain PyTorch version, on the card.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_segsum_cuda.py

The kernel sums each column of a segment left to right in plan order, as
the plain version (`torch.segment_reduce` over the same offsets) does, so
the two agree bit for bit: `torch.equal`, at every width the kernel's
lane layouts take (4L columns a pass on the float4 path, L a pass on the
scalar one, L = 1 to 32 lanes a segment), on row-strided and misaligned
inputs, and at segment lengths on each side of the kernel's batches of
rows in flight (3 at a warp a segment, 4 where segments share a warp)
and of a warp's 32 lanes.
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

# the autograd pair's gradients against autograd of the plain version,
# whose backward sums each source row's cotangents in another fixed order
# (`gather_rows`: blocks of rows first on the card): the two agree to f32
# summation order over a few dozen terms of magnitude ~1
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


def _plan_of_lengths(rng, lengths, num_sources):
    lengths = np.asarray(lengths)
    seg = np.repeat(np.arange(lengths.size), lengths)
    src = rng.integers(0, num_sources, size=seg.size)
    return build_segsum_plan("lit_to_clause", seg, src,
                             np.ones(seg.size, np.float32), lengths.size,
                             num_sources)


def _assert_equal(got, want):
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("F", [128, 1, 6, 130, 16, 64, 96, 4, 8, 32, 256])
def test_kernel_matches_plain(cuda, F):
    rng = np.random.default_rng(F)
    plan = _random_plan(rng, 1000, 700).to(cuda)
    x = torch.from_numpy(rng.normal(size=(700, F)).astype(np.float32))
    x = x.to(cuda)
    before = segsum.LAUNCHES["lit_to_clause"]
    got = gather_segsum(x, plan)
    torch.cuda.synchronize()
    assert segsum.LAUNCHES["lit_to_clause"] == before + 1
    _assert_equal(got, segsum_plain(x, plan))
    empty = plan.row_ptr.diff() == 0
    assert torch.all(got[empty] == 0)


@pytest.mark.cuda
def test_kernel_takes_row_strided_input(cuda):
    rng = np.random.default_rng(1)
    plan = _random_plan(rng, 300, 200).to(cuda)
    wide = torch.from_numpy(rng.normal(size=(200, 256)).astype(np.float32))
    x = wide.to(cuda)[:, :128]  # a column slice: row stride 256
    got = gather_segsum(x, plan)
    _assert_equal(got, segsum_plain(x.contiguous(), plan))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [128, 64])
def test_kernel_takes_misaligned_input(cuda, F):
    """A slice that starts one column in: rows not 16-byte aligned, so the
    scalar path."""
    rng = np.random.default_rng(5)
    plan = _random_plan(rng, 300, 200).to(cuda)
    wide = torch.from_numpy(rng.normal(size=(200, F + 4)).astype(
        np.float32))
    x = wide.to(cuda)[:, 1:F + 1]
    _assert_equal(gather_segsum(x, plan), segsum_plain(x.contiguous(), plan))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [128, 64, 16, 6])
def test_kernel_segment_lengths_around_its_batches(cuda, F):
    """Segments of every length from 0 to 70 (each side of the batches
    of 3 and 4 rows and of 32), then one of 1000 edges, in one plan."""
    rng = np.random.default_rng(F + 1)
    lengths = list(range(71)) + [1000, 0, 3]
    plan = _plan_of_lengths(rng, lengths, 500).to(cuda)
    x = torch.from_numpy(rng.normal(size=(500, F)).astype(np.float32))
    x = x.to(cuda)
    got = gather_segsum(x, plan)
    _assert_equal(got, segsum_plain(x, plan))
    assert torch.all(got[0] == 0) and torch.all(got[-2] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 7, 31, 33, 257])
def test_kernel_segment_counts_around_a_warps_groups(cuda, segments):
    """Segment counts that leave a warp's or a block's groups partly
    empty, at one lane a segment (F = 1) and at several."""
    rng = np.random.default_rng(segments)
    for F in (1, 4, 16, 128):
        plan = _random_plan(rng, segments, 50).to(cuda)
        x = torch.randn(50, F, device=cuda)
        _assert_equal(gather_segsum(x, plan), segsum_plain(x, plan))


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
    _assert_equal(x.grad, segsum_plain(g, plans.clause_to_lit))
    y = torch.randn(C, 128, device=cuda, requires_grad=True)
    out = plan_clause_to_lit(y, plans)
    _assert_equal(out, segsum_plain(y.detach(), plans.clause_to_lit))


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
