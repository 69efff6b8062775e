"""The other model family on the card: what the CPU tests cannot reach.

At a small width on a small threshold batch, each model's kernel path
against the kernel's plain version over the same plans and against the
unplanned path (test-mode logits and loss, a training step's loss and
parameter gradients, these also with both paths' segment sums in the
plans' order), and its launches per forward and per step against
`chip_smoke.model_launches`, the count reckoned from the code; and the
second derivative through the kernel against the plain path's.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_models_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from chip_smoke import (
    OTHER_MODELS_ORDERED_GRAD_TOL,
    model_launches,
    plain_version,
    sequential_segment_sums,
)
from diffusionsat_torch.data.bench_workloads import threshold_3sat_batch
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.registry import MODEL_REGISTRY
from diffusionsat_torch.train import loop

MODELS = ("neuro_sat", "neurocore", "simple_neurosat", "query_sat_lit",
          "attention_sat")
WIDTHS = dict(feature_maps=32, query_maps=16, train_rounds=3, test_rounds=4,
              rounds=3)
# the kernel and its plain version sum in plan order: to f32 rounding
SAME_ORDER = dict(rtol=1e-5, atol=1e-5)
# against the unplanned path (another summation order), 3-4 rounds:
# logits to this share of their largest entry, gradients to 1e-2 of each
# tensor's largest entry (floored at a hundredth of the largest of all);
# with both paths' segment sums in the plans' order, the gradients to
# chip_smoke's OTHER_MODELS_ORDERED_GRAD_TOL
LOGIT_SHARE = 2e-3
GRAD_SHARE = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _share(a, b, floor=0.0):
    return (a - b).abs().max().item() / max(b.abs().max().item(), floor,
                                            1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MODELS)
def test_kernel_path_equals_the_plain_paths_and_launches_as_reckoned(
        cuda, name):
    batch, _ = threshold_3sat_batch(np.random.default_rng(0), 3000)
    cls, init, apply = MODEL_REGISTRY.resolve(name)
    plans = segsum.build_batch_plans(
        batch, edges=loop.uses_edge_plans(apply)).to(cuda)
    batch = batch.to(cuda)
    fields = {f.name for f in dataclasses.fields(cls)}
    cfg = cls(**{k: v for k, v in WIDTHS.items() if k in fields})
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    params = init(g, cfg)
    rf = cfg.rounds if "rounds" in fields else cfg.test_rounds
    rt = cfg.rounds if "rounds" in fields else cfg.train_rounds

    def noise(rounds):
        rows = {"query_sat_lit": batch.V, "attention_sat": 2 * batch.V}
        if name not in rows:
            return {}
        g.manual_seed(1)
        return {"round_noise": torch.randn((rounds, rows[name], 4),
                                           generator=g, device=cuda)}

    def forward(p):
        return apply(params, cfg, batch, None, training=False, plans=p,
                     device=cuda, **noise(rf))

    def step(p):
        leaves = [t.detach().requires_grad_(True)
                  for t in pytree.tree_leaves(params)]
        tree = pytree.tree_unflatten(leaves, pytree.tree_structure(params))
        loss = apply(tree, cfg, batch, None, training=True, plans=p,
                     device=cuda, **noise(rt))[1]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss, [torch.zeros_like(t) if gr is None else gr
                      for gr, t in zip(grads, leaves)]

    segsum.reset_launch_counts()
    fk = forward(plans)
    torch.cuda.synchronize()
    launched = {k: v for k, v in segsum.LAUNCHES.items() if v}
    assert launched == model_launches(name, rf, False)
    segsum.reset_launch_counts()
    lk, gk = step(plans)
    torch.cuda.synchronize()
    launched = {k: v for k, v in segsum.LAUNCHES.items() if v}
    assert launched == model_launches(name, rt, True)

    with plain_version():
        fp = forward(plans)
        lp, gp = step(plans)
    torch.testing.assert_close(fk[0], fp[0], **SAME_ORDER)
    torch.testing.assert_close(fk[1], fp[1], **SAME_ORDER)
    torch.testing.assert_close(lk, lp, **SAME_ORDER)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, **SAME_ORDER)

    fu = forward(None)
    lu, gu = step(None)
    assert _share(fk[0], fu[0]) <= LOGIT_SHARE
    assert abs(float(fk[1]) / float(fu[1]) - 1) <= 1e-4
    assert abs(float(lk.detach()) / float(lu.detach()) - 1) <= 1e-4
    floor = max(t.abs().max().item() for t in gu) / 100
    for a, b in zip(gk, gu):
        assert _share(a, b, floor) <= GRAD_SHARE
    assert int(fk[2]) == int(fu[2])

    with sequential_segment_sums():
        (_, gk), (_, gu) = step(plans), step(None)
    floor = max(t.abs().max().item() for t in gu) / 100
    for a, b in zip(gk, gu):
        assert _share(a, b, floor) <= OTHER_MODELS_ORDERED_GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["lit_to_clause", "clause_to_lit",
                                       "edge_to_lit"])
def test_second_derivative_through_the_kernel(cuda, direction):
    """A gradient of a gradient (create_graph=True) through each planned
    sum: the backward launches the kernel with autograd history, so the
    second derivative equals that of the kernel's plain version and, to
    f32 summation order, that of the unplanned sums (before, the kernel's
    output carried none and the second-order term vanished without an
    error)."""
    from diffusionsat_torch.nn.attention import edge_rows_to_lit
    from diffusionsat_torch.ops import graph_ops

    batch, _ = threshold_3sat_batch(np.random.default_rng(1), 2000)
    plans = segsum.build_batch_plans(batch, edges=True).to(cuda)
    batch = batch.to(cuda)
    fn = {"lit_to_clause": segsum.plan_lit_to_clause,
          "clause_to_lit": segsum.plan_clause_to_lit,
          "edge_to_lit": segsum.plan_edge_to_lit}[direction]
    unplanned = {
        "lit_to_clause": lambda x: graph_ops.lit_to_clause(batch, x),
        "clause_to_lit": lambda x: graph_ops.clause_to_lit(batch, x),
        "edge_to_lit": lambda x: edge_rows_to_lit(
            x * batch.edge_mask_c[:, None], batch)}[direction]
    rows = {"lit_to_clause": 2 * batch.V, "clause_to_lit": batch.C,
            "edge_to_lit": batch.E}[direction]
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x0 = torch.randn((rows, 8), generator=g, device=cuda)
    w = torch.randn((rows, 8), generator=g, device=cuda)

    def second(run):
        x = x0.clone().requires_grad_(True)
        y = torch.sum(torch.tanh(run(x)) ** 2)
        gx, = torch.autograd.grad(y, x, create_graph=True)
        h, = torch.autograd.grad(torch.sum(gx * w), x)
        return gx.detach(), h

    segsum.reset_launch_counts()
    gk, hk = second(lambda x: fn(x, plans))
    torch.cuda.synchronize()
    # forward, backward, and the backward's own forward and backward
    assert sum(segsum.LAUNCHES.values()) == 4
    with plain_version():
        gp, hp = second(lambda x: fn(x, plans))
    torch.testing.assert_close(gk, gp, **SAME_ORDER)
    torch.testing.assert_close(hk, hp, **SAME_ORDER)
    gu, hu = second(unplanned)
    torch.testing.assert_close(gk, gu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hk, hu, rtol=1e-4, atol=1e-4)
    assert hk.abs().max().item() > 0
