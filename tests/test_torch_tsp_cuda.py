"""The TSP stack and a hyperparameter trial on the card: what the CPU
tests cannot reach.

At a small width, the TSP model on the card against the same params and
batch on the CPU (logits, losses and parameter gradients of both cores,
supervised, with the subtour cuts and with the `fast_inaccurate` penalty),
a training step that repeats bit for bit (the cut sums are fixed-order),
and one tiny hyperparameter trial whose launches equal
`chip_smoke.hyperopt_launches` and whose first step through the kernel
equals that through the kernel's plain version over the same plans.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_tsp_cuda.py
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from chip_smoke import hyperopt_launches, plain_version
from diffusionsat_torch import hyperopt
from diffusionsat_torch.data.datasets import SatDataset
from diffusionsat_torch.data.generators import (
    DiffusionSatInstances,
    SAT3Instances,
)
from diffusionsat_torch.graph.batch import BucketSpec
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.tsp.data import EuclideanTSP
from diffusionsat_torch.tsp.loss import tsp_loss
from diffusionsat_torch.tsp.model import (
    TSPMatrixSEConfig,
    tsp_matrix_se_apply,
    tsp_matrix_se_init,
)

# card against CPU, f32 with TF32 off: logits and losses to this share of
# their largest entry, gradients to 1e-4 of each tensor's largest entry
# (floored at a hundredth of the largest of all)
SHARE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _share(a, b, floor=0.0):
    return (a - b).abs().max().item() / max(b.abs().max().item(), floor,
                                            1e-30)


def _loss_and_grads(params, cfg, adj, labels, dev, fast):
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().to(dev).requires_grad_(True) for p in leaves]
    tree = pytree.tree_unflatten(leaves, spec)
    logits, total, _ = tsp_matrix_se_apply(tree, cfg, adj, labels,
                                           training=not fast, device=dev)
    if fast:
        total = tsp_loss(logits, adj.to(dev), fast_inaccurate=True)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return logits.detach(), total.detach(), [
        torch.zeros_like(p) if g is None else g
        for g, p in zip(grads, leaves)]


@pytest.mark.cuda
@pytest.mark.parametrize("matrix_se", [False, True],
                         ids=["dense_gnn", "matrix_se"])
@pytest.mark.parametrize("mode", ["cuts", "supervised", "fast"])
def test_tsp_model_on_the_card_equals_the_cpu(cuda, matrix_se, mode):
    batch = next(EuclideanTSP(min_node_count=6, max_node_count=8,
                              padded_size=8, train_size=4
                              ).batches("train", 4))
    adj = torch.from_numpy(batch["adj_matrix"])
    labels = torch.from_numpy(batch["labels"])
    cfg = TSPMatrixSEConfig(feature_maps=16, rounds=3,
                            use_matrix_se=matrix_se,
                            supervised=mode == "supervised",
                            n_vertices_prior=8)
    params = tsp_matrix_se_init(torch.Generator().manual_seed(0), cfg)
    fast = mode == "fast"
    lc, tc, gc = _loss_and_grads(params, cfg, adj, labels, cuda, fast)
    lh, th, gh = _loss_and_grads(params, cfg, adj, labels, "cpu", fast)
    assert _share(lc.cpu(), lh) <= SHARE
    assert abs(float(tc) / float(th) - 1) <= SHARE
    floor = max(g.abs().max().item() for g in gh) / 100
    for a, b in zip(gc, gh):
        assert _share(a.cpu(), b, floor) <= SHARE
    # the same step again on the card: bit for bit
    lc2, tc2, gc2 = _loss_and_grads(params, cfg, adj, labels, cuda, fast)
    assert torch.equal(lc, lc2) and torch.equal(tc, tc2)
    for a, b in zip(gc, gc2):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_hyperopt_trial_on_the_kernel(cuda, tmp_path):
    ds = SatDataset(
        DiffusionSatInstances(SAT3Instances(min_vars=3, max_vars=10,
                                            train_size=60, test_size=20,
                                            seed=0), use_unigen=True,
                              seed=0),
        BucketSpec.for_node_budget(600), cache_dir=tmp_path,
        name="hyperopt_3_10", gen_workers=1)
    hp = hyperopt.TPESampler(hyperopt.SPACE, seed=1).suggest()
    train, test = hyperopt.plan_dataset(ds, cuda)
    segsum.reset_launch_counts()
    cfg, state, losses = hyperopt.train_trial(hp, train, 2, 0, cuda)
    score = hyperopt.score_trial(state.params, cfg, test, cuda)
    torch.cuda.synchronize()
    n_eval = min(hyperopt.EVAL_BATCHES, len(test))
    assert dict(segsum.LAUNCHES) == hyperopt_launches(cfg, 2, n_eval)
    assert 0.0 <= score <= 1.0 and np.isfinite([float(x) for x in losses]).all()
    _, _, (first_k,) = hyperopt.train_trial(hp, train, 1, 0, cuda)
    with plain_version():
        _, _, (first_p,) = hyperopt.train_trial(hp, train, 1, 0, cuda)
    assert float(first_k) == float(first_p)
