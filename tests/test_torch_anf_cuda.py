"""The ANF path on the card: the segsum kernel on ANF plans against its
plain version, the ANFSAT model through the kernel and through the tiles
against the CPU, and the launch counts of an eval round and a train step.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_anf_cuda.py

Tolerances: the kernel against `segsum_plain` 1e-5 (f32 summation order);
the model on the card against the CPU 1e-4 over 2-3 rounds.
"""

import numpy as np
import pytest
import torch

from diffusionsat_torch.data.sha_anf import Sha1AnfInstances
from diffusionsat_torch.graph.anf_batch import ANFBucket, build_anf_batch
from diffusionsat_torch.models.anf_sat import (
    ANFSATConfig,
    anf_sat_apply,
    anf_sat_init,
)
from diffusionsat_torch.ops import segsum, tiled_ops
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.loop import (
    TrainState,
    make_planned_train_step_for,
)

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(feature_maps=32, query_maps=32, train_rounds=3, test_rounds=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(rounds=4, n=3):
    items = list(Sha1AnfInstances(rounds=rounds, min_free_bits=6,
                                  max_free_bits=10, train_size=n,
                                  seed=1).train_generator())
    return build_anf_batch([(v, e) for v, e, _ in items],
                           ANFBucket(2048, 2048, 2048, 8192, 4),
                           solutions=[w[:v] for v, _, w in items])


def _noise(rounds, V):
    return torch.from_numpy(np.random.default_rng(0).normal(
        size=(rounds, V, 4)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [64, 128])
def test_kernel_on_anf_plans_matches_plain(cuda, F):
    plans = segsum.build_anf_plans(_batch()).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(F)
    for name in segsum.ANF_DIRECTIONS:
        plan = getattr(plans, name)
        x = torch.randn((plan.num_sources, F), generator=gen, device=cuda)
        segsum.reset_launch_counts()
        got = segsum.gather_segsum(x, plan)
        torch.cuda.synchronize()
        assert segsum.LAUNCHES[name] == 1
        torch.testing.assert_close(got, segsum.segsum_plain(x, plan), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["planned", "tiled"])
@pytest.mark.parametrize("supervised", [False, True])
def test_model_on_the_card_matches_the_cpu(cuda, route, supervised):
    batch = _batch()
    cfg = ANFSATConfig(**SMALL)
    params = anf_sat_init(torch.Generator().manual_seed(0), cfg)
    kw = {"plans": segsum.build_anf_plans(batch)} if route == "planned" \
        else {"tiles": tiled_ops.build_anf_tiles(batch)}
    labels = batch.solutions if supervised else None
    outs = {}
    for dev in ("cpu", cuda):
        segsum.reset_launch_counts()
        with tiled_ops.tile_precision("highest"):
            logits, loss, _, _ = anf_sat_apply(
                params, cfg, batch, training=False, labels=labels,
                round_noise=_noise(2, batch.V), device=dev, **kw)
        outs[str(dev)] = (logits.cpu(), float(loss), dict(segsum.LAUNCHES))
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], **MODEL_TOL)
    np.testing.assert_allclose(outs["cuda"][1], outs["cpu"][1], rtol=1e-4)
    launched = outs["cuda"][2]
    if route == "planned":
        # a round: the query's value sums, the messages, and (without
        # labels) the unsupervised loss's value sums; one reply; one scatter
        n2c = 2 if supervised else 3
        assert launched == {"lit_to_clause": 0, "clause_to_lit": 0,
                            "node_to_clause": 2 * n2c, "clause_to_node": 2,
                            "and_to_var": 2}
    else:
        assert sum(launched.values()) == 0


@pytest.mark.cuda
def test_flat_train_step_launches_forward_and_backward(cuda):
    batch = _batch()
    cfg = ANFSATConfig(**SMALL)
    params = anf_sat_init(torch.Generator(device=cuda).manual_seed(0), cfg)
    opt = adabelief(learning_rate=1e-3)
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       generator=torch.Generator(device=cuda).manual_seed(1))
    step = make_planned_train_step_for(anf_sat_apply, cfg, opt, device=cuda)
    plans = segsum.build_anf_plans(batch)
    segsum.reset_launch_counts()
    losses = []
    for _ in range(3):
        state, out = step(state, batch.to(cuda), plans)
        losses.append(float(out["loss"]))
    torch.cuda.synchronize()
    r = 3 * cfg.train_rounds
    # per round: 2 node->clause sums forward, again in the recomputation,
    # and 1 as the backward of the reply; the reply forward, recomputed,
    # and as the backward of the 2 sums; the scatter forward, recomputed,
    # and its transpose in the backward
    assert segsum.LAUNCHES == {"lit_to_clause": 0, "clause_to_lit": 0,
                               "node_to_clause": 5 * r,
                               "clause_to_node": 4 * r, "and_to_var": 2 * r,
                               "var_to_and": r}
    assert np.isfinite(losses).all()
