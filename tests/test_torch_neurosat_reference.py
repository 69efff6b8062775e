"""The port's NeuroSAT against the benchmark's plain reference
(`portbench/reference/neurosat-3sat-128.py`) on the CPU, on seeded random
weights at 16 maps and 4-6 rounds: each round's loss, the logits, every
parameter gradient, and three AdaBelief steps.

The reference sums with `index_add_` over the formulas' own edges; the
port sums over padded rows in its plans' order. Both are f32, so they
differ by round-off alone: about 1e-7 of a value here, which the
tolerances below hold to within 20x.
"""

import numpy as np
import pytest
import torch

from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.models import neuro_sat as ns
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.loop import (
    TrainState,
    build_plans,
    make_train_step_for,
)
from portbench import harness

ref = harness.load_module("reference", "neurosat-3sat-128")
BUCKET = BucketSpec(128, 512, 2048, 8)
# f32 round-off of two summation orders, relative: measured up to 5.3e-7
# (logits, of their largest entry), 1.6e-7 (a round's loss) and 1.7e-7
# (a gradient, of its tensor's largest entry) over 8 draws
RTOL = 1e-5


def _cfg(rounds):
    return dict(feature_maps=16, msg_layers=3, vote_layers=3, rounds=rounds)


def _formulas(seed, k=6, positive=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(4, 12))
        out.append((n, [[int(v) * (1 if positive or rng.random() < 0.5
                                   else -1)
                         for v in rng.choice(n, 3, replace=False) + 1]
                        for _ in range(int(4.26 * n))]))
    return out


def _port_forward(params, cfg, formulas):
    """(loss, logits of the real variables, each round's loss, rounds taken
    as the reference counts them), through the port's planned path."""
    batch = build_batch(formulas, BUCKET)
    recorded = []
    orig = ns.softplus_log_square_loss

    def recording(*a, **kw):
        out = orig(*a, **kw)
        recorded.append(out.sum().detach())
        return out
    ns.softplus_log_square_loss = recording
    try:
        logits, loss, steps, _ = ns.neuro_sat_apply(
            params, ns.NeuroSATConfig(**cfg), batch, None, training=True,
            plans=build_plans(batch, pad=True), device="cpu")
    finally:
        ns.softplus_log_square_loss = orig
    V = sum(n for n, _ in formulas)
    return loss, logits[:V], recorded, int(steps) + 1


def _leaves(cfg, seed):
    return {k: v.requires_grad_(True) for k, v in
            ref.flatten(ref.init_params(cfg, seed, "cpu"))}


def _assert_close(a, b, what):
    a, b = a.detach(), b.detach()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    assert err <= RTOL * max(scale, 1e-30), (what, err, scale)


@pytest.mark.parametrize("rounds,seed", [(4, 0), (5, 1), (6, 2)])
def test_forward_and_gradients_equal_the_reference(rounds, seed):
    cfg = _cfg(rounds)
    formulas = _formulas(seed)
    pp, rp = _leaves(cfg, 100 + seed), _leaves(cfg, 100 + seed)
    loss, logits, per_round, taken = _port_forward(ref.unflatten(pp), cfg,
                                                   formulas)
    rloss, rlogits, rper, rtaken = ref.forward(
        ref.unflatten(rp), cfg, ref.build_graph(formulas, "cpu"), rounds)
    # an untrained batch runs every round
    assert taken == rtaken == rounds == len(per_round)
    assert float(loss.detach()) == pytest.approx(float(rloss.detach()),
                                                 rel=RTOL)
    for a, b in zip(per_round, rper):
        assert float(a) == pytest.approx(float(b.detach()), rel=RTOL)
    _assert_close(logits, rlogits, "logits")
    grads = torch.autograd.grad(loss, list(pp.values()))
    rgrads = torch.autograd.grad(rloss, list(rp.values()))
    for key, g, rg in zip(pp, grads, rgrads):
        _assert_close(g, rg, key)


def test_a_solved_batch_freezes_as_in_the_reference():
    """Formulas of positive literals and a vote biased to true: the first
    round satisfies every clause with a loss near 0, so the states, the
    loss and the rounds taken freeze after it in both."""
    cfg = _cfg(5)
    formulas = _formulas(7, positive=True)
    pp, rp = _leaves(cfg, 3), _leaves(cfg, 3)
    for leaves in (pp, rp):
        with torch.no_grad():
            leaves["L_vote/b/2"].fill_(30.0)
    loss, logits, per_round, taken = _port_forward(ref.unflatten(pp), cfg,
                                                   formulas)
    rloss, rlogits, rper, rtaken = ref.forward(
        ref.unflatten(rp), cfg, ref.build_graph(formulas, "cpu"), 5)
    assert taken == rtaken == 1
    assert float(rper[0].detach()) < 0.5
    assert float(loss.detach()) == pytest.approx(float(rloss.detach()),
                                                 rel=RTOL, abs=1e-30)
    _assert_close(logits, rlogits, "logits")
    grads = torch.autograd.grad(loss, list(pp.values()), allow_unused=True)
    rgrads = torch.autograd.grad(rloss, list(rp.values()),
                                 allow_unused=True)
    for key, g, rg in zip(pp, grads, rgrads):
        if rg is None:
            assert g is None or not g.any(), key
        else:
            _assert_close(g, rg, key)


def test_three_adabelief_steps_equal_the_reference():
    """Three steps on three batches from one seeded state: each step's
    loss and, after the third, every parameter's change (the change is
    lr-sized, so it is held to its own scale)."""
    cfg = _cfg(4)
    lr = 3e-4
    batches = [_formulas(20 + i) for i in range(3)]
    p0 = ref.init_params(cfg, 11, "cpu")
    opt = adabelief(learning_rate=lr, eps=1e-8, clip_gradients=True)
    step = make_train_step_for(ns.neuro_sat_apply, ns.NeuroSATConfig(**cfg),
                               opt, "cpu")
    params = ref.unflatten({k: v.clone() for k, v in ref.flatten(p0)})
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       generator=torch.Generator())
    losses = []
    for fs in batches:
        state, out = step(state, build_batch(fs, BUCKET))
        losses.append(float(out["loss"]))
    rlosses, _, _, rp_end = ref.train_steps(
        p0, cfg, [ref.build_graph(fs, "cpu") for fs in batches],
        ref.AdaBelief(learning_rate=lr))
    assert losses == pytest.approx(rlosses, rel=RTOL)
    start = dict(ref.flatten(p0))
    for key, v in ref.flatten(state.params):
        _assert_close(v - start[key], rp_end[key] - start[key], key)
