"""Port vs TPU package: the other model family's forward passes.

NeuroSAT, NeuroCore, SimpleNeuroSAT (and its registry alias), QuerySATLit
and AttentionSAT, each resolved from both packages' registries, run on the
same numpy-seeded formulas with the TPU package's initial parameters
carried across, in training and in test mode, at 3-4 rounds and width 16.
QuerySATLit and AttentionSAT draw per-round noise from a key in the TPU
package; the port is handed the same draws (`round_noise`), the key
schedule replayed. Each port model runs without plans (the plain sums of
`ops/graph_ops.py`) and with its `BatchPlans` (the kernel's plain version
on CPU tensors).

Tolerances (f32): logits to 1e-5 absolute and relative, the loss to 1e-5
relative; `steps_taken` and `solved` equal. NeuroCore and SimpleNeuroSAT
standardize each feature over rows that start out equal (every literal
and every clause row has the same initial state, and only the padding
rows and the degrees set them apart), which is ill-conditioned in f32: at
3 rounds the TPU package's logits lie 3.4e-5 from a float64 run of the
port (products included) and the port's f32 ones 1.3e-5, so their logits
and loss are held to 1e-4. (On a batch without padding rows whose clauses all have three
literals the rows stay equal: the standardized states are 0 in exact
arithmetic and f32 rounding noise times 1e3 in either package, so no
batch here is packed tight.) The plain and the planned port paths sum
every aggregation in the same order, so they agree bit for bit.
"""


import numpy as np
import pytest
import torch

import jax

from _torch_parity import (
    MODELS,
    MOMENTS_MODELS,
    batch_pair,
    model_configs,
    np_of,
    random_formulas,
    replay_round_noise,
    rounds_of,
    torch_params,
)
from diffusionsat_torch.models import neurocore as tnc
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.ops.segsum import build_batch_plans
from diffusionsat_torch.registry import MODEL_REGISTRY
from diffusionsat_torch.train import loop

FWD = dict(rtol=1e-5, atol=1e-5)
MOMENTS_FWD = dict(rtol=1e-4, atol=1e-4)

# formulas of one or two clauses, which the rounded logits of a fresh model
# often satisfy: the early exit by masking is taken on these
EASY = ([(3, [[1, 2, 3]]), (4, [[-1, 2, 4], [3, -4, 1]]), (3, [[-2, 3, 1]])],
        [[1, 1, 0], [0, 1, 1, 1], [1, 1, 0]])


def run_both(name, batches, training, seed=0, plans=False, **kw):
    """(TPU-package outputs, port outputs) of one apply."""
    jcfg, tcfg, (jinit, _), (japply, tapply) = model_configs(name, **kw)
    jb, tb = batches
    jparams = jinit(jax.random.key(seed), jcfg)
    key = jax.random.key(seed + 7)
    jout = japply(jparams, jcfg, jb, key, training=training)
    noise = replay_round_noise(name, key, rounds_of(jcfg, training), jb.V)
    tout = tapply(torch_params(jparams), tcfg, tb, None, training=training,
                  plans=build_batch_plans(
                      tb, edges=loop.uses_edge_plans(tapply))
                  if plans else None,
                  device="cpu", **noise)
    return jout, tout


def forward_tol(name):
    return MOMENTS_FWD if name in MOMENTS_MODELS else FWD


def assert_outputs_equal(jout, tout, tol=FWD):
    (jl, jloss, jsteps, jaux), (tl, tloss, tsteps, taux) = jout, tout
    assert tl.shape == jl.shape
    np.testing.assert_allclose(np_of(tl), np.asarray(jl), **tol)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol["rtol"])
    assert int(tsteps) == int(jsteps)
    assert bool(taux["solved"]) == bool(jaux["solved"])


@pytest.fixture(scope="module")
def random_batch():
    return batch_pair(*random_formulas(3, n_formulas=4))


@pytest.fixture(scope="module")
def easy_batch():
    return batch_pair(*EASY, max_vars=16, max_clauses=8, max_edges=32,
                      max_graphs=4)


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_equals_the_tpu_package(name, training, random_batch):
    jout, tout = run_both(name, random_batch, training)
    assert_outputs_equal(jout, tout, forward_tol(name))


@pytest.mark.parametrize("name", MODELS)
def test_early_exit_by_masking_equals_the_tpu_package(name, easy_batch):
    """The easy batch at 6 rounds, through the plans: the rounds after the
    batch is solved change nothing, as in the TPU package."""
    outs = [run_both(name, easy_batch, False, seed=s, plans=True, rounds=6,
                     test_rounds=6) for s in range(3)]
    for jout, tout in outs:
        assert_outputs_equal(jout, tout, forward_tol(name))
    # at least one seed solves the batch before its last round
    assert any(bool(j[3]["solved"]) and int(j[2]) < 5 for j, _ in outs)


@pytest.mark.parametrize("name", MODELS)
def test_planned_path_equals_the_plain_path(name, random_batch):
    _, tb = random_batch
    _, tcfg, (_, tinit), (_, tapply) = model_configs(name)
    g = torch.Generator()
    g.manual_seed(0)
    params = tinit(g, tcfg)
    outs = []
    edges = loop.uses_edge_plans(tapply)
    for plans in (None, build_batch_plans(tb, edges=edges),
                  build_batch_plans(tb, pad=True, edges=edges)):
        g.manual_seed(5)
        outs.append(tapply(params, tcfg, tb, g, training=True, plans=plans,
                           device="cpu"))
    for out in outs[1:]:
        assert torch.equal(out[0], outs[0][0])
        assert torch.equal(out[1], outs[0][1])
        assert torch.equal(out[2], outs[0][2])


@pytest.mark.parametrize("name", MODELS + ("query_sat",))
def test_only_graph_attention_plans_the_edges(name, random_batch):
    """The edge plans are built for AttentionSAT's batches alone: the other
    models' plans (QuerySAT's included) carry the literal-clause pair."""
    _, tb = random_batch
    apply = MODEL_REGISTRY.resolve(name)[2]
    edges = loop.uses_edge_plans(apply)
    assert edges == (name == "attention_sat")
    (_, plans), = loop.plan_batches([tb], "cpu", edges)
    assert (plans.edge_to_lit is not None) == edges
    assert (plans.lit_to_edge is not None) == edges
    assert (loop.build_plans(tb, edges=edges).edge_to_lit is not None) == \
        edges


@pytest.mark.parametrize("name", [m for m in MODELS
                                  if m != "simple_neuro_sat"])
def test_planned_sums_as_reckoned(name, random_batch):
    """The planned sums of one forward and of one training step, counted
    at the wrapper that launches the kernel on the card, equal the count
    `chip_smoke.py` reckons from the code."""
    from chip_smoke import model_launches

    _, tb = random_batch
    _, tcfg, (_, tinit), (_, tapply) = model_configs(name)
    g = torch.Generator()
    g.manual_seed(0)
    params = tinit(g, tcfg)
    plans = build_batch_plans(tb, edges=loop.uses_edge_plans(tapply))
    calls = {}
    kernel = segsum.gather_segsum

    def counting(x, plan):
        calls[plan.name] = calls.get(plan.name, 0) + 1
        return kernel(x, plan)

    segsum.gather_segsum = counting
    try:
        tapply(params, tcfg, tb, g, training=False, plans=plans,
               device="cpu")
        forward = dict(calls)
        calls.clear()
        tree, leaves, spec = loop._grad_leaves(params)
        loss = tapply(tree, tcfg, tb, g, training=True, plans=plans,
                      device="cpu")[1]
        loss.backward()
    finally:
        segsum.gather_segsum = kernel
    assert forward == model_launches(name, rounds_of(tcfg, False), False)
    assert calls == model_launches(name, rounds_of(tcfg, True), True)


def test_simple_neurosat_diagnostics_equal_the_tpu_package(random_batch):
    """The diagnostics forward: the query statistics at rounds 0, 16 and
    the last active one, and the per-round agreement of the queries. At 4
    rounds "16" is round 3, the last (the test below reads round 16 of a
    longer run)."""
    from diffusionsat_tpu.models import neurocore as jnc

    jcfg = jnc.SimpleNeuroSATConfig(feature_maps=16, test_rounds=4,
                                    diagnostics=True)
    tcfg = tnc.SimpleNeuroSATConfig(feature_maps=16, test_rounds=4,
                                    diagnostics=True)
    jb, tb = random_batch
    jparams = jnc.neurocore_init(jax.random.key(2), jcfg)
    jout = jnc.neurocore_apply(jparams, jcfg, jb, jax.random.key(0),
                               training=False)
    tout = tnc.neurocore_apply(torch_params(jparams), tcfg, tb,
                               training=False, plans=build_batch_plans(tb),
                               device="cpu")
    assert_outputs_equal(jout, tout, MOMENTS_FWD)
    jstats, tstats = jout[3]["query_stats"], tout[3]["query_stats"]
    assert set(tstats) == set(jstats) == {"0", "16", "last"}
    for at in jstats:
        assert set(tstats[at]) == set(jstats[at])
        for k, v in jstats[at].items():
            np.testing.assert_allclose(float(tstats[at][k]), float(v),
                                       **MOMENTS_FWD, err_msg=f"{at}/{k}")
    np.testing.assert_allclose(np_of(tout[3]["queries_diff"]),
                               np.asarray(jout[3]["queries_diff"]),
                               **MOMENTS_FWD)


def test_simple_neurosat_diagnostics_read_round_16(random_batch):
    """Over 18 rounds "16" holds round 16's statistics: those of the last
    round of a 17-round run (no round solves this batch)."""
    _, tb = random_batch
    cfg = tnc.SimpleNeuroSATConfig(feature_maps=16, diagnostics=True)
    g = torch.Generator()
    g.manual_seed(0)
    params = tnc.neurocore_init(g, cfg)
    runs = {r: tnc.neurocore_apply(params, cfg, tb, rounds=r, device="cpu")
            for r in (17, 18)}
    assert int(runs[17][2]) == 16 and int(runs[18][2]) == 17
    assert runs[18][3]["queries_diff"].shape == (18,)
    for k, v in runs[17][3]["query_stats"]["last"].items():
        assert torch.equal(runs[18][3]["query_stats"]["16"][k], v), k


def test_moments_normalize_equals_the_tpu_package():
    from diffusionsat_tpu.models import neurocore as jnc

    x = np.random.default_rng(0).normal(size=(40, 12)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tnc.moments_normalize(torch.from_numpy(x))),
        np.asarray(jnc.moments_normalize(x)), **FWD)


def test_zero_state_and_literal_pair_norm_equal_the_tpu_package(
        random_batch):
    from diffusionsat_tpu.models import query_sat_lit as jql
    from diffusionsat_torch.models import query_sat_lit as tql

    jb, tb = random_batch
    np.testing.assert_allclose(np_of(tql._zero_state(7, 16, "cpu")),
                               np.asarray(jql._zero_state(7, 16)), **FWD)
    x = np.random.default_rng(1).normal(size=(2 * jb.V, 9)).astype(
        np.float32)
    np.testing.assert_allclose(
        np_of(tql._pair_norm_literals(torch.from_numpy(x), tb)),
        np.asarray(jql._pair_norm_literals(x, jb)), **FWD)


@pytest.mark.parametrize("name", [m for m in MODELS
                                  if m != "simple_neuro_sat"])
def test_params_files_carry_every_parameter_kind_both_ways(name, tmp_path):
    """The LSTM cells, the 0-d scales, the attention's MLPs and the norm
    bias: a file the TPU package writes loads into the port's tree (the
    init's shapes and order), and the port's own params written back load
    in the TPU package, value for value."""
    import jax.tree_util as jtu

    from diffusionsat_tpu.train import checkpoint as jckpt
    from diffusionsat_torch.train import checkpoint as tckpt

    jcfg, tcfg, (jinit, tinit), _ = model_configs(name)
    jparams = jinit(jax.random.key(3), jcfg)
    jckpt.export_params(jparams, tmp_path / "j.npz", meta={"model": name})
    tree, meta = tckpt.load_params(tmp_path / "j.npz")
    template = tinit(torch.Generator().manual_seed(0), tcfg)
    params = tckpt.params_like(template, tckpt.params_from_numpy(tree,
                                                                "cpu"))
    assert meta == {"model": name}
    assert list(params) == list(template)
    tckpt.export_params(params, tmp_path / "t.npz", meta=meta)
    back, _ = jckpt.load_params(tmp_path / "t.npz")
    want = jtu.tree_leaves_with_path(jax.tree.map(np.asarray, jparams))
    got = dict(jtu.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jtu.keystr(path))
    for leaf in jax.tree.leaves(tckpt.params_to_numpy(params)):
        assert isinstance(leaf, np.ndarray)
