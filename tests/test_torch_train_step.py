"""Port vs TPU package: the train steps, label selection and the train loop.

One whole step from the same state with the same draws gives the TPU
package's new params: the TPU package's key schedule is replayed (noise scale
and noisy input drawn from its keys and handed to the port's apply), the
per-round noise is zeroed. The bank-row pick is held exactly for an injected
row draw; the draw itself is held statistically.
"""

import functools
import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    assert_batches_equal,
    batch_pair,
    np_of,
    random_formulas,
    torch_params,
)
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.graph import batch as jbatch_mod
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.models.query_sat_dense import (
    query_sat_dense_apply as jdense,
)
from diffusionsat_tpu.ops import pallas_segsum as jseg
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.graph.batch import attach_label_isolation
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import (
    query_sat_dense_apply as tdense,
)
from diffusionsat_torch.ops.segsum import build_batch_plans
from diffusionsat_torch.train.checkpoint import params_to_numpy

jab = importlib.import_module("diffusionsat_tpu.train.adabelief")
tab = importlib.import_module("diffusionsat_torch.train.adabelief")
jloop = importlib.import_module("diffusionsat_tpu.train.loop")
tloop = importlib.import_module("diffusionsat_torch.train.loop")

SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, train_rounds=3,
             test_rounds=3, debug_zero_noise=True)
TILES = dict(tile_edges=64, window=32)


def _bank(formulas, K, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, size=(K, n)).tolist() for n, _ in formulas]


def _bank_pair(K=4, seed=3, n_formulas=4):
    formulas, _ = random_formulas(seed, n_formulas=n_formulas)
    return batch_pair(formulas, _bank(formulas, K, seed))


def _dense_of(jb, tb):
    dims = jdb.dense_dims_for([jb])
    return jdb.dense_from_flat(jb, *dims), tdb.dense_from_flat(tb, *dims)


# -- one whole step ---------------------------------------------------------


@pytest.mark.parametrize("layout", ["flat", "flat_plans", "dense"])
def test_one_step_gives_the_tpu_packages_new_params(layout):
    jcfg, tcfg = jqs.QuerySATConfig(**SMALL), tqs.QuerySATConfig(**SMALL)
    jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
    jb, tb = batch_pair(*random_formulas(1, n_formulas=5))
    lr = dict(initial_lr=1e-2, decay_steps=100, alpha=0.5)
    jopt = jab.adabelief(jab.cosine_decay_schedule(**lr))
    topt = tab.adabelief(learning_rate=tab.cosine_decay_schedule(**lr))
    key = jax.random.key(7)
    jstate = jloop.TrainState(params=jparams, opt_state=jopt.init(jparams),
                              step=jnp.zeros((), jnp.int32), key=key)
    if layout == "dense":
        jbatch, tbatch = _dense_of(jb, tb)
        jstep = jloop.make_train_step_for(jdense, jcfg, jopt)
        jnew, jout = jstep(jstate, jbatch)
    elif layout == "flat_plans":
        jbatch, tbatch = jb, tb
        jstep = jloop.make_planned_train_step(jcfg, jopt)
        jnew, jout = jstep(jstate, jb, jseg.build_batch_plans(jb, **TILES))
    else:
        jbatch, tbatch = jb, tb
        jnew, jout = jloop.make_train_step(jcfg, jopt)(jstate, jb)

    # the TPU package's draws of this step, replayed from its key schedule
    _, subkey = jax.random.split(key)
    k_noise, _, k_input, _ = jax.random.split(subkey, 4)
    ns = jax.random.uniform(k_noise, ())
    noisy = construct_training_input(k_input, jbatch.solutions, ns)
    inject = dict(noise_scale=float(ns),
                  noisy_num=torch.from_numpy(np.array(noisy)))
    tparams = torch_params(jparams)
    tstate = tloop.TrainState(params=tparams, opt_state=topt.init(tparams),
                              step=0, generator=torch.Generator())
    if layout == "dense":
        tstep = tloop.make_train_step_for(
            functools.partial(tdense, **inject), tcfg, topt, "cpu")
        tnew, tout = tstep(tstate, tbatch)
    elif layout == "flat_plans":
        tstep = tloop.make_planned_train_step_for(
            functools.partial(tqs.query_sat_apply, **inject), tcfg, topt,
            device="cpu")
        tnew, tout = tstep(tstate, tb, build_batch_plans(tb))
    else:
        tstep = tloop.make_train_step_for(
            functools.partial(tqs.query_sat_apply, **inject), tcfg, topt,
            "cpu")
        tnew, tout = tstep(tstate, tb)

    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                               rtol=1e-5)
    assert int(tout["steps_taken"]) == int(jout["steps_taken"])
    if "gradnorm" in jout:
        np.testing.assert_allclose(float(tout["gradnorm"]),
                                   float(jout["gradnorm"]), rtol=1e-4)
    assert tnew.step == int(jnew.step) == 1
    assert int(tnew.opt_state.count) == 1
    old = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    got = jax.tree.leaves(params_to_numpy(tnew.params))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jnew.params))
    # a bias in front of a pair norm has gradient zero but for round-off, so
    # updates and moments are held to 1e-3 of the largest entry of all tensors
    moved = max(float(np.abs(w - o).max()) for o, w in zip(old, want))
    assert moved > 1e-5
    for o, g, w in zip(old, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g - o, w - o, rtol=0, atol=1e-3 * moved)
    for name in ("m", "v"):
        t_leaves = jax.tree.leaves(params_to_numpy(getattr(tnew.opt_state,
                                                           name)))
        j_leaves = jax.tree.leaves(jax.tree.map(
            np.asarray, getattr(jnew.opt_state, name)))
        top = max(float(np.abs(w).max()) for w in j_leaves)
        for g, w in zip(t_leaves, j_leaves):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * top)
    # the step is functional: the old state keeps its params
    for a, b in zip(jax.tree.leaves(tstate.params),
                    jax.tree.leaves(torch_params(jparams))):
        assert torch.equal(a, b)


# -- label selection --------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_label_pick_equals_the_tpu_packages_for_an_injected_draw(layout,
                                                                weighted):
    jb, tb = _bank_pair()
    jb = jbatch_mod.attach_label_isolation(jb)
    tb = attach_label_isolation(tb)
    if layout == "dense":
        jb, tb = _dense_of(jb, tb)
    K, G = 4, jb.graph_mask.shape[0]
    alpha = 0.7 if weighted else 0.0
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(jloop._select_labels(jb, key,
                                               isolation_alpha=alpha))
        # the row draw of that key, as the TPU package makes it
        if weighted:
            gum = jax.random.gumbel(key, (K, G))
            kg = np.asarray(jnp.argmax(
                alpha * jb.label_isolation_k + gum, axis=0))
            if layout == "flat":   # the padding segment's extra entry
                kg = np.concatenate([kg, np.zeros(1, kg.dtype)])
        else:
            kg = np.asarray(jax.random.randint(
                key, (G + 1 if layout == "flat" else G,), 0, K))
        got = tloop.pick_labels(tb, torch.from_numpy(kg.astype(np.int64)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np_of(got), want)


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_no_bank_returns_solutions_and_draws_nothing(layout):
    jb, tb = batch_pair(*random_formulas(2))
    if layout == "dense":
        jb, tb = _dense_of(jb, tb)
    g = torch.Generator().manual_seed(0)
    before = g.get_state().clone()
    got = tloop._select_labels(tb, g, isolation_alpha=0.5)
    assert got is tb.solutions
    assert torch.equal(g.get_state(), before)
    np.testing.assert_array_equal(
        np_of(got), np.asarray(jloop._select_labels(jb, jax.random.key(0))))


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_draw_shapes_ranges_and_selected_rows(layout):
    _, tb = _bank_pair(K=5)
    flat = tb
    if layout == "dense":
        tb = tdb.dense_from_flat(tb, *tdb.dense_dims_for([tb]))
    g = torch.Generator().manual_seed(0)
    G = tb.graph_mask.shape[0]
    kg = tloop.draw_label_rows(tb, g)
    assert kg.shape == ((G + 1,) if layout == "flat" else (G,))
    assert int(kg.min()) >= 0 and int(kg.max()) < 5
    labels = tloop._select_labels(tb, g)
    assert labels.shape == tb.solutions.shape
    # every real graph's labels are one of its bank rows
    sk = np_of(tb.solutions_k)
    lab = np_of(labels)
    for gi in range(int(flat.n_graphs)):
        if layout == "flat":
            sel = np_of(flat.var_graph) == gi
            rows, mine = sk[:, sel], lab[sel]
        else:
            rows, mine = sk[:, gi], lab[gi]
        assert any(np.array_equal(mine, r) for r in rows)


def _iso_bank_batch():
    """One 4-var graph and one 3-var graph with a K=4 bank each (the bank of
    tests/test_label_isolation.py)."""
    formulas = [(4, [[1, 2], [-3, 4]]), (3, [[1, -2, 3]])]
    banks = [[[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 1, 1], [1, 1, 1, 0]],
             [[1, 0, 1], [1, 0, 1], [1, 0, 0], [0, 1, 1]]]
    kw = dict(max_vars=16, max_clauses=16, max_edges=64, max_graphs=4)
    return batch_pair(formulas, banks, **kw)


def test_attach_label_isolation_is_exact():
    for jb, tb in (_iso_bank_batch(), _bank_pair(K=6, n_formulas=5)):
        jb = jbatch_mod.attach_label_isolation(jb)
        tb2 = attach_label_isolation(tb)
        assert tb.label_isolation_k is None       # a copy, not in place
        assert_batches_equal(jb, tb2)
        assert tb2.label_isolation_k.dtype == torch.float32
        jd, td = _dense_of(jb, tb2)
        np.testing.assert_array_equal(np.asarray(jd.label_isolation_k),
                                      np_of(td.label_isolation_k))
    _, plain = batch_pair(*random_formulas(0))
    assert attach_label_isolation(plain) is plain  # no bank: unchanged


def test_gumbel_tilt_follows_softmax_of_alpha_iso():
    """Row frequencies follow softmax(alpha * isolation), the check of
    tests/test_label_isolation.py on the port's own draws."""
    _, tb = _iso_bank_batch()
    tb = attach_label_isolation(tb)
    iso = np_of(tb.label_isolation_k)
    g = torch.Generator().manual_seed(0)

    def counts(alpha, n):
        kg = torch.stack([tloop.draw_label_rows(tb, g, alpha)
                          for _ in range(n)])
        assert kg.shape == (n, tb.G + 1)
        if alpha:    # the weighted draw pins the padding segment's entry
            assert int(kg[:, -1].abs().sum()) == 0
        return np.stack([np.bincount(np_of(kg[:, gi]), minlength=4)
                         for gi in range(2)], axis=1).astype(float)

    hot = counts(25.0, 120)
    assert hot[int(np.argmax(iso[:, 0])), 0] >= 110
    for gi in range(2):
        c = counts(1.0, 600)[:, gi]
        p = np.exp(1.0 * iso[:, gi])
        expected = p / p.sum() * c.sum()
        chi2 = ((c - expected) ** 2 / expected).sum()
        assert chi2 < 16.3, (c, expected)       # 3 dof, p = 0.001
    cold = counts(0.0, 800)                     # alpha 0: the uniform draw
    assert np.all(np.abs(cold[:, :2] - 200) < 60)


# -- loss falls -------------------------------------------------------------


def _solved_batch(n_formulas=6, seed=4):
    """A flat batch labelled with true solutions (the solver's)."""
    from diffusionsat_torch.sat.solvers import solve
    from diffusionsat_torch.graph.batch import BucketSpec, build_batch
    formulas, _ = random_formulas(seed, n_formulas=n_formulas, clause_ratio=2)
    sols = []
    for n, clauses in formulas:
        ok, model = solve(clauses, n)
        assert ok
        sols.append([1 if v > 0 else 0 for v in model])
    return build_batch(formulas, BucketSpec(64, 128, 512, 8), solutions=sols)


@pytest.mark.parametrize("layout", ["flat_plans", "flat_plain", "dense",
                                    "dense_bf16", "selfsup_flat",
                                    "selfsup_dense"])
def test_loss_falls_on_a_tiny_batch(layout):
    cfg = tqs.QuerySATConfig(feature_maps=16, query_maps=16, logit_maps=4,
                             train_rounds=2, test_rounds=2,
                             block_bf16=layout == "dense_bf16")
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    opt = tab.adabelief(learning_rate=1e-2)
    state = tloop.TrainState(params=params, opt_state=opt.init(params),
                             step=0,
                             generator=torch.Generator().manual_seed(1))
    flat = _solved_batch()
    dense = tdb.dense_from_flat(flat, *tdb.dense_dims_for([flat]))
    # the loss is normalised per noise level and swings with it, so the
    # supervised steps train at one pinned level (the self-supervised step
    # draws its own)
    flat_apply = functools.partial(tqs.query_sat_apply, noise_scale=0.5)
    if layout == "flat_plans":
        planned = tloop.make_planned_train_step_for(flat_apply, cfg, opt,
                                                    device="cpu")
        plans = build_batch_plans(flat)
        step = lambda s: planned(s, flat, plans)  # noqa: E731
    elif layout == "flat_plain":
        plain = tloop.make_train_step_for(flat_apply, cfg, opt, "cpu")
        step = lambda s: plain(s, flat)  # noqa: E731
    elif layout.startswith("selfsup"):
        is_dense = layout.endswith("dense")
        ss = tloop.make_selfsupervised_train_step(
            cfg, opt, apply_fn=tdense if is_dense else tqs.query_sat_apply,
            device="cpu")
        step = lambda s: ss(s, dense if is_dense else flat)  # noqa: E731
    else:
        ds = tloop.make_train_step_for(
            functools.partial(tdense, noise_scale=0.5), cfg, opt, "cpu")
        step = lambda s: ds(s, dense)  # noqa: E731
    losses = []
    for _ in range(30):
        state, out = step(state)
        assert not out["loss"].requires_grad
        losses.append(float(out["loss"]))
    assert state.step == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < 0.95 * np.mean(losses[:6]), losses
    if layout.startswith("selfsup"):
        np.testing.assert_allclose(
            float(out["loss"]),
            float(out["loss1"]) + 2 * float(out["loss2"]), rtol=1e-5)


@pytest.mark.parametrize("plans_given", [True, False])
@pytest.mark.parametrize("kind", ["train", "planned", "selfsup",
                                  "diagnostics"])
def test_every_flat_step_hands_plans_to_the_model(kind, plans_given):
    """A flat batch never reaches the model without its plans (on the card
    that would take the plain aggregations): each step passes on the plans
    it was given, or builds them from a bare batch."""
    cfg = tqs.QuerySATConfig(feature_maps=16, query_maps=16, logit_maps=4,
                             train_rounds=2, test_rounds=2)
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    opt = tab.adabelief(learning_rate=1e-2)
    state = tloop.TrainState(params=params, opt_state=opt.init(params),
                             step=0,
                             generator=torch.Generator().manual_seed(1))
    flat = _solved_batch()
    given = build_batch_plans(flat) if plans_given else None
    seen = []

    def apply(params, cfg, batch, generator=None, training=False,
              labels=None, noise_scale=None, noisy_num=None,
              denoised_num=None, plans=None, device="cpu"):
        seen.append(plans)
        return tqs.query_sat_apply(
            params, cfg, batch, generator, training=training, labels=labels,
            noise_scale=noise_scale, noisy_num=noisy_num,
            denoised_num=denoised_num, plans=plans, device=device)

    if kind == "train":
        tloop.make_train_step_for(apply, cfg, opt, "cpu")(state, flat, given)
    elif kind == "planned":
        tloop.make_planned_train_step_for(apply, cfg, opt, device="cpu")(
            state, flat, given)
    elif kind == "selfsup":
        tloop.make_selfsupervised_train_step(
            cfg, opt, apply_fn=apply, device="cpu")(state, flat, given)
    else:
        tloop.make_diagnostics_step(cfg, apply, device="cpu")(
            params, flat, torch.Generator().manual_seed(2), plans=given)
    assert len(seen) == (2 if kind == "selfsup" else 1)
    want = build_batch_plans(flat)
    for plans in seen:
        assert plans is not None
        for got, ref in ((plans.lit_to_clause, want.lit_to_clause),
                         (plans.clause_to_lit, want.clause_to_lit)):
            assert torch.equal(got.row_ptr, ref.row_ptr)
            assert torch.equal(got.gather, ref.gather)


# -- the train loop ---------------------------------------------------------


def _fake_step(state, batch):
    return state.replace(step=state.step + 1), {
        "loss": torch.tensor(float(state.step))}


def test_train_stops_exactly_at_target_step(tmp_path):
    """The TPU package checks `target_step` only at log boundaries, so a run
    can overshoot its budget by up to a log window (its ADVICE.md, item 5).
    The port checks after every step."""
    state = tloop.TrainState(params={}, opt_state=None, step=4,
                             generator=None)
    evals, ckpts = [], []
    log = tmp_path / "log.jsonl"
    out = tloop.train(state, _fake_step, iter(range(10 ** 6)), steps=50,
                      log_every=5, target_step=17,
                      eval_fn=lambda s: evals.append(s.step) or {"e": 1.0},
                      eval_every=6, checkpoint_fn=lambda s: ckpts.append(
                          s.step), ckpt_every=4, log_file=log)
    assert out.step == 17
    assert evals == [10, 16] and ckpts == [8, 12, 16]
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    train_recs = [r for r in recs if "loss" in r]
    # two full windows and the window the budget cut short
    assert [r["step"] for r in train_recs] == [9, 14, 17]
    np.testing.assert_allclose(train_recs[0]["loss"], np.mean(range(4, 9)))
    np.testing.assert_allclose(train_recs[-1]["loss"], np.mean([14, 15, 16]))
    assert [r["step"] for r in recs if "e" in r] == [10, 16]
    # already at the budget: no step at all
    again = tloop.train(out, _fake_step, iter(range(10)), steps=5,
                        target_step=17)
    assert again.step == 17
    # no budget: `steps` steps
    assert tloop.train(out, _fake_step, iter(range(10)), steps=5).step == 22


# -- inference is untouched -------------------------------------------------


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_inference_records_no_graph_and_is_unchanged(layout):
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    _, tb = batch_pair(*random_formulas(5))
    batch = tb if layout == "flat" else \
        tdb.dense_from_flat(tb, *tdb.dense_dims_for([tb]))
    apply = tqs.query_sat_apply if layout == "flat" else tdense

    def run(**kw):
        return apply(params, cfg, batch, torch.Generator().manual_seed(3),
                     device="cpu", **kw)

    out = run()
    assert not out[0].requires_grad and not out[1].requires_grad
    assert out[3]["logits_all_heads"].grad_fn is None
    with torch.no_grad():
        ref = run()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    # training records the graph even under the caller's no_grad, and runs
    # train_rounds rounds where inference runs test_rounds
    with torch.no_grad():
        tr = run(training=True)
    assert tr[1].requires_grad
    both = run(training=True, rounds=cfg.test_rounds)
    assert torch.equal(both[1].detach(), ref[1])


def test_diagnostics_step_reports_round_stats_and_grad_norms():
    cfg = tqs.QuerySATConfig(**dict(SMALL, debug_zero_noise=False))
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    flat = _solved_batch()
    dense = tdb.dense_from_flat(flat, *tdb.dense_dims_for([flat]))
    for batch, apply, plans in ((flat, tqs.query_sat_apply,
                                 build_batch_plans(flat)),
                                (dense, tdense, None)):
        diag = tloop.make_diagnostics_step(cfg, apply, device="cpu")
        out = diag(params, batch, torch.Generator().manual_seed(123),
                   plans=plans)
        assert set(out) >= {"diag_loss", "diag_steps", "round/logit_loss",
                            "round/batch_sat", "gradnorm/clause_mlp",
                            "gradnorm/update_gate"}
        assert len(out["round/logit_loss"]) == cfg.train_rounds
        assert all(isinstance(v, (int, float, list)) for v in out.values())
        assert out["gradnorm/lit_mlp"] > 0
        np.testing.assert_allclose(out["diag_loss"],
                                   np.mean(out["round/logit_loss"]),
                                   rtol=1e-4)
        json.dumps(out)
