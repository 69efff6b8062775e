"""Port vs TPU package: the tiled block-sparse incidence layout.

The tile builds are host numpy and must equal the TPU package's: every real
tile (blocks, row and column block) bit for bit, the column blocks whole.
Its padding tiles point at row block 0 after the ascending real tiles
(`ADVICE.md`'s first finding); the port's point at the last row block, so
`row_blk` stays sorted.

Tolerances. At f32 ("highest") the tiled pair matches the TPU package's at
HIGHEST to 1e-6, and its gradient too. At the bf16 operand setting
("default", the TPU package's TILE_PRECISION) the port matches the TPU
package's HIGHEST product of the same inputs rounded to bf16 to 1e-6 (the
blocks are small integers, exact in bf16, so the only rounding is the
features'); against the exact f32 flat sums it lies within 2^-8 of the
largest |input| times the largest clause degree, bf16's rounding bound, and
its gradient as well. One planned QuerySAT train step through the tiles,
and one tiled ANF train step, give the TPU package's new params (rtol 1e-5,
atol 1e-6) from the same state and draws.

The sums that once used atomics take one fixed order: on a 17-round SHA-1
system, the plain AND -> variable scatter and the tiled pair (forward and
backward, with the tiles as built and shuffled inside their row blocks)
equal the TPU package's at 1e-6, and two calls agree bit for bit.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    anf_batch_pair,
    anf_items,
    batch_pair,
    jax_anf_round_noise,
    np_of,
    random_formulas,
    torch_params,
)
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.models import anf_sat as janf_model
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.ops import tiled_ops as jtiled
from diffusionsat_torch.models import anf_sat as tanf_model
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.ops import tiled_ops as ttiled
from diffusionsat_torch.ops.graph_ops import clause_to_lit, lit_to_clause
from diffusionsat_torch.train.checkpoint import params_to_numpy

jab = importlib.import_module("diffusionsat_tpu.train.adabelief")
tab = importlib.import_module("diffusionsat_torch.train.adabelief")
jloop = importlib.import_module("diffusionsat_tpu.train.loop")
tloop = importlib.import_module("diffusionsat_torch.train.loop")

F32_TOL = dict(rtol=1e-6, atol=1e-6)
HIGHEST = jax.lax.Precision.HIGHEST
SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, train_rounds=3,
             test_rounds=3, debug_zero_noise=True)


def _cnf_pair(seed=1, n_formulas=6):
    return batch_pair(*random_formulas(seed, n_formulas=n_formulas),
                      max_vars=96, max_clauses=256, max_edges=1024)


def _tiles(kind, jb, tb, **kw):
    if kind == "cnf":
        return (jtiled.build_tiled_incidence(jb, **kw),
                ttiled.build_tiled_incidence(tb, **kw))
    return jtiled.build_anf_tiles(jb, **kw), ttiled.build_anf_tiles(tb, **kw)


def _pair(kind, seed):
    if kind == "cnf":
        return _cnf_pair(seed)
    return anf_batch_pair(anf_items(seed, 5))


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("kind", ["cnf", "anf"])
@pytest.mark.parametrize("tc,tl,pad", [(8, 8, 4), (16, 32, 8),
                                       (128, 128, 64)])
def test_real_tiles_equal_and_padding_sorted(kind, tc, tl, pad):
    jb, tb = _pair(kind, 2)
    jt, tt = _tiles(kind, jb, tb, tc=tc, tl=tl, pad_tiles=pad)
    T = tt.n_real_tiles
    jblocks = np.asarray(jt.blocks)
    assert np.count_nonzero(jblocks.reshape(len(jblocks), -1).any(1)) == T
    for name in ("blocks", "row_blk", "col_blk"):
        np.testing.assert_array_equal(np_of(getattr(tt, name))[:T],
                                      np.asarray(getattr(jt, name))[:T])
    np.testing.assert_array_equal(np_of(tt.col_blk), np.asarray(jt.col_blk))
    np.testing.assert_array_equal(np_of(tt.blocks), jblocks)
    for name in ("tc", "tl", "n_row_blocks", "n_col_blocks", "num_clauses",
                 "num_literals", "n_tiles"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert np.all(np.diff(np_of(tt.row_blk)) >= 0)
    assert np.all(np_of(tt.row_blk)[T:] == tt.n_row_blocks - 1)


def test_padding_case_of_the_advice_finding():
    """Tp > T and the last real row block > 0: the TPU package's row_blk is
    unsorted there, the port's is sorted, and both sum the same."""
    jb, tb = _cnf_pair(3)
    jt, tt = _tiles("cnf", jb, tb, tc=16, tl=16, pad_tiles=64)
    T = tt.n_real_tiles
    assert tt.n_tiles > T and int(tt.row_blk[T - 1]) > 0
    assert np.any(np.diff(np.asarray(jt.row_blk)) < 0)
    assert np.all(np.diff(np_of(tt.row_blk)) >= 0)
    x = np.random.default_rng(0).normal(size=(2 * tb.V, 5)).astype(
        np.float32)
    got = ttiled.tiled_lit_to_clause(torch.from_numpy(x), tt, "highest")
    np.testing.assert_allclose(np_of(got), np_of(lit_to_clause(
        tb, torch.from_numpy(x))), **F32_TOL)


@pytest.mark.parametrize("kind", ["cnf", "anf"])
@pytest.mark.parametrize("tc,tl", [(8, 8), (16, 32), (128, 128)])
def test_tiled_pair_f32_matches(kind, tc, tl):
    jb, tb = _pair(kind, 4)
    jt, tt = _tiles(kind, jb, tb, tc=tc, tl=tl, pad_tiles=4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(tt.num_literals, 7)).astype(np.float32)
    y = rng.normal(size=(tt.num_clauses, 6)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(ttiled.tiled_lit_to_clause(torch.from_numpy(x), tt,
                                         "highest")),
        np.asarray(jtiled.tiled_lit_to_clause(jnp.asarray(x), jt, HIGHEST)),
        **F32_TOL)
    np.testing.assert_allclose(
        np_of(ttiled.tiled_clause_to_lit(torch.from_numpy(y), tt,
                                         "highest")),
        np.asarray(jtiled.tiled_clause_to_lit(jnp.asarray(y), jt, HIGHEST)),
        **F32_TOL)


@pytest.mark.parametrize("kind", ["cnf", "anf"])
def test_tiled_pair_bf16_operands(kind):
    jb, tb = _pair(kind, 6)
    jt, tt = _tiles(kind, jb, tb, tc=16, tl=16, pad_tiles=4)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(tt.num_literals, 8)).astype(np.float32)
    y = rng.normal(size=(tt.num_clauses, 8)).astype(np.float32)
    blocks = np_of(tt.blocks)
    deg = max(blocks.sum(axis=2).max(), blocks.sum(axis=1).max())
    if kind == "cnf":
        flat = (lit_to_clause(tb, torch.from_numpy(x)),
                clause_to_lit(tb, torch.from_numpy(y)))
    else:
        plans = segsum.build_anf_plans(tb)
        flat = (segsum.plan_node_to_clause(torch.from_numpy(x), plans),
                segsum.plan_clause_to_node(torch.from_numpy(y), plans))
    for fn_t, fn_j, inp, ref in (
            (ttiled.tiled_lit_to_clause, jtiled.tiled_lit_to_clause, x,
             flat[0]),
            (ttiled.tiled_clause_to_lit, jtiled.tiled_clause_to_lit, y,
             flat[1])):
        with ttiled.tile_precision("default"):
            got = np_of(fn_t(torch.from_numpy(inp), tt))
        want = np.asarray(fn_j(jnp.asarray(_bf16(inp)), jt, HIGHEST))
        np.testing.assert_allclose(got, want, **F32_TOL)
        bound = 2.0 ** -8 * np.abs(inp).max() * deg
        assert np.abs(got - np_of(ref)).max() <= bound
        assert np.abs(got - np_of(ref)).max() > 0      # it did round


@pytest.mark.parametrize("mode", ["highest", "default"])
def test_tiled_pair_gradient_matches(mode):
    jb, tb = _cnf_pair(8)
    jt, tt = _tiles("cnf", jb, tb, tc=16, tl=16, pad_tiles=4)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2 * tb.V, 4)).astype(np.float32)
    w = rng.normal(size=(tb.C, 4)).astype(np.float32)
    y = rng.normal(size=(tb.C, 4)).astype(np.float32)
    u = rng.normal(size=(2 * tb.V, 4)).astype(np.float32)
    for fn_t, fn_j, inp, wt in (
            (ttiled.tiled_lit_to_clause, jtiled.tiled_lit_to_clause, x, w),
            (ttiled.tiled_clause_to_lit, jtiled.tiled_clause_to_lit, y, u)):
        want = np.asarray(jax.grad(lambda a: jnp.sum(
            fn_j(a, jt, HIGHEST) * wt))(jnp.asarray(inp)))
        a = torch.from_numpy(inp).requires_grad_(True)
        with ttiled.tile_precision(mode):
            (fn_t(a, tt) * torch.from_numpy(wt)).sum().backward()
        if mode == "highest":
            np.testing.assert_allclose(np_of(a.grad), want, **F32_TOL)
        else:
            blocks = np_of(tt.blocks)
            deg = max(blocks.sum(axis=2).max(), blocks.sum(axis=1).max())
            assert np.abs(np_of(a.grad) - want).max() <= \
                2.0 ** -8 * np.abs(wt).max() * deg


def test_plan_dispatch_serves_both_layouts():
    jb, tb = _cnf_pair(10)
    tt = ttiled.build_tiled_incidence(tb, tc=16, tl=32, pad_tiles=4)
    plans = segsum.build_batch_plans(tb)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(2 * tb.V, 3)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(12).normal(
        size=(tb.C, 3)).astype(np.float32))
    with ttiled.tile_precision("highest"):
        for fn in (segsum.plan_lit_to_clause, segsum.plan_clause_to_lit):
            arg = x if fn is segsum.plan_lit_to_clause else y
            np.testing.assert_allclose(np_of(fn(arg, tt)),
                                       np_of(fn(arg, plans)), **F32_TOL)


@pytest.mark.parametrize("kind", ["query_sat", "anf_sat"])
def test_tiled_train_step_gives_the_tpu_packages_new_params(kind,
                                                            monkeypatch):
    """One planned train step through the tiles (the training script's
    DSAT_FLAT_BACKEND=tiled step, and the ANF script's default step), from
    the same state with the same draws."""
    monkeypatch.setattr(jtiled, "TILE_PRECISION", HIGHEST)
    monkeypatch.setattr(ttiled, "TILE_PRECISION", "highest")
    lr = dict(initial_lr=1e-2, decay_steps=100, alpha=0.5)
    jopt = jab.adabelief(jab.cosine_decay_schedule(**lr))
    topt = tab.adabelief(learning_rate=tab.cosine_decay_schedule(**lr))
    key = jax.random.key(7)
    _, subkey = jax.random.split(key)
    if kind == "query_sat":
        jcfg, tcfg = jqs.QuerySATConfig(**SMALL), tqs.QuerySATConfig(**SMALL)
        jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
        jb, tb = _cnf_pair(13, 5)
        jt, tt = _tiles("cnf", jb, tb, tc=32, tl=32, pad_tiles=4)
        jstep = jloop.make_planned_train_step(jcfg, jopt)
        k_noise, _, k_input, _ = jax.random.split(subkey, 4)
        ns = jax.random.uniform(k_noise, ())
        noisy = construct_training_input(k_input, jb.solutions, ns)
        apply = functools.partial(tqs.query_sat_apply, noise_scale=float(ns),
                                  noisy_num=torch.from_numpy(
                                      np.array(noisy)))
        tstep = tloop.make_planned_train_step_for(apply, tcfg, topt,
                                                  device="cpu")
    else:
        small = dict(feature_maps=16, query_maps=16, train_rounds=3)
        jcfg = janf_model.ANFSATConfig(**small)
        tcfg = tanf_model.ANFSATConfig(**small)
        jparams = janf_model.anf_sat_init(jax.random.key(0), jcfg)
        jb, tb = anf_batch_pair(anf_items(14, 5))
        jt, tt = _tiles("anf", jb, tb, tc=16, tl=32, pad_tiles=4)
        jstep = jloop.make_planned_train_step_for(
            janf_model.anf_sat_apply, jcfg, jopt, plan_kw="tiles")
        apply = functools.partial(
            tanf_model.anf_sat_apply,
            round_noise=jax_anf_round_noise(subkey, 3, jb.V))
        tstep = tloop.make_planned_train_step_for(apply, tcfg, topt,
                                                  plan_kw="tiles",
                                                  device="cpu")
    jstate = jloop.TrainState(params=jparams, opt_state=jopt.init(jparams),
                              step=jnp.zeros((), jnp.int32), key=key)
    jnew, jout = jstep(jstate, jb, jt)
    tparams = torch_params(jparams)
    tstate = tloop.TrainState(params=tparams, opt_state=topt.init(tparams),
                              step=0, generator=torch.Generator())
    tnew, tout = tstep(tstate, tb, tt)
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                               rtol=1e-5)
    old = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    got = jax.tree.leaves(params_to_numpy(tnew.params))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jnew.params))
    assert max(float(np.abs(w - o).max()) for o, w in zip(old, want)) > 1e-5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- fixed-order sums in place of atomics, on an r17 SHA-1 system ----------

R17_BUCKET = dict(max_vars=4096, max_ands=4224, max_clauses=4352,
                  max_edges=16384, max_graphs=1)


@pytest.fixture(scope="module")
def r17_pair():
    """One 17-round SHA-1 preimage system (the flagship's data, one system
    a batch)."""
    from diffusionsat_torch.data.sha_anf import Sha1AnfInstances
    items = list(Sha1AnfInstances(rounds=17, min_free_bits=24,
                                  max_free_bits=40, train_size=1,
                                  seed=3).train_generator())
    return anf_batch_pair(items, **R17_BUCKET)


def test_and_scatter_equals_the_tpu_packages_on_an_r17_batch(r17_pair):
    """The plain AND -> variable scatter (operand slots sorted once, a
    fixed-order segment sum) against JAX's two `.at[].add` scatters, and
    its gradient (a gather) against JAX's, at 1e-6."""
    jb, tb = r17_pair
    rng = np.random.default_rng(13)
    x = rng.normal(size=(tb.A, 8)).astype(np.float32) * \
        np_of(tb.and_mask)[:, None]
    w = rng.normal(size=(tb.V, 8)).astype(np.float32)
    a1, a2 = (np.maximum(np.asarray(a) - 1, 0) for a in (jb.and1, jb.and2))

    def jax_scatter(v):
        return jnp.zeros((jb.V, 8)).at[a1].add(v).at[a2].add(v)

    slots = tanf_model.and_operand_slots(
        torch.clamp(tb.and1 - 1, min=0), torch.clamp(tb.and2 - 1, min=0))
    a = torch.from_numpy(x).requires_grad_(True)
    got = tanf_model.scatter_ands(a, slots, tb.V)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(np_of(got), np.asarray(jax_scatter(
        jnp.asarray(x))), **F32_TOL)
    want_grad = jax.grad(lambda v: jnp.sum(jax_scatter(v) * w))(
        jnp.asarray(x))
    np.testing.assert_allclose(np_of(a.grad), np.asarray(want_grad),
                               **F32_TOL)


def _shuffled_within_row_blocks(tt, seed):
    """The same tiles in another order inside each row block (row_blk stays
    sorted, col_blk is scrambled), with the column permutation rebuilt."""
    rng = np.random.default_rng(seed)
    row = np_of(tt.row_blk)
    order = np.lexsort((rng.random(row.size), row))
    row, col = row[order], np_of(tt.col_blk)[order]
    return dataclasses.replace(
        tt, blocks=tt.blocks[order], row_blk=torch.from_numpy(row),
        col_blk=torch.from_numpy(col), **ttiled.tile_orders(
            row, col, tt.n_row_blocks, tt.n_col_blocks))


@pytest.mark.parametrize("shuffled", [False, True])
def test_tiled_pair_on_an_r17_batch_is_fixed_order(r17_pair, shuffled):
    """The tiled pair over the r17 system's membership tiles equals JAX's
    at f32, forward and backward, with the tiles in the build's order and
    shuffled inside their row blocks; two calls agree bit for bit."""
    jb, tb = r17_pair
    jt, tt = _tiles("anf", jb, tb)
    if shuffled:
        tt = _shuffled_within_row_blocks(tt, 17)
        assert np.any(np.diff(np_of(tt.col_blk)[:tt.n_real_tiles]) < 0)
    rng = np.random.default_rng(19)
    x = rng.normal(size=(tt.num_literals, 8)).astype(np.float32)
    y = rng.normal(size=(tt.num_clauses, 8)).astype(np.float32)
    for fn_t, fn_j, inp, out_rows in (
            (ttiled.tiled_lit_to_clause, jtiled.tiled_lit_to_clause, x,
             tt.num_clauses),
            (ttiled.tiled_clause_to_lit, jtiled.tiled_clause_to_lit, y,
             tt.num_literals)):
        wt = rng.normal(size=(out_rows, 8)).astype(np.float32)
        runs = []
        for _ in range(2):
            a = torch.from_numpy(inp).requires_grad_(True)
            out = fn_t(a, tt, "highest")
            (out * torch.from_numpy(wt)).sum().backward()
            runs.append((np_of(out), np_of(a.grad)))
        np.testing.assert_array_equal(runs[0][0], runs[1][0])
        np.testing.assert_array_equal(runs[0][1], runs[1][1])
        np.testing.assert_allclose(
            runs[0][0], np.asarray(fn_j(jnp.asarray(inp), jt, HIGHEST)),
            **F32_TOL)
        want_grad = jax.grad(lambda v: jnp.sum(
            fn_j(v, jt, HIGHEST) * wt))(jnp.asarray(inp))
        np.testing.assert_allclose(runs[0][1], np.asarray(want_grad),
                                   **F32_TOL)
