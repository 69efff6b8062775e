"""Port vs TPU package: the losses of the other model family, the
neighbour norms, edge dropout and the LSTM cell.

Every function runs on the same numpy-seeded formulas and inputs in both
packages; each port function that aggregates literal values into clauses
runs without plans (per edge, as the TPU package writes it) and with its
`BatchPlans` (literal layout, on the kernel's plain version for CPU
tensors). Logits are drawn at scale 3, so that rounded assignments lie
far from the rounding threshold.

Tolerances (f32): values to 1e-5 absolute and relative; the gradients of
the losses' sums to 1e-4 of their largest entry, over the real variables;
counts equal. (The TPU package's gradient of `max_clauses_loss` and its
two users is NaN at a padding variable: a padded clause divides by
max(0, 1e-20), whose square XLA's CPU flushes to 0; the port's is 0
there.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import batch_pair, np_of, random_formulas, torch_params
from diffusionsat_tpu.losses import sat as jsat
from diffusionsat_tpu.nn import lstm as jlstm
from diffusionsat_tpu.nn import normalization as jnorm
from diffusionsat_torch.losses import sat as tsat
from diffusionsat_torch.nn import lstm as tlstm
from diffusionsat_torch.nn import normalization as tnorm
from diffusionsat_torch.ops.segsum import build_batch_plans

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4

LOSSES = ("softplus_loss", "softplus_log_loss", "softplus_log_square_loss",
          "softplus_square_loss", "softplus_mixed_loss", "sigmoid_log_loss",
          "unsat_clause_count", "max_clauses_loss", "min_max_loss",
          "log_max_loss", "clause_sat_indicator", "is_batch_sat")
# the rounded assignment has no gradient
NO_GRAD = ("unsat_clause_count", "clause_sat_indicator", "is_batch_sat")


@pytest.fixture(scope="module")
def batches():
    return batch_pair(*random_formulas(5, n_formulas=4))


def _logits(V, heads, seed=0):
    rng = np.random.default_rng(seed)
    shape = (V,) if heads is None else (V, heads)
    return (3.0 * rng.normal(size=shape)).astype(np.float32)


def _port(name, x, tb, plans):
    return getattr(tsat, name)(x, tb, plans=plans)


@pytest.mark.parametrize("planned", [False, True], ids=["plain", "plans"])
@pytest.mark.parametrize("heads", [None, 3], ids=["V", "VxK"])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_equals_the_tpu_package(name, heads, planned, batches):
    jb, tb = batches
    x = _logits(jb.V, heads)
    want = np.asarray(getattr(jsat, name)(jnp.asarray(x), jb))
    plans = build_batch_plans(tb) if planned else None
    got = np_of(_port(name, torch.from_numpy(x), tb, plans))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if name in NO_GRAD:
        return
    real = np_of(tb.var_mask) > 0
    jg = np.asarray(jax.grad(lambda z: jnp.sum(getattr(jsat, name)(z, jb)))(
        jnp.asarray(x)))[real]
    xt = torch.from_numpy(x).requires_grad_(True)
    tg, = torch.autograd.grad(torch.sum(_port(name, xt, tb, plans)), xt)
    assert np.isfinite(np_of(tg)).all()
    assert np.abs(np_of(tg)[real] - jg).max() <= GRAD_TOL * max(
        np.abs(jg).max(), 1e-6)


def _planted(seed=0, n_formulas=4, n=8):
    """Random 3-SAT formulas, each satisfied by its planted bits."""
    rng = np.random.default_rng(seed)
    formulas, sols = [], []
    for _ in range(n_formulas):
        bits = rng.integers(0, 2, size=n)
        clauses = []
        for _ in range(3 * n):
            vs = rng.choice(n, size=3, replace=False)
            signs = rng.random(3) < 0.5
            if not any(s == bool(bits[v]) for s, v in zip(signs, vs)):
                signs[0] = not signs[0]
            clauses.append([int(v + 1) if s else -int(v + 1)
                            for s, v in zip(signs, vs)])
        formulas.append((n, clauses))
        sols.append(bits.tolist())
    return formulas, sols


def test_unsat_count_and_batch_sat_on_a_solving_assignment():
    """Planted bits satisfy every formula: no clause unsat, the batch SAT;
    flipping the first variable's bit breaks some clause."""
    jb, tb = batch_pair(*_planted())
    bits = np_of(tb.solutions).astype(np.float32)
    x = np.where(bits > 0, 4.0, -4.0).astype(np.float32)
    plans = build_batch_plans(tb)
    assert float(tsat.unsat_clause_count(torch.from_numpy(x), tb,
                                         plans)) == 0.0
    assert float(tsat.is_batch_sat(torch.from_numpy(x), tb, plans)) == 1.0
    x[0] = -x[0]
    for planned in (None, plans):
        assert float(tsat.unsat_clause_count(torch.from_numpy(x), tb,
                                             planned)) == \
            float(jsat.unsat_clause_count(jnp.asarray(x), jb)) > 0


def test_edge_helpers_equal_the_tpu_package(batches):
    jb, tb = batches
    np.testing.assert_array_equal(np_of(tsat._edge_signs(tb)),
                                  np.asarray(jsat._edge_signs(jb)))
    np.testing.assert_array_equal(np_of(tsat._edge_var(tb)),
                                  np.asarray(jsat._edge_var(jb)))
    probs = np.random.default_rng(2).uniform(size=(jb.V, 2)).astype(
        np.float32)
    probs[0] = 0.0                         # exact zero factors
    want = np.asarray(jsat._clause_prod_unsat(jnp.asarray(probs), jb))
    for plans in (None, build_batch_plans(tb)):
        np.testing.assert_allclose(
            np_of(tsat._clause_prod_unsat(torch.from_numpy(probs), tb,
                                          plans)), want, **TOL)


@pytest.mark.parametrize("planned", [False, True], ids=["plain", "plans"])
@pytest.mark.parametrize("side", ["variables", "clauses"])
def test_neighbor_norm_equals_the_tpu_package(side, planned, batches):
    jb, tb = batches
    rows = jb.V if side == "variables" else jb.C
    x = np.random.default_rng(3).normal(size=(rows, 7)).astype(np.float32)
    fn = f"{side}_neighbor_norm"
    want = np.asarray(getattr(jnorm, fn)(jnp.asarray(x), jb))
    plans = build_batch_plans(tb) if planned else None
    got = np_of(getattr(tnorm, fn)(torch.from_numpy(x), tb, plans=plans))
    np.testing.assert_allclose(got, want, **TOL)


def test_edge_dropout_equals_the_tpu_package(batches):
    """The TPU package's Bernoulli draw injected as the keep mask: both
    orderings' masks equal, and the plans of the dropped batch drop the
    same edges (the planned sums equal the plain sums of the dropped
    batch)."""
    jb, tb = batches
    key = jax.random.key(4)
    jd = jnorm.edge_dropout(key, jb, 0.3)
    keep = jax.random.bernoulli(key, 0.7, jb.edge_mask_c.shape)
    td = tnorm.edge_dropout(tb, torch.from_numpy(np.array(keep)))
    for f in ("edge_mask_c", "edge_mask_l"):
        np.testing.assert_array_equal(np_of(getattr(td, f)),
                                      np.asarray(getattr(jd, f)))
    assert np_of(td.edge_mask_c).sum() < np_of(tb.edge_mask_c).sum()
    x = torch.from_numpy(_logits(tb.V, 2, seed=6))
    plans = build_batch_plans(td)
    for fn in ("softplus_loss", "max_clauses_loss", "sigmoid_log_loss"):
        torch.testing.assert_close(
            getattr(tsat, fn)(x, td, plans=plans),
            getattr(tsat, fn)(x, td), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            np_of(getattr(tsat, fn)(x, td, plans=plans)),
            np.asarray(getattr(jsat, fn)(jnp.asarray(x.numpy()), jd)),
            **TOL)


def test_lstm_cell_equals_the_tpu_package():
    """The Keras cell (gate order i, f, c, o; forget bias 1) on the TPU
    package's parameters, and the port's init: shapes, the forget bias and
    an orthogonal recurrent kernel."""
    params = jlstm.lstm_init(jax.random.key(0), 10, 6)
    rng = np.random.default_rng(0)
    x, h, c = (rng.normal(size=(5, d)).astype(np.float32)
               for d in (10, 6, 6))
    jh, (_, jc) = jlstm.lstm_apply(params, jnp.asarray(x),
                                   (jnp.asarray(h), jnp.asarray(c)))
    th, (th2, tc) = tlstm.lstm_apply(
        torch_params(params), torch.from_numpy(x),
        (torch.from_numpy(h), torch.from_numpy(c)))
    assert th is th2
    np.testing.assert_allclose(np_of(th), np.asarray(jh), **TOL)
    np.testing.assert_allclose(np_of(tc), np.asarray(jc), **TOL)

    g = torch.Generator()
    g.manual_seed(0)
    mine = tlstm.lstm_init(g, 10, 6)
    for k, v in params.items():
        assert tuple(mine[k].shape) == v.shape, k
    np.testing.assert_array_equal(np_of(mine["bias"]),
                                  np.asarray(params["bias"]))
    rec = np_of(mine["recurrent"]).astype(np.float64)
    np.testing.assert_allclose(rec @ rec.T, np.eye(6), atol=1e-5)
