"""Port vs TPU package: the solver layer, XOR hashing and model counting.

Both packages build the same native source and draw from the same numpy
streams, so every result is held exactly: the same models in the same
order, the same cells, counts and samples.
"""

import numpy as np
import pytest

from diffusionsat_tpu.sat import all_solutions as jall
from diffusionsat_tpu.sat import solvers as jsol
from diffusionsat_tpu.sat import xor_hash as jxor
from diffusionsat_torch.sat import all_solutions as tall
from diffusionsat_torch.sat import solvers as tsol
from diffusionsat_torch.sat import xor_hash as txor
from diffusionsat_torch.sat.cnf import CNF, check_assignment


def _formula(seed, lo=8, hi=20, ratio=4.26):
    """A numpy-seeded random 3-SAT formula (n_vars, clauses)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(lo, hi + 1))
    m = int(ratio * n)
    clauses = [[int(v) if rng.random() < 0.5 else -int(v)
                for v in (rng.choice(n, size=3, replace=False) + 1)]
               for _ in range(m)]
    return n, clauses


def _dimacs(n, clauses):
    return CNF(n_vars=n, clauses=clauses).to_string()


@pytest.mark.parametrize("seed", range(4))
def test_enumerate_count_and_walksat_equal(seed):
    n, clauses = _formula(seed)
    for budget in (1 << 12, 7):
        want = jsol.enumerate_models(clauses, n, max_models=budget, seed=seed)
        got = tsol.enumerate_models(clauses, n, max_models=budget, seed=seed)
        assert got[1] == want[1]
        assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape
        np.testing.assert_array_equal(got[0], want[0])
    assert tsol.count_models(clauses, n) == jsol.count_models(clauses, n)
    init = np.random.default_rng(seed).integers(0, 2, n).astype(np.int8)
    for kw in ({}, {"init": init}, {"max_flips": 3, "noise": 0.3}):
        assert tsol.walksat(clauses, n, seed=seed + 5, **kw) == \
            jsol.walksat(clauses, n, seed=seed + 5, **kw)
    ok, model = tsol.walksat(clauses, n, seed=1)
    if ok:
        assert check_assignment(clauses, [int(v > 0) for v in model])


def test_solver_classes_equal():
    n, clauses = _formula(7)
    text = _dimacs(n, clauses)
    for tcls, jcls, kw in ((tsol.NativeCDCL, jsol.NativeCDCL,
                            {"rand_polarity": True, "seed": 3}),
                           (tsol.NativeWalkSAT, jsol.NativeWalkSAT,
                            {"seed": 3})):
        t, j = tcls(**kw), jcls(**kw)
        for _ in range(3):      # every call takes the next seed
            assert t.one_sample(text) == j.one_sample(text)
        assert t.multiple_samples(text, 2) == j.multiple_samples(text, 2)
    assert isinstance(tsol.default_solver(), tsol.NativeCDCL)
    # model-seeded CDCL (the ANF path) gives the same result and effort
    polarity = np.random.default_rng(1).integers(0, 2, n).astype(np.int8)
    assert tsol.solve_seeded(clauses, n, seed=2, polarity=polarity) == \
        jsol.solve_seeded(clauses, n, seed=2, polarity=polarity)


@pytest.mark.parametrize("max_enumerate", [200_000, 40])
def test_uniform_sampler_equal(max_enumerate):
    """Exact enumeration, and the XOR-hash cells once the model count is
    over the budget: the same samples, call after call."""
    n, clauses = _formula(23, lo=16, hi=20, ratio=2.0)
    count, exact = jsol.count_models(clauses, n)
    # over the hash sampler's exact budget of 200 as well: cells are drawn
    assert exact and count > 200
    text = _dimacs(n, clauses)
    t = tsol.UniformSampler(max_enumerate=max_enumerate, seed=4)
    j = jsol.UniformSampler(max_enumerate=max_enumerate, seed=4)
    for n_samples in (5, 9):
        got, want = t.multiple_samples(text, n_samples), \
            j.multiple_samples(text, n_samples)
        assert got == want and got[0] and len(got[1]) == n_samples
    unsat = _dimacs(1, [[1], [-1]])
    assert t.multiple_samples(unsat, 3) == (False, []) == \
        j.multiple_samples(unsat, 3)


@pytest.mark.parametrize("seed", [0, 3])
def test_approx_count_cells_and_hash_sampler_equal(seed):
    n, clauses = _formula(20 + seed, lo=16, hi=20, ratio=2.0)
    for kw in ({}, {"exact_budget": 10_000}):
        want = jxor.approx_count(clauses, n, seed=seed, **kw)
        got = txor.approx_count(clauses, n, seed=seed, **kw)
        assert (got.count, got.exact, got.m) == \
            (want.count, want.exact, want.m)
    rng_t, rng_j = (np.random.default_rng(seed) for _ in range(2))
    xors_t = txor.random_xors(rng_t, n, 4)
    assert xors_t == jxor.random_xors(rng_j, n, 4)
    for m in (2, 4):
        np.testing.assert_array_equal(
            txor._cell_models(clauses, n, xors_t[:m], 64, seed),
            jxor._cell_models(clauses, n, xors_t[:m], 64, seed))
    assert txor.xor_to_cnf([1, 3, 4], 1, n + 1) == \
        jxor.xor_to_cnf([1, 3, 4], 1, n + 1)
    rng_t, rng_j = (np.random.default_rng(seed) for _ in range(2))
    assert txor._search_m(clauses, n, 52, rng_t, 1, 0.5, seed)[0] == \
        jxor._search_m(clauses, n, 52, rng_j, 1, 0.5, seed)[0]
    got = txor.HashUniformSampler(seed=seed).sample_bits(clauses, n, 12)
    want = jxor.HashUniformSampler(seed=seed).sample_bits(clauses, n, 12)
    np.testing.assert_array_equal(got, want)
    for row in got:
        assert check_assignment(clauses, row.tolist())
    text = _dimacs(n, clauses)
    assert txor.HashUniformSampler(seed=seed).multiple_samples(text, 3) == \
        jxor.HashUniformSampler(seed=seed).multiple_samples(text, 3)


def test_all_solutions_equal():
    for n, clauses, budget in ((5, [[1, 2, 3], [-1, -2, -3], [4, 5]],
                                200_000),
                               (*_formula(30, lo=16, hi=16, ratio=2.0), 50)):
        t = tall.AllSolutions(n, clauses, max_enumerate=budget, seed=1)
        j = jall.AllSolutions(n, clauses, max_enumerate=budget, seed=1)
        assert (t.count(), t.is_exact) == (j.count(), j.is_exact)
        np.testing.assert_array_equal(t.solutions(), j.solutions())
    assert tall.AllSolutions(5, [[1, 2, 3], [-1, -2, -3], [4, 5]]).count() \
        == 18


def test_literal_beyond_n_vars_raises():
    with pytest.raises(ValueError, match="n_vars"):
        tsol.enumerate_models([[1, 4]], 3)
    with pytest.raises(ValueError, match="n_vars"):
        tsol.walksat([[1, -5]], 2)
