"""Port vs TPU package: input-anchored CDCL completion and seeded CDCL.

Host code on the same native solver source: the equation extraction, the
residual CNF encoding, the free-input finder, the anchored completion's
results and `solve_seeded`'s (is_sat, model, conflicts) must be identical.
"""

import numpy as np
import pytest

from _torch_parity import anf_batch_pair, np_of
from diffusionsat_tpu.data.sha_anf import Sha1AnfInstances
from diffusionsat_tpu.sat import anf_completion as jc
from diffusionsat_tpu.sat import solvers as jsol
from diffusionsat_torch.sat import anf_completion as tc
from diffusionsat_torch.sat import solvers as tsol

BUCKET = dict(max_vars=4096, max_ands=4096, max_clauses=4096,
              max_edges=16384, max_graphs=4)


@pytest.fixture(scope="module")
def sha_batches():
    items = list(Sha1AnfInstances(rounds=5, min_free_bits=6, max_free_bits=10,
                                  train_size=3, seed=2).train_generator())
    return anf_batch_pair(items, **BUCKET)


def test_equations_and_free_inputs_equal(sha_batches):
    jb, tb = sha_batches
    jeq, teq = jc.extract_graph_equations(jb), tc.extract_graph_equations(tb)
    assert teq == jeq and len(teq) == 3
    vg = np_of(tb.var_graph)
    for g, eqs in teq.items():
        vids = np.flatnonzero(vg == g)
        free = tc.free_inputs_of(eqs, vids)
        assert free == jc.free_inputs_of(eqs, vids)
        # the batch marks the same free inputs
        assert sorted(free) == np.flatnonzero(
            np_of(tb.free_input_mask) * (vg == g)).tolist()
        bits = np_of(tb.solutions)
        np.testing.assert_array_equal(tc.eval_equations(eqs, bits),
                                      jc.eval_equations(eqs, bits))
        fixed = {int(v): int(bits[v]) for v in free[: len(free) // 2]}
        released = [int(v) for v in vids if int(v) not in fixed]
        assert tc.encode_residual_cnf(eqs, fixed, released) == \
            jc.encode_residual_cnf(eqs, fixed, released)


@pytest.mark.parametrize("n_flips", [0, 2, 5])
def test_anchored_completion_identical(sha_batches, n_flips):
    jb, tb = sha_batches
    eqs_all = tc.extract_graph_equations(tb)
    vg = np_of(tb.var_graph)
    rng = np.random.default_rng(n_flips)
    pred = np_of(tb.solutions).astype(np.int8)
    conf = rng.random(len(pred)).astype(np.float32) + 1.0
    for g, eqs in eqs_all.items():
        vids = np.flatnonzero(vg == g)
        free = tc.free_inputs_of(eqs, vids)
        # flip some predicted inputs; make the flipped ones least confident
        flip = rng.choice(free, size=min(n_flips, len(free)), replace=False)
        pred[flip] ^= 1
        conf[flip] = rng.random(len(flip)).astype(np.float32) * 0.5
        got = tc.input_anchored_complete(eqs, vids, pred, conf)
        want = jc.input_anchored_complete(eqs, vids, pred, conf)
        assert got == want
        assert got[0]


def test_solve_seeded_identical(sha_batches):
    _, tb = sha_batches
    eqs = tc.extract_graph_equations(tb)[0]
    vids = np.flatnonzero(np_of(tb.var_graph) == 0)
    clauses, n, _ = tc.encode_residual_cnf(eqs, {}, [int(v) for v in vids])
    rng = np.random.default_rng(3)
    polarity = rng.integers(-1, 2, size=n).astype(np.int8)
    activity = rng.random(n).astype(np.float32)
    for kw in ({}, {"polarity": polarity}, {"polarity": polarity,
                                            "activity": activity}):
        for seed in (0, 5):
            got = tsol.solve_seeded(clauses, n, seed=seed, **kw)
            assert got == jsol.solve_seeded(clauses, n, seed=seed, **kw)
            assert got[0] and got[2] >= 0
    unsat = [[1, 2], [-1, 2], [1, -2], [-1, -2]]
    assert tsol.solve_seeded(unsat, 2) == jsol.solve_seeded(unsat, 2)
    with pytest.raises(TimeoutError):
        tsol.solve_seeded(clauses, n, conflict_budget=0,
                          polarity=np.zeros(n, np.int8))
    with pytest.raises(ValueError):
        tsol.solve_seeded(clauses, n, polarity=np.zeros(n + 1, np.int8))
