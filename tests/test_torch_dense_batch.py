"""Port vs TPU package: the dense per-graph block layout
(`graph/dense_batch.py`). Host-built arrays must be equal exactly: every
field, its dtype and its shape."""

import numpy as np
import pytest
import torch

from _torch_parity import (
    DENSE_FIELDS,
    assert_batches_equal,
    batch_pair,
    random_formulas,
)
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_torch.graph import dense_batch as tdb


def _pairs(seeds, **kw):
    pairs = [batch_pair(*random_formulas(s, **kw)) for s in seeds]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_level_tables_equal():
    assert tdb._DIM_LEVELS == jdb._DIM_LEVELS
    assert tdb._FINE_DIM_LEVELS == jdb._FINE_DIM_LEVELS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_from_flat_equal(seed):
    (jb,), (tb,) = _pairs([seed], n_formulas=3 + seed)
    dims = jdb.dense_dims_for([jb])
    assert tdb.dense_dims_for([tb]) == dims
    td = tdb.dense_from_flat(tb, *dims)
    assert_batches_equal(jdb.dense_from_flat(jb, *dims), td, DENSE_FIELDS)
    assert td.incidence.device.type == "cpu"
    assert td.to("cpu").incidence is td.incidence   # shared, not copied


def test_repeated_literals_accumulate():
    formulas = [(3, [[1, 1, -2], [2, 3], [-3, -3, -3]]), (2, [[1, -2]])]
    jb, tb = batch_pair(formulas, [[1, 0, 1], [0, 0]])
    td = tdb.dense_from_flat(tb, 2, 4, 4)
    assert_batches_equal(jdb.dense_from_flat(jb, 2, 4, 4), td, DENSE_FIELDS)
    assert td.incidence[0, 0, 0] == 2.0 and td.incidence[0, 2, 4 + 2] == 3.0


def test_solution_bank_and_isolation_carried_through():
    formulas, _ = random_formulas(5, n_formulas=3)
    rng = np.random.default_rng(5)
    banks = [rng.integers(0, 2, size=(4, n)).tolist() for n, _ in formulas]
    jb, tb = batch_pair(formulas, banks)
    iso = rng.normal(size=(4, jb.G)).astype(np.float32)
    jb = jb.replace(label_isolation_k=iso)
    tb.label_isolation_k = torch.from_numpy(iso)
    dims = jdb.dense_dims_for([jb])
    jd, td = jdb.dense_from_flat(jb, *dims), tdb.dense_from_flat(tb, *dims)
    assert td.solutions_k.shape == (4, td.G, td.Vg)
    assert td.label_isolation_k.shape == (4, td.G)
    assert_batches_equal(jd, td, DENSE_FIELDS)


def test_densify_batches_shared_dims_equal():
    jbs, tbs = _pairs([0, 1, 2], n_formulas=4, lo=3, hi=12)
    jds, tds = jdb.densify_batches(jbs), tdb.densify_batches(tbs)
    assert len({(d.G, d.Vg, d.Cg) for d in tds}) == 1
    for jd, td in zip(jds, tds):
        assert_batches_equal(jd, td, DENSE_FIELDS)


@pytest.mark.parametrize("fine", ["1", "0"])
@pytest.mark.parametrize("g_quantum", [None, 8])
def test_densify_quantized_equal(monkeypatch, fine, g_quantum):
    monkeypatch.setenv("DSAT_FINE_BLOCKS", fine)
    jbs, tbs = _pairs([3, 4], n_formulas=5, lo=3, hi=11)
    big = random_formulas(6, n_formulas=2, lo=24, hi=31, clause_ratio=4)
    kw = dict(max_vars=128, max_clauses=384, max_edges=1536)
    jbig, tbig = batch_pair(*big, **kw)
    jds = jdb.densify_batches_quantized(jbs + [jbig], g_quantum=g_quantum)
    tds = tdb.densify_batches_quantized(tbs + [tbig], g_quantum=g_quantum)
    for jd, td in zip(jds, tds):
        assert_batches_equal(jd, td, DENSE_FIELDS)
    table = tdb._FINE_DIM_LEVELS if fine == "1" else tdb._DIM_LEVELS
    assert all((d.Vg, d.Cg) in table for d in tds)
    assert tds[0].G == (g_quantum or (16 if fine == "1" else 32))
    assert (tds[-1].Vg, tds[-1].Cg) != (tds[0].Vg, tds[0].Cg)


def test_oversize_raises_value_error():
    (jb,), (tb,) = _pairs([7], n_formulas=4)
    for mod, b in ((jdb, jb), (tdb, tb)):
        with pytest.raises(ValueError, match="exceeds dense dims"):
            mod.dense_from_flat(b, 2, 16, 64)      # too few graphs
        with pytest.raises(ValueError, match="exceeds dense dims"):
            mod.dense_from_flat(b, 8, 2, 64)       # too few vars
    n = 130
    clauses = [[i + 1, -(i + 2)] for i in range(n - 1)]
    kw = dict(max_vars=256, max_clauses=256, max_edges=512, max_graphs=2)
    jb, tb = batch_pair([(n, clauses)], [[0] * n], **kw)
    for mod, b in ((jdb, jb), (tdb, tb)):
        with pytest.raises(ValueError, match="use the flat layout"):
            mod.densify_batches_quantized([b])
