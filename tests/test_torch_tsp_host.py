"""Port vs TPU package: the TSP stack's host code.

Data batches (Euclidean and asymmetric, exact and 2-opt labels), the exact
and heuristic tours, the native subtour finder's cut pairs (and their
truncation), the decoders and the optimality-gap metric must equal the TPU
package's exactly: both are host numpy over the same streams and the same
native source.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusionsat_tpu.tsp import data as jdata
from diffusionsat_tpu.tsp import metrics as jmetrics
from diffusionsat_tpu.tsp import subtours as jsub
from diffusionsat_torch.tsp import PADDING_VALUE
from diffusionsat_torch.tsp import data as tdata
from diffusionsat_torch.tsp import metrics as tmetrics
from diffusionsat_torch.tsp import subtours as tsub


def _euclid(rng, n):
    c = rng.random((n, 2))
    return np.sqrt(((c[:, None] - c[None]) ** 2).sum(-1)).astype(np.float32)


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("kind,lo,hi,padded,size", [
    ("EuclideanTSP", 5, 12, 16, 7),      # native Held-Karp
    ("EuclideanTSP", 21, 22, 32, 2),     # native branch-and-bound
    ("EuclideanTSP", 31, 32, 32, 1),     # nearest neighbour + 2-opt
    ("AsymmetricTSP", 4, 9, 12, 5),
])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_batches_equal_byte_for_byte(kind, lo, hi, padded, size, mode):
    kw = dict(min_node_count=lo, max_node_count=hi, padded_size=padded,
              train_size=size, test_size=size, seed=3)
    want = list(getattr(jdata, kind)(**kw).batches(mode, 3))
    got = list(getattr(tdata, kind)(**kw).batches(mode, 3))
    assert len(got) == len(want) == -(-size // 3)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_tours_equal():
    rng = np.random.default_rng(1)
    for n in (4, 7, 11):
        d = _euclid(rng, n)
        assert tdata.held_karp(d) == jdata.held_karp(d)
    for n in (6, 13, 18):
        d = _euclid(rng, n)
        assert tdata.native_held_karp(d) == jdata.native_held_karp(d)
        asym = rng.random((n, n)).astype(np.float32)
        np.fill_diagonal(asym, 0.0)
        assert tdata.native_held_karp(asym) == jdata.native_held_karp(asym)
    for n in (9, 17, 23):
        d = _euclid(rng, n)
        bb = tdata.native_branch_bound(d)
        assert bb == jdata.native_branch_bound(d)
        assert sorted(bb) == list(range(n))
    # a node budget too small to prove optimality: no tour from either
    d = _euclid(rng, 24)
    assert tdata.native_branch_bound(d, node_budget=10) is None
    assert jdata.native_branch_bound(d, node_budget=10) is None
    for n, seed in ((12, 0), (35, 4)):
        d = _euclid(rng, n)
        assert tdata.two_opt_tour(d, seed) == jdata.two_opt_tour(d, seed)
        assert tdata.optimal_tour(d, seed) == jdata.optimal_tour(d, seed)
        t = tdata.optimal_tour(d, seed)
        assert tdata.tour_length(d, t) == jdata.tour_length(d, t)
        np.testing.assert_array_equal(tdata.tour_to_label_matrix(t, 40),
                                      jdata.tour_to_label_matrix(t, 40))
    assert tdata.EXACT_LABEL_MAX_N == jdata.EXACT_LABEL_MAX_N == 30
    assert PADDING_VALUE == -1.0


def _predictions(seed, b, p, n_real):
    """Random edge probabilities and their padded adjacency: graph g has
    n_real[g] real nodes."""
    rng = np.random.default_rng(seed)
    preds = rng.random((b, p, p)).astype(np.float32) * 0.6
    adj = np.full((b, p, p), PADDING_VALUE, np.float32)
    for g, n in enumerate(n_real):
        adj[g, :n, :n] = _euclid(rng, n)
    return preds, adj


@pytest.mark.parametrize("symmetric", [True, False])
def test_subtour_pairs_equal_with_cut_ids_ascending(symmetric):
    preds, adj = _predictions(0, 4, 8, [8, 6, 3, 2])
    want = jsub.find_subtours(preds, adj, symmetric=symmetric)
    got = tsub.find_subtours(preds, adj, symmetric=symmetric)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0
    ids = got[:, 0]
    assert (np.diff(ids) >= 0).all() and ids[0] == 0
    # the host call on tensors, and the TPU package's fixed-size buffer
    # with its truncation
    for max_pairs in (len(want) + 5, len(want) // 3):
        jpairs, jn = jsub.subtour_pairs_callback(
            jnp.asarray(preds), jnp.asarray(adj), max_pairs, symmetric)
        tpairs = tsub.subtour_pairs(torch.from_numpy(preds),
                                    torch.from_numpy(adj), max_pairs,
                                    symmetric)
        assert len(tpairs) == int(jn) == min(max_pairs, len(want))
        np.testing.assert_array_equal(tpairs,
                                      np.asarray(jpairs)[:int(jn)])
        assert (np.asarray(jpairs)[int(jn):] == -1).all()


def test_decoders_and_metrics_equal():
    gen_kw = dict(min_node_count=5, max_node_count=10, padded_size=32,
                  train_size=5)
    small = next(tdata.EuclideanTSP(**gen_kw).batches("train", 5))
    big = next(tdata.EuclideanTSP(min_node_count=31, max_node_count=32,
                                  padded_size=32, train_size=1
                                  ).batches("train", 1))
    batch = {k: np.concatenate([small[k], big[k]]) for k in small}
    rng = np.random.default_rng(2)
    logits = rng.normal(size=batch["labels"].shape).astype(np.float32)
    logits += 3.0 * (batch["labels"] == 1.0)
    probs = 1.0 / (1.0 + np.exp(-logits))
    for g in range(len(logits)):
        n = tmetrics.get_unpadded_size(batch["adj_matrix"][g][0])
        assert n == jmetrics.get_unpadded_size(batch["adj_matrix"][g][0])
        assert tmetrics.greedy_decode(probs[g], n) == \
            jmetrics.greedy_decode(probs[g], n)
        if n <= 10:
            assert tmetrics.beam_decode(probs[g], n, 16) == \
                jmetrics.beam_decode(probs[g], n, 16)
    for use_beam in (False, True):
        tm = tmetrics.TSPMetrics(beam_width=8, use_beam=use_beam)
        jm = jmetrics.TSPMetrics(beam_width=8, use_beam=use_beam)
        tm.update_state({"prediction": torch.from_numpy(logits)}, batch)
        jm.update_state({"prediction": logits}, batch)
        assert tm.gaps == jm.gaps and tm.sizes == jm.sizes
        got, want = tm.get_values(), jm.get_values()
        assert got == want
        assert "label_basis_note" in got and got["optimality_gap"] > 0
        assert tm.gaps == [] and tm.get_values() == jm.get_values()
