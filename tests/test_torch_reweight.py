"""Port vs TPU package: closed-loop label reweighting.

Every function is held exactly (f32 logits bit for bit) on synthetic banks
with duplicate rows, frequency tables cross between the packages, and the
port's content fingerprint tells apart two caches that the TPU package's
packing fingerprint cannot.
"""

import numpy as np
import pytest
import torch

from _torch_parity import batch_pair, np_of, random_formulas
from diffusionsat_tpu.uniformity import reweight as jrw
from diffusionsat_torch.uniformity import reweight as trw

K = 6


def _banks(formulas, seed):
    """K-row banks drawn from a few distinct rows per formula, so that rows
    repeat as they do in a uniform bank of a formula with few solutions."""
    rng = np.random.default_rng(seed)
    banks = []
    for n, _ in formulas:
        distinct = rng.integers(0, 2, size=(3, n))
        banks.append(distinct[rng.integers(0, 3, size=K)].tolist())
    return banks


def _pair(seed=0, n_formulas=4):
    formulas, _ = random_formulas(seed, n_formulas=n_formulas)
    return batch_pair(formulas, _banks(formulas, seed))


def _counts(batch, seed):
    ng = int(batch.n_graphs)
    return np.random.default_rng(seed).integers(0, 20, size=(K, ng))


def test_row_groups_and_neglog_logits_equal():
    rng = np.random.default_rng(1)
    for _ in range(5):
        rows = rng.integers(0, 2, size=(3, 7))[rng.integers(0, 3, size=K)]
        groups = trw.row_groups(rows)
        np.testing.assert_array_equal(groups, jrw.row_groups(rows))
        assert groups.dtype == np.int32
        counts = rng.integers(0, 30, size=K)
        counts = np.array([counts[np.argmax(groups == g)] for g in groups])
        for kw in ({}, {"tau": 2.0, "clamp": 0.5}):
            got = trw.neglog_freq_logits(counts, groups, **kw)
            want = jrw.neglog_freq_logits(counts, groups, **kw)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    zeros = trw.neglog_freq_logits(np.zeros(K), np.zeros(K, np.int32))
    np.testing.assert_array_equal(zeros, np.zeros(K, np.float32))


def test_finalize_and_compose_equal():
    jb, tb = _pair()
    counts = _counts(tb, 2)
    got = trw.finalize_counts(tb, counts)
    np.testing.assert_array_equal(got, jrw.finalize_counts(jb, counts))
    assert trw.batch_fingerprint(tb) == jrw.batch_fingerprint(jb)
    for iso_alpha, beta, neglog in ((0.45, 1.0, got), (0.0, 0.7, got),
                                    (0.45, 0.0, got), (0.3, 1.0, None)):
        t = trw.compose_label_logits(tb, iso_alpha, beta, neglog)
        j = jrw.compose_label_logits(jb, iso_alpha, beta, neglog)
        assert tb.label_isolation_k is None     # a copy, not in place
        assert t.label_isolation_k.dtype == torch.float32
        np.testing.assert_array_equal(np_of(t.label_isolation_k),
                                      np.asarray(j.label_isolation_k))


def _tables(jbatches, tbatches, measured):
    """A table as the TPU package's measurement writes it and one as the
    port's writes it, over the batches in `measured`."""
    jtab, ttab = {}, {}
    for i in measured:
        neglog = jrw.finalize_counts(jbatches[i], _counts(tbatches[i], i))
        jtab[f"neglog_{i}"] = ttab[f"neglog_{i}"] = neglog
        jtab[f"fingerprint_{i}"] = ttab[f"fingerprint_{i}"] = np.str_(
            jrw.batch_fingerprint(jbatches[i]))
        ttab[f"content_fingerprint_{i}"] = np.str_(
            trw.content_fingerprint(tbatches[i]))
    return jtab, ttab


def test_tables_cross_between_the_packages():
    pairs = [_pair(seed) for seed in range(3)]
    jbatches = [j for j, _ in pairs]
    tbatches = [t for _, t in pairs]
    jtab, ttab = _tables(jbatches, tbatches, measured=[0, 2])
    for table in (jtab, ttab):
        tb, jb = list(tbatches), list(jbatches)
        assert trw.attach_logit_table(tb, table, 0.45, 1.0) == 2
        # the TPU package reads the port's table (it ignores the content
        # fingerprint) and the port reads the TPU package's
        assert jrw.attach_logit_table(jb, table, 0.45, 1.0) == 2
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(np_of(t.label_isolation_k),
                                          np.asarray(j.label_isolation_k))
    with pytest.raises(ValueError, match="missing batch 1"):
        trw.attach_logit_table(list(tbatches), ttab, 0.45, 1.0,
                               require_all=True)


def test_content_fingerprint_tells_apart_what_the_packing_cannot():
    """Two caches with the same packing and other banks: the TPU package's
    fingerprint is equal and its attach takes the wrong table; the port's
    content fingerprint differs and its attach refuses."""
    formulas, _ = random_formulas(4)
    ja, ta = batch_pair(formulas, _banks(formulas, 0))
    jb, tb = batch_pair(formulas, _banks(formulas, 1))
    assert jrw.batch_fingerprint(ja) == jrw.batch_fingerprint(jb) == \
        trw.batch_fingerprint(tb)
    assert trw.content_fingerprint(ta) != trw.content_fingerprint(tb)
    _, table_a = _tables([ja], [ta], measured=[0])
    assert jrw.attach_logit_table([jb], table_a, 0.45, 1.0) == 1
    with pytest.raises(ValueError, match="content_fingerprint mismatch"):
        trw.attach_logit_table([tb], table_a, 0.45, 1.0)
    assert trw.attach_logit_table([ta], table_a, 0.45, 1.0) == 1
    # other formulas, same packing and the same bank: told apart too
    other = [(n, [[-l for l in c] for c in cl]) for n, cl in formulas]
    _, tc = batch_pair(other, _banks(formulas, 0))
    assert trw.content_fingerprint(tc) != trw.content_fingerprint(ta)


def test_mismatched_table_raises():
    jb, tb = _pair(0)
    _, other = _pair(1, n_formulas=3)
    _, table = _tables([jb], [tb], measured=[0])
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        trw.attach_logit_table([other], table, 0.45, 1.0)
    without = {"neglog_0": table["neglog_0"]}
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        trw.attach_logit_table([tb], without, 0.45, 1.0)
    # a batch the table does not cover gets the isolation-only logits
    batches = [tb]
    assert trw.attach_logit_table(batches, {}, 0.45, 1.0) == 0
    np.testing.assert_array_equal(
        np_of(batches[0].label_isolation_k),
        np.asarray(jrw.compose_label_logits(jb, 0.45, 0.0,
                                            None).label_isolation_k))
