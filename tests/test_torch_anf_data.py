"""Port vs TPU package: ANF data, exactly.

The generators are host Python on `random.Random`, so both packages must
produce the same equations and witnesses; `build_anf_batch`, the packing
and the npz caches are host numpy and must give equal arrays (value, dtype
and shape of every `ANFBatch` field), and a cache written by either
package must load in the other.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import anf_batch_pair, anf_items, np_of
from diffusionsat_tpu.data import anf as janf_gen
from diffusionsat_tpu.data import anf_datasets as jds
from diffusionsat_tpu.data import sha_anf as jsha
from diffusionsat_tpu.graph import anf_batch as jab
from diffusionsat_torch import build_anf_cache
from diffusionsat_torch.data import anf as tanf_gen
from diffusionsat_torch.data import anf_datasets as tds
from diffusionsat_torch.data import sha_anf as tsha
from diffusionsat_torch.graph import anf_batch as tab

FIELDS = [f.name for f in dataclasses.fields(tab.ANFBatch)]
SMALL_BUCKET = dict(max_vars=2048, max_ands=2048, max_clauses=2048,
                    max_edges=8192, max_graphs=4)


def assert_anf_batches_equal(jb, tb):
    assert FIELDS == [f for f in jab.ANFBatch.__dataclass_fields__]
    for name in FIELDS:
        a, b = getattr(jb, name), getattr(tb, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert isinstance(b, torch.Tensor), name
        a = np.asarray(a)
        assert a.dtype == np_of(b).dtype and a.shape == tuple(b.shape), name
        np.testing.assert_array_equal(a, np_of(b), err_msg=name)
    for d in ("V", "A", "C", "G", "n_value_nodes"):
        assert getattr(jb, d) == getattr(tb, d), d


@pytest.mark.parametrize("rounds,lo,hi", [(1, 2, 4), (3, 4, 10), (17, 2, 20)])
def test_sha1_systems_and_witnesses_equal(rounds, lo, hi):
    kw = dict(rounds=rounds, min_free_bits=lo, max_free_bits=hi,
              train_size=3 if rounds < 17 else 1, test_size=2, seed=5)
    j, t = jsha.Sha1AnfInstances(**kw), tsha.Sha1AnfInstances(**kw)
    for jg, tg in ((j.train_generator(), t.train_generator()),
                   (j.test_generator(), t.test_generator())):
        jl, tl = list(jg), list(tg)
        assert tl == jl
    assert all(len(wit) == n for n, _, wit in tl)


def test_random_systems_equal_and_satisfied():
    kw = dict(min_vars=4, max_vars=12, train_size=6, test_size=3, seed=3)
    j, t = janf_gen.RandomAnfInstances(**kw), tanf_gen.RandomAnfInstances(**kw)
    assert list(t.train_generator()) == list(j.train_generator())
    items = list(t.test_generator())
    assert items == list(j.test_generator())
    systems = [(n, eqs) for n, eqs, _ in items]
    sols = [b for _, _, b in items]
    assert tab.evaluate_anf(systems, sols) == \
        jab.evaluate_anf(systems, sols) == [True] * 3
    sols[1] = [1 - b for b in sols[1]]
    assert tab.evaluate_anf(systems, sols) == jab.evaluate_anf(systems, sols)


@pytest.mark.parametrize("source", ["random", "sha1_r2"])
def test_every_batch_field_equal(source):
    if source == "random":
        jb, tb = anf_batch_pair(anf_items(1, 5))
    else:
        items = list(tsha.Sha1AnfInstances(
            rounds=2, min_free_bits=3, max_free_bits=6, train_size=3,
            seed=1).train_generator())
        jb, tb = anf_batch_pair(items, **SMALL_BUCKET)
    assert_anf_batches_equal(jb, tb)
    assert float(tb.free_input_mask.sum()) > 0
    moved = tb.to("cpu")
    assert_anf_batches_equal(jb, moved)


def test_bucket_too_small_raises_in_both():
    items = anf_items(2, 3)
    systems = [(n, eqs) for n, eqs, _ in items]
    base = dict(max_vars=96, max_ands=160, max_clauses=96, max_edges=512,
                max_graphs=6)
    for kw in (dict(max_vars=8), dict(max_edges=16), dict(max_ands=2),
               dict(max_graphs=2)):
        bucket = dict(base, **kw)
        # the TPU package asserts on the graph count
        with pytest.raises((ValueError, AssertionError)):
            jab.build_anf_batch(systems, jab.ANFBucket(**bucket))
        with pytest.raises(ValueError):
            tab.build_anf_batch(systems, tab.ANFBucket(**bucket))


def test_packing_equal():
    items = anf_items(4, 20, min_vars=4, max_vars=20)
    kw = dict(max_vars=48, max_ands=96, max_clauses=64, max_edges=320,
              max_graphs=4)
    for shuffle in (True, False):
        got = tds.pack_anf_instances(items, tab.ANFBucket(**kw), seed=3,
                                     shuffle_batches=shuffle)
        want = jds.pack_anf_instances(items, jab.ANFBucket(**kw), seed=3,
                                      shuffle_batches=shuffle)
        assert got == want and len(got) > 3


def _datasets(tmp_path, sub):
    inst = dict(rounds=1, min_free_bits=2, max_free_bits=4, train_size=6,
                test_size=3, seed=0)
    kw = dict(cache_dir=tmp_path / sub, name="sha1anf_r1_fb2_4_4", seed=0)
    return (jds.AnfDataset(jsha.Sha1AnfInstances(**inst),
                           jab.ANFBucket(**SMALL_BUCKET), **kw),
            tds.AnfDataset(tsha.Sha1AnfInstances(**inst),
                           tab.ANFBucket(**SMALL_BUCKET), **kw))


@pytest.mark.parametrize("writer", ["tpu_package", "port"])
def test_cache_round_trips_both_ways(tmp_path, writer):
    j, t = _datasets(tmp_path, "a")
    assert j._cache_path("train") == t._cache_path("train")
    assert j._cache_path("test") == t._cache_path("test")
    first, second = (j, t) if writer == "tpu_package" else (t, j)
    for mode in ("train", "test"):
        written = first._materialize(mode)
        read = second._materialize(mode)
        pairs = zip(written, read) if writer == "tpu_package" else \
            zip(read, written)
        for jb, tb in pairs:
            assert_anf_batches_equal(jb, tb)
    # a fresh port build equals the cache either package wrote
    _, fresh = _datasets(tmp_path, "b")
    for jb, tb in zip(j.train_data(), fresh.train_data()):
        assert_anf_batches_equal(jb, tb)


def test_cache_without_free_input_mask_loads_as_none(tmp_path):
    j, t = _datasets(tmp_path, "c")
    t.train_data()
    path = t._cache_path("train")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if "free_input_mask" not in k}
    np.savez_compressed(path, **arrays)
    for jb, tb in zip(j.train_data(), t.train_data()):
        assert jb.free_input_mask is None and tb.free_input_mask is None
        assert_anf_batches_equal(jb, tb)


def test_repeat_shuffled_same_order(tmp_path):
    j, t = _datasets(tmp_path, "d")
    items = list(range(7))
    jit, tit = j.repeat_shuffled(items), t.repeat_shuffled(items)
    assert [next(tit) for _ in range(30)] == [next(jit) for _ in range(30)]


def test_build_anf_cache_names_the_tpu_packages_files(tmp_path,
                                                      monkeypatch):
    """The flagship cache script writes the TPU package's file names (the
    instance stream is cut here to keep the test small)."""
    made = []

    class Small(tsha.Sha1AnfInstances):
        def __init__(self, **kw):
            kw.update(rounds=1, max_free_bits=4, train_size=4, test_size=2)
            super().__init__(**kw)
            made.append(kw)

    monkeypatch.setattr(build_anf_cache, "Sha1AnfInstances", Small)
    n_train, n_test = build_anf_cache.main(["--data_dir", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    want = jds.AnfDataset(None, jab.ANFBucket(
        max_vars=8192, max_ands=16384, max_clauses=8704, max_edges=32768,
        max_graphs=8), name="sha1anf_r17_fb2_20_8000")
    assert names == sorted([want._cache_path("test").name,
                            want._cache_path("train").name])
    assert n_train >= 1 and n_test >= 1 and made
