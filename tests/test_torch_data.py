"""Port vs TPU package: instance generators, packing and the dataset cache.

Host-built data must be equal exactly: the same instance lists from the
same seeds (both random streams and the solver seeds line up), the same
packed groups, the same cached batches, and either package reads a cache
file the other wrote.
"""

import numpy as np
import pytest

from _torch_parity import assert_batches_equal, np_of
from diffusionsat_tpu.data import datasets as jds
from diffusionsat_tpu.data import generators as jgen
from diffusionsat_tpu.data.packing import pack_instances as jpack
from diffusionsat_tpu.graph.batch import BucketSpec as JBucketSpec
from diffusionsat_torch.data import datasets as tds
from diffusionsat_torch.data import generators as tgen
from diffusionsat_torch.data.packing import pack_instances as tpack
from diffusionsat_torch.graph.batch import BucketSpec
from diffusionsat_torch.sat.cnf import check_assignment

SIZES = dict(min_vars=3, max_vars=14, train_size=14, test_size=9, seed=5)
BUCKET = dict(max_vars=64, max_clauses=256, max_edges=768, max_graphs=6)


def _wrapped(mod, **kw):
    return mod.DiffusionSatInstances(mod.SAT3Instances(**dict(SIZES, **kw)),
                                     seed=SIZES["seed"])


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("wrapped", [False, True])
def test_sat3_instance_lists_equal(mode, wrapped):
    if wrapped:
        j, t = _wrapped(jgen), _wrapped(tgen)
    else:
        j, t = jgen.SAT3Instances(**SIZES), tgen.SAT3Instances(**SIZES)
    want = list(getattr(j, f"{mode}_generator")())
    got = list(getattr(t, f"{mode}_generator")())
    assert got == want and len(got) == SIZES[f"{mode}_size"]
    for n, clauses, bits in got:       # the attached label is a model
        assert len(bits) == n and check_assignment(clauses, bits)


@pytest.mark.parametrize("shards", [3, 16])
def test_split_shards_equal(shards):
    j, t = _wrapped(jgen).split(shards), _wrapped(tgen).split(shards)
    assert len(j) == len(t) == shards
    assert sum(s.base.test_size for s in t) == SIZES["test_size"]
    for js, ts in zip(j, t):
        assert (ts.seed, ts.base.seed, ts.base.train_size,
                ts.base.test_size) == (js.seed, js.base.seed,
                                       js.base.train_size, js.base.test_size)
        assert list(ts.test_generator()) == list(js.test_generator())


def test_shard_count_is_data_not_worker_count():
    """The TPU package ties shards to its worker processes; the port takes
    the shard count as data and any number of processes give that split."""
    want = jds._generate_instances(_wrapped(jgen), "test", workers=2)
    inst = _wrapped(tgen)
    serial = tds._generate_instances(inst, "test", shards=2, workers=1)
    pooled = tds._generate_instances(inst, "test", shards=2, workers=2)
    assert serial == pooled == want
    assert tds._generate_instances(inst, "test", shards=1) == \
        list(_wrapped(jgen).test_generator())
    assert tds._generate_instances(inst, "test", shards=3, workers=1) != want


class _NoLabels(tgen.SatInstances):
    def train_generator(self):
        yield 3, [[1, 2], [-1, 3], [-2, -3]], None

    test_generator = train_generator


class _JNoLabels(jgen.SatInstances):
    train_generator = test_generator = _NoLabels.train_generator


def test_missing_labels_come_from_the_solver_or_raise():
    got = list(tgen.DiffusionSatInstances(
        _NoLabels(), use_unigen=False, seed=3).train_generator())
    want = list(jgen.DiffusionSatInstances(
        _JNoLabels(), use_unigen=False, seed=3).train_generator())
    assert got == want and got[0][2] is not None
    # uniform labels (the default) and K-row banks: the TPU package's draws
    for kw in ({}, {"n_label_samples": 4}):
        got = list(tgen.DiffusionSatInstances(_NoLabels(), seed=3, **kw)
                   .train_generator())
        want = list(jgen.DiffusionSatInstances(_JNoLabels(), seed=3, **kw)
                    .train_generator())
        assert got == want and check_assignment(
            got[0][1], got[0][2][0] if kw else got[0][2])
    with pytest.raises(ValueError, match="use_unigen"):
        tgen.DiffusionSatInstances(_NoLabels(), use_unigen=False,
                                   n_label_samples=4)


@pytest.mark.parametrize("kw", [{}, dict(shuffle_batches=False),
                                dict(seed=3, utilization=0.25)])
def test_pack_instances_groups_equal(kw, capsys):
    instances = list(tgen.SAT3Instances(**dict(SIZES, train_size=40))
                     .train_generator())
    got = tpack(instances, BucketSpec(**BUCKET), **kw)
    want = jpack(instances, JBucketSpec(**BUCKET), **kw)
    assert got == want and len(got) > 1
    if "utilization" in kw:      # the largest formulas no longer fit
        assert "exceed the bucket" in capsys.readouterr().out
        assert sum(map(len, got)) < len(instances)


def _datasets(tmp_path, shards=2):
    j = jds.SatDataset(_wrapped(jgen), JBucketSpec(**BUCKET),
                       cache_dir=tmp_path / "j", name="d", seed=1,
                       gen_workers=shards)
    t = tds.SatDataset(_wrapped(tgen), BucketSpec(**BUCKET),
                       cache_dir=tmp_path / "t", name="d", seed=1,
                       gen_shards=shards, gen_workers=1)
    return j, t


def test_cached_batches_equal_and_caches_cross_read(tmp_path):
    j, t = _datasets(tmp_path)
    jb, tb = j.test_data(), t.test_data()
    assert len(jb) == len(tb) >= 2 and tb.seed == jb.seed
    for a, b in zip(jb, tb):
        assert_batches_equal(a, b)
    jpath, tpath = j._cache_path("test"), t._cache_path("test")
    assert jpath.name == tpath.name and tpath.exists()
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
    # a second materialisation reads the cache; each package reads the
    # other's file
    for a, b in zip(jb, t.test_data()):
        assert_batches_equal(a, b)
    for a, b in zip(jds._load_batches(tpath), tds._load_batches(jpath)):
        assert_batches_equal(a, b)
    order = [int(b.n_vars) for b in tb]
    stream = tb.repeat_shuffled()
    assert sorted(int(next(stream).n_vars) for _ in order) == sorted(order)


def test_train_split_and_validation_fallback(tmp_path):
    j, t = _datasets(tmp_path, shards=1)
    for a, b in zip(j.train_data(), t.train_data()):
        assert_batches_equal(a, b)
    assert t._cache_path("train") != t._cache_path("test")
    for a, b in zip(t.validation_data(), t.test_data()):
        for f in ("edge_lit_c", "solutions"):
            np.testing.assert_array_equal(np_of(getattr(a, f)),
                                          np_of(getattr(b, f)))


def test_native_solver_models_equal_and_build_location(tmp_path, monkeypatch):
    from diffusionsat_tpu.sat.solvers import solve as jsolve
    from diffusionsat_torch.sat.native import build as tbuild
    from diffusionsat_torch.sat.solvers import solve as tsolve

    for n, clauses, _ in tgen.SAT3Instances(**SIZES).test_generator():
        for kw in (dict(seed=0), dict(seed=9, rand_polarity=True)):
            assert tsolve(clauses, n, **kw) == jsolve(clauses, n, **kw)
    unsat = [[1], [-1]]
    assert tsolve(unsat) == jsolve(unsat) == (False, [])
    with pytest.raises(ValueError, match="exceeds n_vars"):
        tsolve([[1, 5]], 3)
    # built into the package's build directory, never beside the source
    lib = tbuild.build()
    assert lib.parent == tbuild.BUILD_DIR and lib.parent.name == "_build"
    assert not list(tbuild.SOURCE.parent.glob("*.so"))
    # a missing compiler is an error, not a fallback
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        tbuild.build()
