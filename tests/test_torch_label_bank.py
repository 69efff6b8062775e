"""Port vs TPU package: multi-label banks of uniform solutions.

`DiffusionSatInstances(n_label_samples=K)` draws K uniform rows per instance
from a `UniformSampler` seeded `seed + idx`; both packages enumerate with the
same native source and draw from the same numpy streams, so the banks, the
cached `_k{K}` datasets and the fixed-formula test mode are held exactly.
"""

import numpy as np
import pytest

import diffusion_training as jdt
from _torch_parity import assert_batches_equal
from diffusionsat_tpu.config import RunConfig
from diffusionsat_tpu.data import datasets as jds
from diffusionsat_tpu.data import generators as jgen
from diffusionsat_tpu.graph.batch import BucketSpec as JBucketSpec
from diffusionsat_tpu.sat.cnf import CNF as JCNF
from diffusionsat_torch import diffusion_training as tdt
from diffusionsat_torch import solve_eval
from diffusionsat_torch.config import parse_config
from diffusionsat_torch.data import datasets as tds
from diffusionsat_torch.data import generators as tgen
from diffusionsat_torch.graph.batch import BucketSpec
from diffusionsat_torch.sat.cnf import CNF, check_assignment

SIZES = dict(min_vars=3, max_vars=12, train_size=10, test_size=8, seed=5)
BUCKET = dict(max_vars=64, max_clauses=256, max_edges=768, max_graphs=6)
MLK64 = "pretrained/query_sat_3sat_diffusion_mlk64.npz"


def _wrapped(mod, K, **kw):
    return mod.DiffusionSatInstances(mod.SAT3Instances(**SIZES), seed=3,
                                     n_label_samples=K, **kw)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_banks_equal_the_tpu_packages(mode):
    want = list(getattr(_wrapped(jgen, 8), f"{mode}_generator")())
    got = list(getattr(_wrapped(tgen, 8), f"{mode}_generator")())
    assert got == want and len(got) == SIZES[f"{mode}_size"]
    for n, clauses, bank in got:
        assert len(bank) == 8 and all(len(row) == n for row in bank)
        for row in bank:
            assert check_assignment(clauses, row)
    # the shards of a split carry the bank size and draw the same banks
    for js, ts in zip(_wrapped(jgen, 8).split(3), _wrapped(tgen, 8).split(3)):
        assert ts.n_label_samples == 8 and ts.seed == js.seed
        assert list(ts.train_generator()) == list(js.train_generator())


def test_uniform_label_on_a_base_without_solutions():
    class NoLabels(tgen.SatInstances):
        def train_generator(self):
            yield 3, [[1, 2], [-1, 3], [-2, -3]], None
            yield 4, [[1, -4], [2, 3]], None

        test_generator = train_generator

    class JNoLabels(jgen.SatInstances):
        train_generator = test_generator = NoLabels.train_generator

    got = list(tgen.DiffusionSatInstances(NoLabels(), seed=7)
               .train_generator())
    want = list(jgen.DiffusionSatInstances(JNoLabels(), seed=7)
                .train_generator())
    assert got == want and all(len(s) == n for n, _, s in got)

    class Unsat(tgen.SatInstances):
        def train_generator(self):
            yield 1, [[1], [-1]], None

        test_generator = train_generator

    with pytest.raises(ValueError, match="UNSAT"):
        list(tgen.DiffusionSatInstances(Unsat()).train_generator())


def test_test_cnf_repeat_mode_equals_the_tpu_packages():
    clauses = [[1, 2, 3], [-1, -2, -3], [4, 5]]
    t = tgen.DiffusionSatInstances(
        tgen.SAT3Instances(**SIZES), test_cnf=CNF(n_vars=5, clauses=clauses),
        test_solutions_multiplier_k=3, seed=2)
    j = jgen.DiffusionSatInstances(
        jgen.SAT3Instances(**SIZES), test_cnf=JCNF(n_vars=5, clauses=clauses),
        test_solutions_multiplier_k=3, seed=2)
    got = list(t.test_generator())
    assert got == list(j.test_generator())
    assert len(got) == 18 * 3 and len({tuple(s) for _, _, s in got}) > 9
    # the training stream is the base generator's, and shards keep the
    # fixed formula
    assert list(t.train_generator()) == list(j.train_generator())
    assert all(s.test_cnf is t.test_cnf for s in t.split(2))


def test_k_bank_cache_equals_the_tpu_packages(tmp_path):
    name = tds.diffusion_3sat_name(3, 12, 10, 8)
    assert name == "diffusion_3sat_3_12_10_k8"
    assert tds.diffusion_3sat_name(3, 12, 10, 1) == "diffusion_3sat_3_12_10"
    argv = ["--train_size", "10", "--max_vars", "12", "--label_samples",
            "8", "--data_dir", str(tmp_path)]
    jcfg = RunConfig(train_size=10, max_vars=12, label_samples=8,
                     data_dir=str(tmp_path))
    assert tdt.build_dataset(parse_config(argv))._cache_path("train") == \
        jdt.build_dataset(jcfg)._cache_path("train")
    j = jds.SatDataset(_wrapped(jgen, 8), JBucketSpec(**BUCKET),
                       cache_dir=tmp_path / "j", name=name, seed=1,
                       gen_workers=2)
    t = tds.SatDataset(_wrapped(tgen, 8), BucketSpec(**BUCKET),
                       cache_dir=tmp_path / "t", name=name, seed=1,
                       gen_shards=2, gen_workers=1)
    jb, tb = j.train_data(), t.train_data()
    assert len(jb) == len(tb) >= 2
    for a, b in zip(jb, tb):
        assert_batches_equal(a, b)
        assert b.solutions_k.shape[0] == 8
    jpath, tpath = j._cache_path("train"), t._cache_path("train")
    assert jpath.name == tpath.name and tpath.name.startswith(name + "_")
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        assert "0/solutions_k" in tz.files
        for key in jz.files:
            np.testing.assert_array_equal(tz[key], jz[key], err_msg=key)


def test_solve_eval_reads_a_k_bank_split(tmp_path, capsys):
    res = solve_eval.main([
        "--model_ckpt", MLK64, "--train_size", "100", "--test_size", "12",
        "--max_vars", "10", "--label_samples", "8", "--test_rounds", "2",
        "--device", "cpu", "--data_dir", str(tmp_path), "--gen_workers",
        "1"])
    assert 0.0 <= res["total_accuracy"] <= 1.0
    (cache,) = tmp_path.iterdir()
    assert cache.name.startswith("diffusion_3sat_3_10_100_k8_test_")
    with np.load(cache) as z:
        assert z["0/solutions_k"].shape[0] == 8
    assert "test batches:" in capsys.readouterr().out
