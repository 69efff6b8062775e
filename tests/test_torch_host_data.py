"""Port vs TPU package: the host-built data of the registry's tasks.

k-SAT, the file loaders (SPLOT, SATLIB, primes, mixed), SHA-1 CNF, the
graph tasks (clique, dominating set, k-colour) with the port's own G(n, p)
against networkx's, the factoring CNFs, the bundled assets byte for byte,
and the cached batches of `main`'s datasets: all must be equal exactly.
"""

import filecmp
import importlib
from pathlib import Path

import networkx as nx
import numpy as np
import pytest

from _torch_parity import assert_batches_equal
from diffusionsat_tpu.data import datasets as jds
from diffusionsat_tpu.data import generators as jgen
from diffusionsat_tpu.data import graph_tasks as jgt
from diffusionsat_tpu.data import loaders as jld
from diffusionsat_tpu.data import primes_gen as jpg
from diffusionsat_tpu.data import sha as jsha
from diffusionsat_tpu.graph.batch import BucketSpec as JBucketSpec
from diffusionsat_torch.data import datasets as tds
from diffusionsat_torch.data import generators as tgen
from diffusionsat_torch.data import graph_tasks as tgt
from diffusionsat_torch.data import loaders as tld
from diffusionsat_torch.data import make_assets as tma
from diffusionsat_torch.data import primes_gen as tpg
from diffusionsat_torch.data import sha as tsha
from diffusionsat_torch.graph.batch import BucketSpec

REPO = Path(__file__).resolve().parent.parent
JAX_ASSETS = REPO / "diffusionsat_tpu" / "data" / "assets"
PORT_ASSETS = REPO / "diffusionsat_torch" / "data" / "assets"


def _both(gen_j, gen_t):
    a, b = list(gen_j), list(gen_t)
    assert a == b
    return a


# -- k-SAT -----------------------------------------------------------------

@pytest.mark.parametrize("seed,multiplier", [(0, 10), (3, 1), (7, 4)])
def test_ksat_streams_equal(seed, multiplier):
    kw = dict(min_vars=3, max_vars=12, train_size=12, test_size=5,
              desired_multiplier_for_the_number_of_solutions=multiplier,
              seed=seed)
    j, t = jgen.KSatInstances(**kw), tgen.KSatInstances(**kw)
    items = _both(j.train_generator(), t.train_generator())
    _both(j.test_generator(), t.test_generator())
    assert len(items) == 12 and all(s is None for _, _, s in items)


def test_ksat_splits_as_the_tpu_package():
    kw = dict(min_vars=3, max_vars=10, train_size=11, test_size=6, seed=2)
    js, ts = jgen.KSatInstances(**kw).split(4), \
        tgen.KSatInstances(**kw).split(4)
    assert len(ts) == len(js) == 4
    for j, t in zip(js, ts):
        assert (t.train_size, t.test_size, t.seed, t.multiplier) == \
            (j.train_size, j.test_size, j.seed, j.multiplier)
        _both(j.train_generator(), t.train_generator())
    assert sum(t.train_size for t in ts) == 11


# -- file loaders ------------------------------------------------------------

def test_assets_equal_byte_for_byte_and_regenerate(tmp_path):
    files = sorted(p.relative_to(JAX_ASSETS) for p in JAX_ASSETS.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(PORT_ASSETS)
                           for p in PORT_ASSETS.rglob("*") if p.is_file())
    assert len(files) == 32
    for rel in files:
        assert (PORT_ASSETS / rel).read_bytes() == \
            (JAX_ASSETS / rel).read_bytes(), rel
    tma.main(["--out_dir", str(tmp_path)])
    for rel in files:
        assert filecmp.cmp(tmp_path / rel, JAX_ASSETS / rel, shallow=False)
    assert tld.ASSETS_DIR == PORT_ASSETS


@pytest.mark.parametrize("name,kw", [
    ("SplotInstances", {}), ("SplotInstances", {"test_every_k": 3}),
    ("SatLibInstances", {}), ("SatLibInstances", {"test_fraction": 0.3,
                                                  "seed": 5}),
    ("PrimesInstances", {}), ("PrimesInstances", {"max_vars": 100}),
])
def test_loaders_read_the_ports_assets_as_the_tpu_package_reads_its_own(
        name, kw):
    j, t = getattr(jld, name)(**kw), getattr(tld, name)(**kw)
    train = _both(j.train_generator(), t.train_generator())
    test = _both(j.test_generator(), t.test_generator())
    assert train and len(test) + len(train) > 1
    # the same files named explicitly
    sub = name.replace("Instances", "").lower()
    t2 = getattr(tld, name)(data_dir=JAX_ASSETS / sub, **kw)
    assert list(t2.train_generator()) == train


def test_splot_parses_the_reference_format(tmp_path):
    (tmp_path / "m.xml").write_text(
        "<feature_model name='x'>\n<constraints>\n"
        "Clause3CNF_1:g_2_2_1 OR m_2_5_2 OR m_3_1_1\n"
        "Clause3CNF_2:~g_2_2_1 or g_2_4_1 OR m_3_1_1\n"
        "</constraints>\n</feature_model>\n")
    items = _both(jld.SplotInstances(tmp_path, test_every_k=1)
                  .test_generator(),
                  tld.SplotInstances(tmp_path, test_every_k=1)
                  .test_generator())
    assert items == [(4, [[1, 2, 3], [-1, 4, 3]], None)]


def test_mixed_default_composition_equal():
    kw = dict(train_size=10, test_size=5, seed=1, max_vars=8)
    j, t = jld.MixedInstances(**kw), tld.MixedInstances(**kw)
    assert [type(s).__name__ for s in t.sources] == \
        [type(s).__name__ for s in j.sources]
    items = _both(j.train_generator(), t.train_generator())
    _both(j.test_generator(), t.test_generator())
    assert len(items) >= 10


# -- SHA-1 CNF ---------------------------------------------------------------

@pytest.mark.parametrize("rounds,bits,seed,fixed", [
    (2, 4, 0, None), (4, 8, 3, None), (8, 6, 1, 80), (17, 3, 2, 40)])
def test_sha1_cnf_equal(rounds, bits, seed, fixed):
    kw = dict(rounds=rounds, free_bits=bits, seed=seed,
              hash_bits_fixed=fixed)
    assert tsha.sha1_cnf(**kw) == jsha.sha1_cnf(**kw)


def test_sha1_stream_equal_and_witnessed():
    from diffusionsat_torch.sat.cnf import check_assignment

    kw = dict(rounds=4, min_free_bits=2, max_free_bits=6, train_size=4,
              test_size=2, seed=9)
    items = _both(jsha.Sha1Instances(**kw).train_generator(),
                  tsha.Sha1Instances(**kw).train_generator())
    _both(jsha.Sha1Instances(**kw).test_generator(),
          tsha.Sha1Instances(**kw).test_generator())
    for n, clauses, witness in items:
        assert check_assignment(clauses, witness)


# -- graph tasks -------------------------------------------------------------

def test_gnp_equals_networkx():
    rng = np.random.default_rng(0)
    for _ in range(150):
        n = int(rng.integers(0, 30))
        p = float(rng.choice([0.0, 1.0, 1.5, -0.1, rng.random()]))
        seed = int(rng.integers(0, 1 << 30))
        a, b = nx.gnp_random_graph(n, p, seed=seed), \
            tgt.gnp_random_graph(n, p, seed=seed)
        assert list(a.nodes()) == b.nodes()
        assert list(a.edges()) == b.edges()
        for v in a.nodes():
            assert list(a.neighbors(v)) == list(b.neighbors(v))
            for u in a.nodes():
                assert a.has_edge(u, v) == b.has_edge(u, v)
        k = int(rng.integers(1, 4))
        assert tgt.clique_formula(b, k) == jgt.clique_formula(a, k)
        assert tgt.dominating_set_formula(b, k) == \
            jgt.dominating_set_formula(a, k)
        assert tgt.coloring_formula(b, k) == jgt.coloring_formula(a, k)


@pytest.mark.parametrize("name", ["CliqueInstances", "DomSetInstances",
                                  "KColorInstances"])
def test_graph_task_streams_equal(name):
    kw = dict(min_vertices=4, max_vertices=9, train_size=8, test_size=3,
              seed=4)
    j, t = getattr(jgt, name)(**kw), getattr(tgt, name)(**kw)
    items = _both(j.train_generator(), t.train_generator())
    _both(j.test_generator(), t.test_generator())
    assert len(items) == 8 and all(c for _, c, _ in items)


def test_port_imports_no_networkx():
    src = (REPO / "diffusionsat_torch" / "data" / "graph_tasks.py").read_text()
    assert "networkx" in src and "import networkx" not in src


# -- primes --------------------------------------------------------------------

@pytest.mark.parametrize("n,a,b", [(35, 3, 3), (143, 4, 4), (3599, 6, 6),
                                   (6, 2, 2)])
def test_factoring_cnf_equal(n, a, b):
    assert tpg.factoring_cnf(n, a, b) == jpg.factoring_cnf(n, a, b)


def test_semiprime_instances_and_cli_equal(tmp_path, capsys):
    assert tpg.semiprime_instances(7, seed=3) == \
        jpg.semiprime_instances(7, seed=3)
    jpg.main(["--out_dir", str(tmp_path / "j"), "--count", "5",
              "--seed", "2"])
    jout = capsys.readouterr().out
    tpg.main(["--out_dir", str(tmp_path / "t"), "--count", "5",
              "--seed", "2"])
    assert capsys.readouterr().out == jout
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 5
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


# -- the datasets of `main` ---------------------------------------------------

MAIN_ARGS = ["--train_size", "6", "--test_size", "3", "--min_vars", "4",
             "--max_vars", "9"]
# the file and graph tasks get CDCL labels (uniform labels of their larger
# formulas take minutes to enumerate in either package); the generators
# get uniform labels, `main`'s default
CDCL = ["--use_unigen", "false"]


@pytest.mark.parametrize("task,budget,extra", [
    ("3-sat", 2000, []), ("ksat", 2000, []), ("k-sat", 2000, CDCL),
    ("splot", 2000, CDCL), ("satlib", 2000, CDCL),
    ("primes", 2000, ["--max_vars", "200"] + CDCL), ("mixed", 2000, CDCL),
    ("sha1", 8000, []), ("clique", 2000, CDCL), ("domset", 2000, CDCL),
    ("kcolor", 2000, CDCL)])
def test_main_task_caches_equal_array_for_array(task, budget, extra,
                                                tmp_path):
    jmain = importlib.import_module("main")
    from diffusionsat_tpu.config import parse_config as jparse
    from diffusionsat_torch import main as tmain
    from diffusionsat_torch.config import parse_config as tparse

    argv = ["--task", task] + MAIN_ARGS + extra
    jinst = jmain.build_instances(jparse(argv))
    tinst = tmain.build_instances(tparse(argv))
    splittable = task in ("3-sat", "ksat", "k-sat")
    assert (tinst.split(2) is not None) == splittable
    if task == "sha1":
        # the TPU package's SHA-1 stream has no `split`, so its dataset
        # fails to generate on a host with more than one core; the port's
        # is one stream
        with pytest.raises(AttributeError):
            jinst.split(2)
    else:
        assert (jinst.split(2) is not None) == splittable
    name = f"{task}_cache"
    # one stream each (no shards), as the TPU package generates a
    # registry task that cannot split
    jdata = jds.SatDataset(jinst, JBucketSpec.for_node_budget(budget),
                           cache_dir=tmp_path / "j", name=name,
                           gen_workers=1)
    tdata = tds.SatDataset(tinst, BucketSpec.for_node_budget(budget),
                           cache_dir=tmp_path / "t", name=name,
                           gen_shards=1)
    for split in ("train_data", "test_data"):
        jb = list(getattr(jdata, split)())
        tb = list(getattr(tdata, split)())
        assert len(tb) == len(jb) > 0, (task, split)
        for a, b in zip(jb, tb):
            assert_batches_equal(a, b)
    # the port reads the cache the TPU package wrote, under the same name
    jfile = next((tmp_path / "j").glob("*_train_*.npz"))
    assert (tmp_path / "t" / jfile.name).exists()


def test_sharded_ksat_cache_equals_the_tpu_packages(tmp_path):
    """k-SAT splits: the port's 2 shards, generated in this process, hold
    the batches the TPU package generates with 2 worker processes."""
    kw = dict(min_vars=3, max_vars=10, train_size=14, test_size=4, seed=1)
    jinst = jgen.DiffusionSatInstances(jgen.KSatInstances(**kw), seed=1)
    tinst = tgen.DiffusionSatInstances(tgen.KSatInstances(**kw), seed=1)
    jb = list(jds.SatDataset(jinst, JBucketSpec.for_node_budget(1000),
                             cache_dir=tmp_path / "j", name="k",
                             gen_workers=2).train_data())
    tb = list(tds.SatDataset(tinst, BucketSpec.for_node_budget(1000),
                             cache_dir=tmp_path / "t", name="k",
                             gen_shards=2, gen_workers=1).train_data())
    assert len(tb) == len(jb) > 0
    for a, b in zip(jb, tb):
        assert_batches_equal(a, b)
    assert sum(int(b.n_graphs) for b in tb) == 14
