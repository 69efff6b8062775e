"""The port's flagship 3-SAT cache builder against the TPU package's root
`build_3sat_cache.py`: the same run config, the same files and arrays on a
cut config, and a test split equal to the one `solve_eval` makes under the
same name."""

import dataclasses
import sys

import numpy as np
import pytest

import build_3sat_cache as jbuild
import diffusion_training as jdt
from diffusionsat_tpu.config import RunConfig as JRunConfig
from diffusionsat_tpu.data import datasets as jds
from diffusionsat_torch import build_3sat_cache as tbuild
from diffusionsat_torch import solve_eval
from diffusionsat_torch.config import RunConfig

# a cut of the flagship's sizes: its 20000-node budget, fewer and smaller
# instances
CUT = dict(train_size=32, test_size=16, min_vars=3, max_vars=8,
           max_nodes_per_batch=20000)


class _Recorded:
    """A dataset that records its config and generates nothing."""

    def __init__(self, seen, cfg):
        seen.append(cfg)

    def train_data(self):
        return []

    def test_data(self):
        return []


@pytest.mark.parametrize("k", [1, 64])
def test_main_builds_the_tpu_scripts_config(monkeypatch, k, capsys):
    seen_j, seen_t = [], []
    monkeypatch.setattr(jdt, "build_dataset",
                        lambda cfg: _Recorded(seen_j, cfg))
    monkeypatch.setattr(tbuild, "build_dataset",
                        lambda cfg: _Recorded(seen_t, cfg))
    monkeypatch.setattr(sys, "argv", ["build_3sat_cache.py",
                                      "--label_samples", str(k)])
    jbuild.main()
    want = capsys.readouterr().out
    tbuild.main(["--label_samples", str(k)])
    assert capsys.readouterr().out == want
    (jcfg,), (tcfg,) = seen_j, seen_t
    for f in dataclasses.fields(JRunConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.train_size, tcfg.label_samples) == (60000, k)


def _serial_tpu_draw(instances, mode, workers=None):
    """The TPU package's draw on a host of 16 or more cores (16 seed-split
    shards, joined in order), made in this process."""
    return [inst for shard in instances.split(16)
            for inst in jds._run_shard((shard, mode))]


def _arrays(directory):
    out = {}
    for path in sorted(directory.iterdir()):
        with np.load(path) as z:
            out[path.name] = {k: z[k] for k in z.files}
    return out


def _assert_files_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, arrays in want.items():
        assert sorted(got[name]) == sorted(arrays), name
        for key, a in arrays.items():
            b = got[name][key]
            assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {key}")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's `build` on the cut config, once per label count."""
    cache = {}

    def get(k):
        if k not in cache:
            d = tmp_path_factory.mktemp(f"port_k{k}")
            tr, te = tbuild.build(RunConfig(
                **CUT, label_samples=k, data_dir=str(d), gen_workers=1))
            assert len(tr) >= 1 and len(te) >= 1
            cache[k] = d
        return cache[k]

    return get


@pytest.mark.parametrize("k", [1, 3])
def test_build_writes_the_tpu_packages_files(built, tmp_path, monkeypatch,
                                             k):
    monkeypatch.setattr(jds, "_generate_instances", _serial_tpu_draw)
    ds = jdt.build_dataset(JRunConfig(**CUT, label_samples=k,
                                      data_dir=str(tmp_path)))
    ds.train_data()
    ds.test_data()
    got = _arrays(built(k))
    assert len(got) == 2
    _assert_files_equal(got, _arrays(tmp_path))


@pytest.mark.parametrize("k", [1, 3])
def test_test_split_equals_solve_evals(built, tmp_path, k):
    solve_eval.build_dataset(
        CUT["train_size"], CUT["test_size"], CUT["min_vars"],
        CUT["max_vars"], seed=0, data_dir=str(tmp_path), gen_workers=1,
        label_samples=k).test_data()
    want = _arrays(tmp_path)
    (name,) = want
    assert "_test_" in name
    _assert_files_equal({name: _arrays(built(k))[name]}, want)
