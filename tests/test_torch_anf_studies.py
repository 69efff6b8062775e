"""Port vs TPU package: the ANF error-structure study and the input-prior
study.

The structure study runs on a cut split (3-round systems, 4-8 free bits)
at width 16 and 4 rounds, with the TPU package's random params carried
across and its query noise replayed (the key of batch i is the i-th split
of `key(9)`): every per-system record and the summary but `elapsed_s`
must equal the TPU package's exactly. The prior study runs the first 4
systems of the repo's `ANF_MARG_R17_FB2440.npz`: both packages drive the
same native CDCL source with the same seeds, so every arm's conflicts and
outcome equal, and so does the summary but its times.
"""

import importlib.util
import itertools
import json
from pathlib import Path

import pytest

import jax

import anf_error_structure as jstudy
from _torch_parity import jax_anf_round_noise
from diffusionsat_tpu.models import anf_sat as jmodel
from diffusionsat_tpu.train.checkpoint import export_params
from diffusionsat_torch import anf_error_structure as tstudy
from diffusionsat_torch import anf_prior_study as tprior
from diffusionsat_torch.models import anf_sat as tmodel

REPO = Path(__file__).resolve().parent.parent
DATA = ["--rounds", "3", "--min_free_bits", "4", "--max_free_bits", "8",
        "--max_vars", "256", "--max_ands", "256", "--max_clauses", "256",
        "--max_edges", "1024", "--max_graphs", "4", "--test_size", "12",
        "--train_size", "12"]
ROUNDS = 4


@pytest.mark.parametrize("ladders", [
    ["--input_anchor"],
    ["--input_anchor", "--skip_frac_ladder", "--anchor_release", "0,1,all"],
    ["--release_fracs", "0.1,0.3", "--max_batches", "2"],
])
def test_structure_study_equals_the_tpu_packages(ladders, tmp_path,
                                                 monkeypatch, capsys):
    ckpt = tmp_path / "tiny.npz"
    jcfg = jmodel.ANFSATConfig(feature_maps=16, query_maps=16)
    export_params(jmodel.anf_sat_init(jax.random.key(0), jcfg), ckpt,
                  meta={"model": "anf_sat"})
    opts = ["--ckpt", str(ckpt), "--feature_maps", "16", "--test_rounds",
            str(ROUNDS)] + DATA + ladders
    monkeypatch.chdir(tmp_path)          # the TPU package's cache directory
    want = jstudy.main(opts + ["--out", str(tmp_path / "j.json")])

    # the TPU package's key schedule: batch i's noise from the i-th split
    key = jax.random.key(9)
    calls = itertools.count()

    def apply(params, cfg, batch, generator=None, **kw):
        nonlocal key
        key, sub = jax.random.split(key)
        next(calls)
        noise = jax_anf_round_noise(sub, cfg.test_rounds, batch.V)
        return tmodel.anf_sat_apply(params, cfg, batch, generator,
                                    round_noise=noise, **kw)

    monkeypatch.setattr(tstudy, "anf_sat_apply", apply)
    capsys.readouterr()
    got = tstudy.main(opts + ["--out", str(tmp_path / "t.json"), "--device",
                              "cpu", "--data_dir",
                              str(tmp_path / "data_cache")])
    tj = json.loads((tmp_path / "t.json").read_text())
    jj = json.loads((tmp_path / "j.json").read_text())
    assert tj["systems"] == jj["systems"]
    assert len(tj["systems"]) == got["n_systems"] > 4
    for summary in (got, want, tj["summary"], jj["summary"]):
        assert summary.pop("elapsed_s") >= 0
    assert got == want == tj["summary"] == jj["summary"]
    n_batches = int(capsys.readouterr().out.split(" test batches")[0])
    assert next(calls) == n_batches == (2 if "--max_batches" in ladders
                                        else 3)
    # the ladders ran: some system took a rung beyond the first
    rungs = [r.get("anchor_solved_at", r["solved_at_frac"])
             for r in tj["systems"]]
    assert any(r not in (None, "0", 0.0) for r in rungs)


def _jax_prior_study():
    spec = importlib.util.spec_from_file_location(
        "jax_anf_prior_study", REPO / "benchmarks" / "anf_prior_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prior_study_equals_the_tpu_packages(tmp_path, monkeypatch):
    marg = str(REPO / "ANF_MARG_R17_FB2440.npz")
    monkeypatch.chdir(tmp_path)          # the TPU package's cache directory
    got, per = tprior.main(["--marginals", marg, "--max_systems", "4",
                            "--data_dir", str(tmp_path / "data_cache"),
                            "--json", str(tmp_path / "t.json")])
    # the TPU package's script reads the split the port cached
    _jax_prior_study().main(["--marginals", marg, "--max_systems", "4",
                             "--json", str(tmp_path / "j.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()).keys() == \
        want.keys()
    assert len(per) == len(want["per_system"]) == 4
    arms = ("plain", "seed_free", "seed_all", "input_first", "oracle")
    for mine, theirs in zip(per, want["per_system"]):
        for k in ("n_free", "n_cnf_vars", "n_cnf_clauses"):
            assert mine[k] == theirs[k]
        for a in arms:
            assert mine[a]["conflicts"] == theirs[a]["conflicts"], a
            assert mine[a]["solved"] == theirs[a]["solved"] is True
    for a in arms:
        for k in ("solved", "conflicts_median", "conflicts_mean",
                  "conflicts_p90", "win_rate_vs_plain",
                  "median_conflict_reduction_x"):
            assert got[a].get(k) == want[a].get(k), (a, k)
    # the repo's record of the whole study: its first 4 systems
    record = json.loads((REPO / "ANF_PRIOR_R17_FB2440.json").read_text())
    for mine, rec in zip(per, record["per_system"]):
        assert [mine[a]["conflicts"] for a in arms] == \
            [rec[a]["conflicts"] for a in arms]
