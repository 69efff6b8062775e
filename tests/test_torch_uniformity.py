"""Port vs TPU package: the uniformity battery.

The host parts (panel formulas, refiners, statistics, the record store) are
held exactly against the TPU package and against the repo's recorded p24
panel (`benchmarks_iso45full_p24.jsonl`). The diffusion samplers draw from
different random streams, so the two packages' samplers are held against
each other statistically: a chi-square test of homogeneity between their
solution histograms.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.stats import chi2_contingency, norm

import jax

from _torch_parity import torch_params
from diffusionsat_tpu.diffusion import sampler as jsam
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.sat.cnf import CNF as JCNF
from diffusionsat_tpu.uniformity import samplers as jsamplers
from diffusionsat_tpu.utils import chi_square as jchi
from diffusionsat_torch import uniformity_benchmark as tub
from diffusionsat_torch.diffusion import sampler as tsam
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.sat.cnf import CNF, VariableAssignment
from diffusionsat_torch.sat.solvers import count_models, enumerate_models
from diffusionsat_torch.uniformity import samplers as tsamplers
from diffusionsat_torch.uniformity.benchmarks_file import (
    BenchmarksFile,
    formula_key,
)
from diffusionsat_torch.utils import chi_square as tchi

REPO = Path(__file__).resolve().parent.parent
PANEL = REPO / "benchmarks_iso45full_p24.jsonl"
MLK64 = "pretrained/query_sat_3sat_diffusion_mlk64.npz"


@pytest.fixture(scope="module")
def panel():
    """The 24 p24 formulas as the port generates them, beside the repo's
    recorded records of the same panel."""
    records = [json.loads(line) for line in PANEL.read_text().splitlines()]
    return tub.gen_benchmark_formulas(24, seed=0), records


def test_panel_keys_equal_the_recorded_panel(panel):
    formulas, records = panel
    assert [formula_key(c) for _, c, _ in formulas] == \
        [r["key"] for r in records]
    for (n, clauses, models), r in zip(formulas, records):
        assert (n, len(clauses), len(models)) == \
            (r["n_vars"], r["n_clauses"], r["n_solutions"])


def _counts(record, variant):
    return {int(k): v for k, v in record[variant]["counts"].items()}


@pytest.mark.parametrize("kind", ["mh", "mh_xor"])
def test_refiners_give_the_tpu_packages_counts(panel, kind):
    """Both refiners from the recorded nofreeze counts of the two smallest
    panel formulas, with the benchmark's seeds: identical counts."""
    formulas, records = panel
    smallest = sorted(range(24), key=lambda i: records[i]["n_samples"])[:2]
    for fi in smallest:
        n, clauses, _ = formulas[fi]
        counts = _counts(records[fi], "diffusion_nofreeze")
        if kind == "mh":
            t = tsamplers.MetropolisRefiner(CNF(n_vars=n, clauses=clauses),
                                            None, seed=17 + fi)
            j = jsamplers.MetropolisRefiner(JCNF(n_vars=n, clauses=clauses),
                                            None, seed=17 + fi)
        else:
            t = tsamplers.XorCellJumpRefiner(
                CNF(n_vars=n, clauses=clauses), None, seed=27 + fi)
            j = jsamplers.XorCellJumpRefiner(
                JCNF(n_vars=n, clauses=clauses), None, seed=27 + fi)
        got = t.refine(counts)
        assert got == j.refine(counts)
        assert sum(got.values()) == sum(counts.values())
        ideal = tub.keyed_uniform_ideal(formulas[fi][2], t.cnf, 1)
        unsat = next(k for k in range(1 << n) if k not in ideal)
        with pytest.raises(ValueError, match="UNSAT"):
            t.refine({unsat: 1})


def test_count_stats_equal_the_recorded_panel(panel):
    """chi2 p and count entropy from the recorded counts, to 1e-12."""
    formulas, records = panel
    checked = 0
    for (n, clauses, models), rec in zip(formulas, records):
        cnf = CNF(n_vars=n, clauses=clauses)
        for variant, want in rec.items():
            if not isinstance(want, dict) or "counts" not in want:
                continue
            counts = _counts(rec, variant)
            got = tub.count_stats(counts, models, cnf, rec["n_samples"])
            np.testing.assert_allclose(got["chi2_p"], want["chi2_p"],
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got["count_entropy"],
                                       want["count_entropy"], rtol=0,
                                       atol=1e-12)
            for key in ("distinct", "true_solutions", "n_collected",
                        "diversity", "uniform_entropy"):
                assert got[key] == want[key], key
            ideal = tub.keyed_uniform_ideal(models, cnf, got["n_collected"])
            assert tchi.chi_square_likelihood(counts, ideal) == \
                jchi.chi_square_likelihood(counts, ideal)
            checked += 1
    assert checked == 24 * 3
    assert tchi.ideal_counts(4, 10) == jchi.ideal_counts(4, 10)
    assert tchi.chi_square_likelihood({1: 5}, {2: 3.0}) == 1.0


def test_benchmarks_file_round_trips_and_the_report_reads_it(tmp_path):
    clauses = [[1, 2, 3], [-1, -2, -3], [4, 5]]
    cnf = CNF(n_vars=5, clauses=clauses)
    counts = tsamplers.ExactUniformSampler(cnf, seed=0).samples(180)
    assert counts == jsamplers.ExactUniformSampler(
        JCNF(n_vars=5, clauses=clauses), seed=0).samples(180)
    models, _ = enumerate_models(clauses, 5)
    record = {"formula": 0, "n_vars": 5, "n_clauses": 3, "n_solutions": 18,
              "n_samples": 180,
              "uniform": {"counts": {str(k): v for k, v in counts.items()},
                          **tub.count_stats(counts, models, cnf, 180)}}
    store = BenchmarksFile(tmp_path / "b.jsonl")
    store.write(clauses, record)
    (back,) = store.find(clauses)
    assert back == {"key": formula_key(clauses), **record}
    assert store.read_all() == [back]
    assert BenchmarksFile(tmp_path / "none.jsonl").read_all() == []
    res = subprocess.run(
        [sys.executable, str(REPO / "uniformity_report.py"),
         str(tmp_path / "b.jsonl"), "--json", str(tmp_path / "s.json")],
        capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    summary = json.loads((tmp_path / "s.json").read_text())
    assert summary["uniform"]["n_formulas"] == 1
    assert summary["uniform"]["mean_diversity"] == 1.0


def _small_formula():
    """A 6-8 variable formula with about 10 solutions."""
    rng = np.random.default_rng(0)
    while True:
        n = int(rng.integers(6, 9))
        clauses = [[int(v) if rng.random() < 0.5 else -int(v)
                    for v in (rng.choice(n, 3, replace=False) + 1)]
                   for _ in range(3 * n)]
        if 8 <= count_models(clauses, n)[0] <= 12:
            return n, clauses


@pytest.mark.parametrize("freeze_sat", [True, False])
def test_sampler_histograms_are_homogeneous(freeze_sat):
    """400 samples from each package's sampler, a random 16-map model, 4
    diffusion steps of 2 rounds: a chi-square test of homogeneity between
    the two solution histograms, and a two-proportion test of the success
    rates, each at p > 1e-3."""
    n, clauses = _small_formula()
    kw = dict(feature_maps=16, query_maps=16, logit_maps=4, test_rounds=2)
    jcfg, tcfg = jqs.QuerySATConfig(**kw), tqs.QuerySATConfig(**kw)
    jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
    common = dict(diffusion_steps=4, test_rounds=2, seed=1,
                  graphs_per_batch=128, freeze_sat=freeze_sat)
    js = jsam.DiffusionSampler(jparams, jcfg, JCNF(n_vars=n, clauses=clauses),
                               **common)
    ts = tsam.DiffusionSampler(torch_params(jparams), tcfg,
                               CNF(n_vars=n, clauses=clauses), device="cpu",
                               **common)
    assert ts.dense and js.dense
    jc, tc = js.samples(400), ts.samples(400)
    assert sum(jc.values()) == sum(tc.values()) == 400
    for key in tc:
        asgn = VariableAssignment(n, clauses)
        asgn.assign_all_from_int(key)
        assert asgn.satisfiable()
    keys = sorted(set(jc) | set(tc))
    table = np.array([[jc.get(k, 0) for k in keys],
                      [tc.get(k, 0) for k in keys]])
    assert chi2_contingency(table)[1] > 1e-3, table
    # success rates over the copies drawn until 400 satisfied
    nj, nt = 400 / js.success_rate, 400 / ts.success_rate
    pool = (js.success_rate * nj + ts.success_rate * nt) / (nj + nt)
    z = (js.success_rate - ts.success_rate) / np.sqrt(
        pool * (1 - pool) * (1 / nj + 1 / nt))
    assert 2 * norm.sf(abs(z)) > 1e-3, (js.success_rate, ts.success_rate)


def test_battery_cli_gives_the_tpu_packages_host_records(tmp_path):
    """The host variants of the battery, through both packages' CLIs:
    the same records but for the wall times; the port's diffusion variants
    run on the CPU beside them."""
    import uniformity_benchmark as jub

    host = "uniform,walksat,walksat_mh,walksat_mh_xor"
    common = ["--n_formulas", "1", "--k", "1", "--summary_out"]
    jsum = jub.main(common + [str(tmp_path / "js.json"), "--variants", host,
                              "--out", str(tmp_path / "j.jsonl")])
    tsum = tub.main(common + [str(tmp_path / "ts.json"), "--variants",
                              host + ",diffusion_mh_xor,diffusion_sample_t0.9",
                              "--model_ckpt", MLK64, "--diffusion_steps", "2",
                              "--test_rounds", "2", "--device", "cpu",
                              "--out", str(tmp_path / "t.jsonl")])
    (jrec,) = BenchmarksFile(tmp_path / "j.jsonl").read_all()
    (trec,) = BenchmarksFile(tmp_path / "t.jsonl").read_all()
    for name in host.split(","):
        for rec in (jrec, trec):
            for key in ("elapsed_s", "ms_per_distinct", "refine_s"):
                rec[name].pop(key, None)
        assert trec[name] == jrec[name], name
        assert tsum[name] == jsum[name]
    assert trec["diffusion_mh_xor"]["n_collected"] == trec["n_samples"]
    assert "refine_s" in trec["diffusion_mh_xor"]
    assert set(tsum) == set(host.split(",")) | {"diffusion_mh_xor",
                                                "diffusion_sample_t0.9"}


def test_evaluation_cli_gives_the_tpu_packages_host_records(tmp_path):
    import diffusion_evaluation as jde
    from diffusionsat_torch import diffusion_evaluation as tde

    cnf_path = tmp_path / "f.cnf"
    cnf_path.write_text(CNF(n_vars=5, clauses=[[1, 2, 3], [-1, -2, -3],
                                               [4, 5]]).to_string())
    jde.main(["--dimacs", str(cnf_path), "--k", "3", "--benchmarks_file",
              str(tmp_path / "j.jsonl")])
    trec = tde.main(["--dimacs", str(cnf_path), "--k", "3",
                     "--model_ckpt", MLK64, "--diffusion_steps", "2",
                     "--test_rounds", "2", "--device", "cpu",
                     "--benchmarks_file", str(tmp_path / "t.jsonl")])
    (jrec,) = BenchmarksFile(tmp_path / "j.jsonl").read_all()
    assert BenchmarksFile(tmp_path / "t.jsonl").read_all()[0]["key"] == \
        jrec["key"]
    for name in ("uniform", "walksat"):
        for rec in (jrec, trec):
            rec[name].pop("elapsed_s")
            rec[name].pop("ms_per_distinct")
        assert trec[name] == jrec[name]
        assert trec[f"{name}_chi2_p"] == jrec[f"{name}_chi2_p"]
    assert trec["n_solutions"] == jrec["n_solutions"] == 18
    assert 0.0 <= trec["diffusion"]["success_rate"] <= 1.0
    assert "diffusion_chi2_p" in trec
