"""Port vs TPU package: the host tools that are root scripts there and
modules of the port (`dimacs_shuffle`, `cnf_gen`, `evaluate_solvers`,
`diffusion_metrics`). Each is deterministic given its seeds, so the
output bytes, the CSV rows without their times, and the printed lines
must be equal."""

import csv
import importlib
import sys
from pathlib import Path

import pytest

from diffusionsat_torch import cnf_gen as tcnf_gen
from diffusionsat_torch import diffusion_metrics as tmetrics
from diffusionsat_torch import dimacs_shuffle as tshuffle
from diffusionsat_torch import evaluate_solvers as tsolvers

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "diffusionsat_torch" / "data" / "assets"


def _root(name):
    """The TPU package's root script `name`.py as a module."""
    return importlib.import_module(name)


def _run_argv_main(module, argv, monkeypatch):
    """Call a root script's `main()`, which reads sys.argv."""
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


@pytest.mark.parametrize("seed,flip", [(0, False), (3, True), (11, True)])
@pytest.mark.parametrize("name", ["satlib/uf20-synth-2.cnf",
                                  "primes/primes_143_13x11.cnf"])
def test_dimacs_shuffle_writes_the_same_bytes(name, seed, flip, tmp_path,
                                              monkeypatch):
    src = str(ASSETS / name)
    extra = ["--seed", str(seed)] + (["--flip"] if flip else [])
    _run_argv_main(_root("dimacs_shuffle"),
                   [src, str(tmp_path / "j.cnf")] + extra, monkeypatch)
    tshuffle.main([src, str(tmp_path / "t.cnf")] + extra)
    assert (tmp_path / "t.cnf").read_bytes() == \
        (tmp_path / "j.cnf").read_bytes()
    assert (tmp_path / "t.cnf").read_bytes() != Path(src).read_bytes()


def test_cnf_gen_writes_the_same_files(tmp_path, capsys):
    argv = ["--bits_from", "3", "--bits_to", "5", "--samples", "2",
            "--rounds", "8", "--min_vars", "10", "--seed", "1"]
    _root("cnf_gen").main(argv + ["--out_dir", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    tcnf_gen.main(argv + ["--out_dir", str(tmp_path / "t")])
    tout = capsys.readouterr().out
    assert tout.replace(str(tmp_path / "t"), "D") == \
        jout.replace(str(tmp_path / "j"), "D")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 6
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_evaluate_solvers_rows_equal_but_for_times(tmp_path, capsys,
                                                   monkeypatch):
    argv = ["--min_vars", "8", "--max_vars", "20", "--count", "20",
            "--max_flips", "20000"]
    _run_argv_main(_root("evaluate_solvers"),
                   argv + ["--out", str(tmp_path / "j.csv")], monkeypatch)
    jout = capsys.readouterr().out
    tsolvers.main(argv + ["--out", str(tmp_path / "t.csv")])
    tout = capsys.readouterr().out
    assert tout.replace("t.csv", "x") == jout.replace("j.csv", "x")

    def rows(path):
        with open(path) as f:
            r = list(csv.reader(f))
        # the rows sort with their times: compare them without, as sets
        return r[0], sorted((a, b, d) for a, b, _, d, _ in r[1:])

    jhead, jrows = rows(tmp_path / "j.csv")
    assert rows(tmp_path / "t.csv") == (jhead, jrows)
    assert len(jrows) == 20 and all(d == "1" for _, _, d in jrows)


@pytest.mark.parametrize(
    "path", sorted(REPO.glob("benchmarks_*.jsonl")), ids=lambda p: p.name)
def test_diffusion_metrics_prints_the_same(path, capsys):
    argv = ["--benchmarks_file", str(path)]
    _root("diffusion_metrics").main(argv)
    jout = capsys.readouterr().out
    tmetrics.main(argv)
    assert capsys.readouterr().out == jout


def test_diffusion_metrics_without_records(tmp_path, capsys):
    tmetrics.main(["--benchmarks_file",
                   str(REPO / "benchmarks_iso45full_p24.jsonl")])
    assert "uniform/ideal chi2 p=" in capsys.readouterr().out
    tmetrics.main(["--benchmarks_file", str(tmp_path / "none.jsonl")])
    assert capsys.readouterr().out.startswith("no records in")
