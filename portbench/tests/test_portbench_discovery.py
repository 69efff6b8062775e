"""The harness finds configurations, mixes, drivers, references and
metrics by the names `BENCHMARK.json` gives, and a cell added as files
and entries alone runs."""

import json
import shutil
import subprocess
import sys
import types

from portbench import harness
from portbench import run as run_mod

from _small import small


def test_every_named_file_loads():
    b = harness.benchmark()
    for c in b["configs"]:
        harness.load_json("configs", c["name"])
        ref = harness.load_module("reference", c["name"])
        assert callable(ref.init_params) and callable(ref.flatten)
        assert callable(harness.load_module("flops", c["name"]).step_flops)
    for w in b["workloads"]:
        tr = harness.load_json("traffic", w["traffic"])
        assert hasattr(harness.load_module("drivers", tr["driver"]), "Cell")
    for m in b["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_a_metric_that_finds_nothing_is_left_out():
    rec = harness.Record()
    run = types.SimpleNamespace(rec=rec, config={}, traffic={},
                                config_name="querysat-3sat-128",
                                peaks=harness.peaks())
    for m in harness.benchmark()["per_layer"]:
        if m["name"] in ("graph_capture_s", "prepare_s"):
            continue
        assert harness.load_module("metrics", m["name"]).read(run) is None


def test_a_cell_added_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix (a data file), a
    per-layer metric (a reader file) and a cell (entries); the copy's run
    finds all three by name, on the CPU at a small size."""
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    b = harness.benchmark()
    tr = harness.load_json("traffic", "threshold3sat-solve-2016")
    tr["about"] = "the solving mix at 40 formulas of every size"
    tr["formulas_per_size"] = 40
    (tmp_path / "portbench" / "traffic" / "threshold3sat-solve-1120.json") \
        .write_text(json.dumps(tr))
    (tmp_path / "portbench" / "metrics" / "window_calls.py").write_text(
        "def read(run):\n    return float(len(run.rec.spans))\n")
    b["workloads"].append({"name": "qs-solve-small", "config":
                           "querysat-3sat-128", "traffic":
                           "threshold3sat-solve-1120", "chips": 1,
                           "why": "a cell added by files alone"})
    for m in b["end_to_end"]:
        if m["name"] == "solve_graphs_per_s":
            m["workloads"].append("qs-solve-small")
    b["per_layer"].append({"name": "window_calls", "unit": "calls",
                           "better": "lower", "source": "host_clock",
                           "layer": "model round loop",
                           "moves": "solve_graphs_per_s",
                           "workloads": ["qs-solve-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    over = small("qs-solve-flat", formulas_per_size=2)
    code = (
        "import json, sys, types\n"
        "from portbench import run\n"
        "assert run.harness.ROOT.resolve() == __import__('pathlib')"
        ".Path.cwd().resolve()\n"
        "out = {}\n"
        "for t in (0, 1):\n"
        "    a = types.SimpleNamespace(workload='qs-solve-small', seed=11,"
        " seconds=0.5, trace=t)\n"
        f"    out[t] = run.run(a, device='cpu', overrides={over!r})\n"
        "print(json.dumps(out))\n")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": f"{tmp_path}:{harness.ROOT}", "PATH": "/usr/bin"
             ":/bin:/usr/local/bin", "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["0"]["correct"] is True
    assert set(out["0"]["metrics"]) == {"solve_graphs_per_s", "setup_s"}
    assert out["1"]["metrics"]["window_calls"]["value"] > 0


def test_unknown_workload_is_refused():
    import pytest
    with pytest.raises(SystemExit):
        run_mod.cell_spec("no-such-cell")
