"""`BENCHMARK.json` against the rules its checker holds it to, and every
file it names."""

import json
import re

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def bench():
    return harness.benchmark()


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    raw = (harness.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == TOP
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    assert 1 <= len(b["command"]) <= 32
    for word in b["command"]:
        assert line_ok(word) and not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    b = bench()
    for kind, keys in (("configs", {"name", "source", "file", "reduced",
                                    "why"}),
                       ("workloads", {"name", "config", "traffic", "chips",
                                      "why"})):
        names = [e["name"] for e in b[kind]]
        assert len(names) == len(set(names))
        for e in b[kind]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and line_ok(e["why"])
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_references_resolve():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert "setup_s" in e2e
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        tr = harness.load_json("traffic", w["traffic"])
        assert (harness.PKG / "drivers" / f"{tr['driver']}.py").is_file()
        assert w["config"] in tr["limits"]
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == \
            c["reduced"]
        assert (harness.PKG / "reference" / f"{c['name']}.py").is_file()
        assert (harness.PKG / "flops" / f"{c['name']}.py").is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for m in b["per_layer"]:
        assert (harness.PKG / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
    for m in b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    # every cell reports set-up, another end-to-end metric and a
    # per-layer metric
    for w in cells:
        assert any(n != "setup_s" and w in m.get("workloads", cells)
                   for n, m in e2e.items())
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


def test_layers_are_perf_md_layers():
    """Each per-layer metric's `layer` is a layer of PERF.md's list,
    letter for letter."""
    text = (harness.ROOT / "PERF.md").read_text()
    section = text.split("## 3.")[1].split("\n## 4.")[0]
    for m in bench()["per_layer"]:
        assert f"| {m['layer']} |" in section, m["layer"]
