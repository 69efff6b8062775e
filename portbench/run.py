"""Run one cell of the benchmark once and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of `workloads` in `BENCHMARK.json`: a configuration
(`portbench/configs/`) under a traffic mix (`portbench/traffic/`), whose
`driver` (`portbench/drivers/`) sets the program up, drives it for the
window and hands its outputs to the check against the plain reference
(`portbench/reference/`). Set-up makes the inputs and the weights from the
seed, drives the first steps and warms up every shape the window uses.
The window measures for `--seconds`; with `--trace 1` a stretch of it is
profiled and the per-layer metrics (`portbench/metrics/`) are read instead
of the end-to-end ones. Then the program's state is freed and the check
runs. The last line of standard output is one JSON object; the numbers
compared are the last lines of standard error.

It measures `diffusionsat_torch` on CUDA only: without a card, or with
fewer cards than the cell asks for, it exits with code 2 and no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

if __package__ in (None, ""):
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve()
                           .parent.parent))
from portbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_spec(workload: str, bench: dict | None = None) -> dict:
    bench = bench or harness.benchmark()
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def run(args, device: str = "cuda", overrides: dict | None = None,
        modules=None) -> dict:
    """One run of one cell. `device="cpu"` (tests only) skips the look for
    a card; `overrides` replace configuration and traffic keys (tests at
    small sizes); `modules` stands in for `sys.modules` in the import
    check. Returns the result object, or exits with code 2 where the
    machine lacks the cards."""
    harness.set_cache_dirs()
    import torch

    bench = harness.benchmark()
    spec = cell_spec(args.workload, bench)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < spec["chips"]:
            harness.log(f"{args.workload} needs {spec['chips']} CUDA "
                        f"card(s); this machine has "
                        f"{torch.cuda.device_count()}")
            raise SystemExit(2)
    overrides = overrides or {}
    config = dict(harness.load_json("configs", spec["config"]),
                  **overrides.get("config", {}))
    traffic = dict(harness.load_json("traffic", spec["traffic"]),
                   **overrides.get("traffic", {}))
    driver = harness.load_module("drivers", traffic["driver"])
    rec = harness.Record()
    ctx = types.SimpleNamespace(
        workload=args.workload, config_name=spec["config"], config=config,
        traffic=traffic, seed=args.seed, device=torch.device(device),
        rec=rec, trace=bool(args.trace))

    if device == "cuda":
        harness.log(f"card: {harness.card_line()}")
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = driver.Cell(ctx)
    cell.sync()
    setup_s = time.perf_counter() - t0
    harness.log(f"set-up {setup_s:.3f} s")
    win = cell.window(args.seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    harness.log(f"window {win['seconds']:.3f} s, {win['attempted']} "
                f"attempted, {win['failed']} failed")
    cell.release()
    t1 = time.perf_counter()
    checks = cell.check()
    harness.log(f"check {time.perf_counter() - t1:.3f} s")

    held = modules if modules is not None else sys.modules
    found = harness.forbidden_modules(list(held))
    if found:
        harness.log(f"the process holds forbidden modules: {found}")
        raise SystemExit(3)

    run_info = types.SimpleNamespace(
        workload=args.workload, config_name=spec["config"], config=config,
        traffic=traffic, rec=rec, peaks=harness.peaks())
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if not applies(m, args.workload):
                continue
            value = harness.load_module("metrics", m["name"]).read(run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(cell.end_to_end(win), setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, args.workload) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    correct = win["failed"] == 0 and all(c["value"] <= c["limit"]
                                         for c in checks.values())
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics}
    if device == "cuda":
        result["device"] = harness.device_info(torch, spec["chips"], peak)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    if args.trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s()
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = checks
    for name, c in checks.items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    args = parse(argv)
    result = run(args)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
