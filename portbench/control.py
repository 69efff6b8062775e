"""Readings that the limits of `correct` are set from, for one cell.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 \
        [--control <precision>] [--faults half_batch ...]

For each seed: the set-up of a run up to the first steps, which the
reference follows (no warm-up, no window), and

- `program`: the program against the reference (the lower reading);
- `control`: the reference computed one precision below the one the
  configuration states, in the program's place (an upper reading);
- each fault planted in the program (an upper reading where it fails).

One JSON line a reading. The benchmark's own runs never run this. A
state that a step leaves unchanged reads 1 by `compare.training` and needs
no run. Faults:

- `half_batch` (training): half of every batch left out of the loss, the
  mean taken over the rest (dense QuerySAT: the head-weighted loss over
  the first half of the graphs, doubled; ANFSAT: the cross-entropy's
  variable mask zeroed on the second half of each batch's systems);
- `answer_altered` (solving): the first formula's logits of every batch
  negated where the predict step produces them.

A solving cell runs a short window (`--seconds`) at its own load and
compares as many answers as a run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import types

if __package__ in (None, ""):
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve()
                           .parent.parent))
from portbench import compare, harness  # noqa: E402
from portbench import run as run_mod  # noqa: E402


@contextlib.contextmanager
def planted(fault: str | None, driver_name: str):
    """The program with `fault` planted in it, for the body."""
    if fault is None:
        yield None
        return
    if fault == "half_batch" and driver_name == "train_dense":
        from diffusionsat_torch.models import query_sat_dense as qsd
        orig = qsd._head_weighted_loss

        def half(per_graph_loss, k):
            return 2 * orig(per_graph_loss[:per_graph_loss.shape[0] // 2], k)
        qsd._head_weighted_loss = half
        try:
            yield None
        finally:
            qsd._head_weighted_loss = orig
        return
    if fault == "half_batch" and driver_name == "train_anf":
        yield "mask_second_half"
        return
    if fault == "answer_altered" and driver_name == "solve_flat":
        from diffusionsat_torch.train import loop
        orig = loop.make_predict_step

        def altered(*a, **kw):
            step = orig(*a, **kw)

            def predict(params, batch, *b, **k):
                out = step(params, batch, *b, **k)
                first = (batch.var_graph == 0).to(out["prediction"].dtype)
                out["prediction"] = out["prediction"] * (1 - 2 * first)
                return out
            return predict
        loop.make_predict_step = altered
        try:
            yield None
        finally:
            loop.make_predict_step = orig
        return
    raise SystemExit(f"no fault {fault!r} for driver {driver_name!r}")


def mask_second_half(cell):
    """The ANF feed with the variables of each batch's second half of
    systems out of the loss's mask."""
    batch, plans = cell.chunks[0]
    out = batch.var_graph >= ((batch.n_graphs[:, None] + 1) // 2)
    batch.var_mask.masked_fill_(out, 0.0)


def readings(workload: str, seed: int, control: str | None, faults,
             device: str = "cuda", overrides: dict | None = None,
             seconds: float = 3.0):
    harness.set_cache_dirs()
    import torch

    spec = run_mod.cell_spec(workload)
    overrides = overrides or {}
    config = dict(harness.load_json("configs", spec["config"]),
                  **overrides.get("config", {}))
    traffic = dict(harness.load_json("traffic", spec["traffic"]),
                   **overrides.get("traffic", {}))
    driver = harness.load_module("drivers", traffic["driver"])

    def ctx():
        return types.SimpleNamespace(
            workload=workload, config_name=spec["config"], config=config,
            traffic=traffic, seed=seed, device=torch.device(device),
            rec=harness.Record(), trace=False, check_only=True)

    if traffic["driver"] == "solve_flat":
        return solve_readings(driver, ctx, seed, control, faults, seconds,
                              device)
    out = []
    for fault in [None] + list(faults):
        t0 = time.perf_counter()
        with planted(fault, traffic["driver"]) as feed_fault:
            if feed_fault is None:
                cell = driver.Cell(ctx())
            else:
                # the feed is broken before the first step
                cls = type("Faulty", (driver.Cell,), {
                    "prepare": lambda self: (driver.Cell.prepare(self),
                                             mask_second_half(self))})
                cell = cls(ctx())
        ref = cell.reference_run("f32")
        out.append({"seed": seed, "reading": fault or "program",
                    **compare.training(cell.prog, ref),
                    "seconds": time.perf_counter() - t0,
                    "losses": cell.prog["losses"],
                    "ref_losses": ref["losses"]})
        if fault is None and control:
            ctl = dict(cell.reference_run(control), at=cell.prog["at"])
            out.append({"seed": seed, "reading": f"control_{control}",
                        **compare.training(ctl, ref),
                        "losses": ctl["losses"]})
        del cell
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def solve_readings(driver, ctx, seed, control, faults, seconds, device):
    import torch

    out = []
    for fault in [None] + list(faults):
        t0 = time.perf_counter()
        with planted(fault, "solve_flat"):
            cell = driver.Cell(ctx())
            cell.window(seconds)
        picks = cell.picks()
        answers = [cell.collect.preds[c] for c in picks]
        ref = cell.reference_answers(picks, "f32")
        out.append({"seed": seed, "reading": fault or "program",
                    **cell.compare(picks, answers, ref),
                    "seconds": time.perf_counter() - t0})
        if fault is None and control:
            out.append({"seed": seed, "reading": f"control_{control}",
                        **cell.compare(picks, cell.reference_answers(
                            picks, control), ref)})
        del cell
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        for r in readings(args.workload, seed, args.control, args.faults,
                          seconds=args.seconds):
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
