"""Evaluation harness: generalization sweeps, invariance tests, baselines.

Counterpart of the TPU package's `evaluation/harness.py`, with its ten
functions: variable-count, recurrence-depth (`test_rounds`) and batch-size
generalization, the classic-solver baseline, formula extraction, the two
invariance transforms (variable permutation, literal-polarity inversion)
with `test_invariance`, and the cactus CSV.

The functions take batches of host (CPU) tensors, as a `SatDataset`
returns them. Each flat batch runs with its kernel plans, host-built from
the batch that is evaluated: a transformed batch gets plans of its own
edges, so on the card its aggregations go through the segsum kernel on the
new graph. Where the TPU package seeds a key, a function here seeds a
`torch.Generator` on the device with the same number.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import time
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.losses.sat import is_graph_sat
from diffusionsat_torch.train.loop import (
    build_plans,
    evaluate_metrics,
    make_predict_step,
    plan_batches,
)
from diffusionsat_torch.train.metrics import SATAccuracy, StepStatistics


def _seeded(seed: int, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def evaluate_variable_generalization(params, model_cfg, make_dataset,
                                     results_file: str | Path,
                                     lower: int = 10, upper: int = 100,
                                     step: int = 10, test_size: int = 10,
                                     device: str | torch.device = "cuda"):
    """Sweep variable counts and evaluate each.
    make_dataset(min_vars, max_vars, test_size) -> iterable of SatBatch."""
    dev = resolve_device(device)
    results = {}
    for var_count in range(lower, upper, step):
        data = plan_batches(make_dataset(var_count, var_count, test_size),
                            dev)
        vals = evaluate_metrics(params, model_cfg, data,
                                [SATAccuracy(), StepStatistics()],
                                _seeded(0, dev), device=dev)
        results[var_count] = vals
        with Path(results_file).open("a") as f:
            f.write(f"var_count={var_count}: {vals}\n")
    return results


def evaluate_round_generalization(params, model_cfg_factory, data,
                                  results_file: str | Path,
                                  rounds_list=None,
                                  device: str | torch.device = "cuda"):
    """Sweep test_rounds, 16..4096 by default.
    model_cfg_factory(test_rounds) -> model cfg for the same params. The
    batches are planned and placed on the device once for the sweep."""
    dev = resolve_device(device)
    rounds_list = rounds_list or [2 ** r for r in range(4, 13)]
    planned = plan_batches(data, dev)
    results = {}
    for rounds in rounds_list:
        cfg = model_cfg_factory(rounds)
        t0 = time.time()
        vals = evaluate_metrics(params, cfg, planned,
                                [SATAccuracy(), StepStatistics()],
                                _seeded(0, dev), device=dev)
        vals["elapsed"] = time.time() - t0
        results[rounds] = vals
        with Path(results_file).open("a") as f:
            f.write(f"test_rounds={rounds}: {vals}\n")
    return results


def evaluate_batch_generalization(params, model_cfg, make_dataset,
                                  results_file: str | Path,
                                  sizes=range(3000, 24000, 1000),
                                  device: str | torch.device = "cuda"):
    """Sweep packing node budgets and time one predict step on the first
    batch of each. Each budget is a new shape: the step is called once
    untimed (on the card that call captures the round's CUDA graph), and
    the second call is timed, so the time is that of a warm step, which the
    results file says. make_dataset(budget) -> iterable of SatBatch."""
    dev = resolve_device(device)
    predict_step = make_predict_step(model_cfg, device=dev)
    results = {}
    for budget in sizes:
        batch = next(iter(make_dataset(budget)))
        (batch, plans), = plan_batches([batch], dev)
        predict_step(params, batch, _seeded(0, dev), plans=plans)
        _sync(dev)
        t0 = time.time()
        out = predict_step(params, batch, _seeded(0, dev), plans=plans)
        float(out["loss"])  # waits for the device
        elapsed = time.time() - t0
        results[budget] = elapsed
        with Path(results_file).open("a") as f:
            f.write(f"max_nodes_per_batch={budget}: {elapsed:.3f}s "
                    "(warm: the second call of this shape)\n")
    return results


def evaluate_classic_solver(batches, steps: int | None = None) -> float:
    """Mean per-batch CDCL solve time over the re-extracted formulas."""
    from diffusionsat_torch.sat.solvers import solve

    it = itertools.islice(batches, steps) if steps else batches
    total = 0.0
    count = 0
    for batch in it:
        for n_vars, clauses in extract_formulas(batch):
            t0 = time.perf_counter()
            solve(clauses, n_vars)
            total += time.perf_counter() - t0
        count += 1
    return total / max(count, 1)


def extract_formulas(batch: SatBatch) -> list[tuple[int, list[list[int]]]]:
    """Recover per-graph (n_vars, clauses) from a packed batch."""
    el = _np(batch.edge_lit_c)
    ec = _np(batch.edge_clause_c)
    em = _np(batch.edge_mask_c) > 0
    var_graph = _np(batch.var_graph)
    clause_graph = _np(batch.clause_graph)
    nvpg = _np(batch.n_vars_per_graph).astype(int)
    G = int(batch.n_graphs)
    V = batch.V

    var_offset = np.zeros(G, dtype=int)
    if G > 1:
        np.cumsum(nvpg[:G - 1], out=var_offset[1:])

    clauses_by_id: dict[int, list[int]] = {}
    for l, c, m in zip(el, ec, em):
        if not m:
            continue
        v = l if l < V else l - V
        sign = 1 if l < V else -1
        g = var_graph[v]
        lit = sign * (v - var_offset[g] + 1)
        clauses_by_id.setdefault(int(c), []).append(int(lit))

    out = []
    for g in range(G):
        cls = [clauses_by_id[c] for c in sorted(clauses_by_id)
               if clause_graph[c] == g]
        out.append((int(nvpg[g]), cls))
    return out


def _with_literals(batch: SatBatch, el_final: np.ndarray,
                   solutions: np.ndarray) -> SatBatch:
    """`batch` with new clause-sorted literal ids and solutions, and the
    literal-sorted order rebuilt from them."""
    order_l = np.argsort(el_final, kind="stable")
    t = torch.from_numpy
    return dataclasses.replace(
        batch,
        edge_lit_c=t(el_final.astype(np.int32)),
        edge_lit_l=t(el_final[order_l].astype(np.int32)),
        edge_clause_l=t(_np(batch.edge_clause_c)[order_l].astype(np.int32)),
        edge_mask_l=t(_np(batch.edge_mask_c)[order_l].astype(np.float32)),
        edge_perm_l=t(order_l.astype(np.int32)),
        solutions=t(solutions.astype(np.int32)),
    )


def permute_batch_variables(batch: SatBatch, seed: int = 0) -> SatBatch:
    """Variable-permutation scrambler within each graph (the
    dimacs_shuffle invariance transform): relabel variables, keeping the
    graph structure. Solutions are permuted consistently."""
    rng = np.random.default_rng(seed)
    V = batch.V
    var_graph = _np(batch.var_graph)
    perm = np.arange(V)
    for g in range(int(batch.n_graphs)):
        idx = np.where(var_graph == g)[0]
        perm[idx] = rng.permutation(idx)
    el = _np(batch.edge_lit_c).copy()
    mask = _np(batch.edge_mask_c) > 0
    is_neg = el >= V
    v = np.where(is_neg, el - V, el)
    v_new = perm[v]
    el_new = np.where(is_neg, v_new + V, v_new)
    el_final = np.where(mask, el_new, el)

    inv = np.empty_like(perm)
    inv[perm] = np.arange(V)
    return _with_literals(batch, el_final, _np(batch.solutions)[inv])


def invert_batch_polarity(batch: SatBatch) -> SatBatch:
    """Swap positive and negative literal roles: every literal is negated,
    solutions flip."""
    V = batch.V
    el = _np(batch.edge_lit_c)
    mask = _np(batch.edge_mask_c) > 0
    el_new = np.where(el < V, el + V, el - V)
    el_final = np.where(mask, el_new, el)
    sols = (1 - _np(batch.solutions)) * (_np(batch.var_mask) > 0)
    return _with_literals(batch, el_final, sols)


def _solved_fraction(prediction: torch.Tensor, batch: SatBatch) -> float:
    solved = _np(is_graph_sat(prediction[:, None], batch))[:, 0]
    return float(solved[_np(batch.graph_mask) > 0].mean())


def test_invariance(params, model_cfg, batches, steps: int = 20,
                    device: str | torch.device = "cuda") -> dict:
    """Predict on original / variable-permuted / polarity-inverted batches
    and compare solved rates. The three runs of batch i draw from a
    generator seeded i; each transformed batch runs on plans built from its
    own edges."""
    dev = resolve_device(device)
    predict_step = make_predict_step(model_cfg, device=dev)
    results: dict[str, list[float]] = {"original": [], "permuted": [],
                                       "inverted": []}
    for i, batch in enumerate(itertools.islice(batches, steps)):
        for name, tfm in (("original", lambda b: b),
                          ("permuted",
                           lambda b: permute_batch_variables(b, seed=i)),
                          ("inverted", invert_batch_polarity)):
            b = tfm(batch)
            plans = build_plans(b, pad=True)
            b = b.to(dev)
            out = predict_step(params, b, _seeded(i, dev), plans=plans)
            results[name].append(_solved_fraction(out["prediction"], b))
    return {k: float(np.mean(v)) for k, v in results.items()}


def make_cactus(params, model_cfg, batches: Iterable[SatBatch],
                out_csv: str | Path, warmup_steps: int = 10,
                device: str | torch.device = "cuda"):
    """Per-instance solve-or-not and time CSV, sorted, without the first
    `warmup_steps` batches. Batch `step` draws from a generator seeded
    `step`; its time is that of the predict step (plans built before),
    shared out over its graphs."""
    dev = resolve_device(device)
    predict_step = make_predict_step(model_cfg, device=dev)
    solved, var_count, time_used = [], [], []
    for step, batch in enumerate(batches):
        (batch, plans), = plan_batches([batch], dev)
        _sync(dev)
        t0 = time.time()
        out = predict_step(params, batch, _seeded(step, dev), plans=plans)
        float(out["loss"])  # waits for the device
        elapsed = time.time() - t0
        if step < warmup_steps:
            continue
        sat_g = _np(is_graph_sat(out["prediction"][:, None], batch))[:, 0]
        gm = _np(batch.graph_mask) > 0
        nvpg = _np(batch.n_vars_per_graph)[gm]
        sat_g = sat_g[gm]
        solved += [int(x) for x in sat_g]
        var_count += nvpg.astype(int).tolist()
        time_used += [elapsed / max(len(sat_g), 1)] * len(sat_g)
    rows = sorted(zip(var_count, solved, time_used))
    with Path(out_csv).open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["var_count", "solved", "time"])
        writer.writerows(rows)
    return rows
