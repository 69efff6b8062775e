"""The neural ANF input prior, measured in CDCL conflicts (host only).

    python -m diffusionsat_torch.anf_prior_study \
        --marginals ANF_MARG_R17_M16.npz --json ANF_PRIOR_R17.json

Counterpart of the TPU package's `benchmarks/anf_prior_study.py`, with its
flags and output. It reads a marginals file that `python -m
diffusionsat_torch.anf_eval --dump_marginals` writes (the repo holds
`ANF_MARG_R17_FB2440.npz`, `ANF_MARG_R17_M16.npz`, `ANF_MARG_R20.npz`),
rebuilds the split it was taken on, and solves the full (nothing-fixed)
CNF encoding of every system with the native CDCL in five arms:

- plain: default phases, the no-model baseline;
- seed_free: the free input bits' phases set to the predicted bits, their
  VSIDS activity primed so they are decided first, most confident first;
- seed_all: the phases of every ANF variable set to the predicted bits;
- input_first: the inputs' activity primed, default phases (the decision
  order without the polarity prior);
- oracle: the free inputs' phases set to the true witness (the ceiling).

The metric is conflicts to a solution per system, beside wall time. No
device is used.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from diffusionsat_torch.data.anf_datasets import AnfDataset
from diffusionsat_torch.data.sha_anf import Sha1AnfInstances
from diffusionsat_torch.graph.anf_batch import ANFBucket
from diffusionsat_torch.sat.anf_completion import (
    encode_residual_cnf,
    extract_graph_equations,
    free_inputs_of,
)
from diffusionsat_torch.sat.solvers import solve_seeded


def run_system(eqs, vids, prob, witness, budget, seed):
    enc = encode_residual_cnf(eqs, {}, [int(v) for v in vids])
    if enc is None:
        return None
    clauses, ncnf, var2cnf = enc
    free = free_inputs_of(eqs, vids)
    pred = (prob > 0.5).astype(np.int8)
    conf = np.abs(2.0 * prob - 1.0)

    def arm(polarity_src, prime_inputs, use_conf_order=True):
        pol = np.full(ncnf, -1, np.int8)
        act = np.zeros(ncnf, np.float32)
        if polarity_src is not None:
            for v in (free if polarity_src in ("free", "oracle")
                      else list(vids)):
                v = int(v)
                c = var2cnf[v] - 1
                pol[c] = int(witness[v]) if polarity_src == "oracle" \
                    else int(pred[v])
        if prime_inputs:
            for v in free:
                c = var2cnf[int(v)] - 1
                act[c] = 10.0 + (float(conf[int(v)]) if use_conf_order
                                 else 0.0)
        t0 = time.perf_counter()
        try:
            sat, _, conflicts = solve_seeded(
                clauses, ncnf, seed=seed,
                polarity=pol if polarity_src is not None else None,
                activity=act if prime_inputs else None,
                conflict_budget=budget)
        except TimeoutError:
            return {"solved": False, "conflicts": budget,
                    "ms": round((time.perf_counter() - t0) * 1e3, 1)}
        return {"solved": bool(sat), "conflicts": conflicts,
                "ms": round((time.perf_counter() - t0) * 1e3, 1)}

    return {
        "n_free": len(free),
        "n_cnf_vars": ncnf,
        "n_cnf_clauses": len(clauses),
        "plain": arm(None, False),
        "seed_free": arm("free", True),
        "seed_all": arm("all", False),
        "input_first": arm(None, True, use_conf_order=False),
        "oracle": arm("oracle", True),
    }


def main(argv=None):
    """Returns (the summary, the per-system records)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--marginals", required=True)
    ap.add_argument("--conflict_budget", type=int, default=2_000_000)
    ap.add_argument("--max_systems", type=int, default=0)
    ap.add_argument("--train_size", type=int, default=8000)
    ap.add_argument("--max_vars", type=int, default=8192)
    ap.add_argument("--max_ands", type=int, default=16384)
    ap.add_argument("--max_clauses", type=int, default=8704)
    ap.add_argument("--max_edges", type=int, default=32768)
    ap.add_argument("--max_graphs", type=int, default=8)
    ap.add_argument("--data_dir", default="data_cache")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    z = np.load(args.marginals)
    rounds = int(z["rounds"])
    mn, mx = int(z["min_free_bits"]), int(z["max_free_bits"])
    test_size = int(z["test_size"])
    seed = int(z["seed"])

    inst = Sha1AnfInstances(rounds=rounds, min_free_bits=mn,
                            max_free_bits=mx, train_size=args.train_size,
                            test_size=test_size, seed=seed)
    bucket = ANFBucket(max_vars=args.max_vars, max_ands=args.max_ands,
                       max_clauses=args.max_clauses,
                       max_edges=args.max_edges, max_graphs=args.max_graphs)
    name = f"sha1anf_r{rounds}_fb{mn}_{mx}_{args.train_size}"
    ds = AnfDataset(inst, bucket, cache_dir=args.data_dir, name=name,
                    seed=seed)
    test_batches = ds.test_data()
    assert len(test_batches) == int(z["n_batches"]), \
        (len(test_batches), int(z["n_batches"]))

    systems = []
    for bi, batch in enumerate(test_batches):
        if args.max_systems and len(systems) >= args.max_systems:
            break           # the equations of later batches go unused
        prob = z[f"prob_{bi}"]
        var_graph = batch.var_graph.numpy()
        sols = batch.solutions.numpy()
        geqs = extract_graph_equations(batch)
        for g in np.where(batch.graph_mask.numpy() > 0)[0]:
            g = int(g)
            vids = np.where(var_graph == g)[0]
            if len(vids) == 0 or g not in geqs:
                continue
            systems.append((geqs[g], vids, prob, sols))

    if args.max_systems:
        systems = systems[:args.max_systems]
    print(f"{len(systems)} systems (r{rounds}, fb {mn}-{mx})", flush=True)

    per = []
    for i, (eqs, vids, prob, sols) in enumerate(systems):
        r = run_system(eqs, vids, prob, sols, args.conflict_budget,
                       seed=1000 + i)
        if r is not None:
            per.append(r)
        if (i + 1) % 32 == 0:
            print(f"{i + 1}/{len(systems)} done", flush=True)

    arms = ["plain", "seed_free", "seed_all", "input_first", "oracle"]
    out = {"marginals": args.marginals, "rounds": rounds,
           "free_bits": [mn, mx], "n_systems": len(per),
           "conflict_budget": args.conflict_budget}
    for a in arms:
        c = np.array([p[a]["conflicts"] for p in per], np.float64)
        out[a] = {
            "solved": round(float(np.mean([p[a]["solved"] for p in per])), 4),
            "conflicts_median": float(np.median(c)),
            "conflicts_mean": round(float(c.mean()), 1),
            "conflicts_p90": float(np.percentile(c, 90)),
            "total_ms": round(float(sum(p[a]["ms"] for p in per)), 1),
        }
    base = np.array([p["plain"]["conflicts"] for p in per], np.float64)
    for a in arms[1:]:
        c = np.array([p[a]["conflicts"] for p in per], np.float64)
        wins = float(np.mean(c < base))
        ratio = np.median((base + 1) / (c + 1))
        out[a]["win_rate_vs_plain"] = round(wins, 4)
        out[a]["median_conflict_reduction_x"] = round(float(ratio), 3)
    print(json.dumps({k: v for k, v in out.items() if k != "per_system"},
                     indent=1))
    if args.json:
        out["per_system"] = per
        Path(args.json).write_text(json.dumps(out, indent=1))
    return out, per


if __name__ == "__main__":
    main()
