"""Uniformity battery: the diffusion sampler against exact-uniform and
WalkSAT over a suite of benchmark formulas.

    python -m diffusionsat_torch.uniformity_benchmark \
        --model_ckpt pretrained/query_sat_3sat_diffusion_mlk64_iso45.npz \
        --n_formulas 24 --k 40 \
        --variants uniform,diffusion_nofreeze,diffusion_mh_xor

Counterpart of the TPU package's root `uniformity_benchmark.py`, with its
flags, formulas, per-variant seeds and record schema, so
`uniformity_report.py` reads either package's files. It generates threshold
3-SAT formulas with a moderate solution count, draws k samples per solution
from each sampler, and reports per formula and in aggregate the diversity
(distinct / true solutions), the chi-square uniformity p-value and the
count-histogram entropy against exact-uniform.

The diffusion variants run on the card unless `--device cpu` is given.
`--layout auto` lets the sampler pick its chain (dense blocks for small
formulas); `flat` sends them through the flat chain and its segsum kernel,
`dense` through the dense chain. The refiners, enumeration and WalkSAT run
on the host.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path

import numpy as np

from diffusionsat_torch.sat.cnf import CNF, VariableAssignment
from diffusionsat_torch.sat.solvers import enumerate_models
from diffusionsat_torch.uniformity.benchmarks_file import BenchmarksFile
from diffusionsat_torch.uniformity.samplers import (
    ExactUniformSampler,
    MetropolisRefiner,
    WalkSatSampler,
    XorCellJumpRefiner,
)
from diffusionsat_torch.utils.chi_square import chi_square_likelihood

# the variants run when --variants is not given (the core five)
CORE_VARIANTS = ("uniform", "walksat", "diffusion", "diffusion_nofreeze",
                 "diffusion_latefreeze")
_TEMPERATURE = re.compile(r"diffusion_(nofreeze|sample)_t([0-9.]+)")
LAYOUTS = {"auto": None, "flat": False, "dense": True}


def gen_benchmark_formulas(n_formulas: int, seed: int = 0,
                           min_vars: int = 10, max_vars: int = 16,
                           min_solutions: int = 20,
                           max_solutions: int = 200):
    """Random threshold 3-SAT filtered to a moderate solution count:
    [(n_vars, clauses, models [S, n_vars] uint8), ...]."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_formulas:
        n = int(rng.integers(min_vars, max_vars + 1))
        m = int(4.258 * n + 58.26 * n ** (-2.0 / 3.0))
        clauses = [[int(v) if rng.random() < 0.5 else -int(v)
                    for v in (rng.choice(n, size=3, replace=False) + 1)]
                   for _ in range(m)]
        models, complete = enumerate_models(clauses, n, max_models=10_000)
        if complete and min_solutions <= len(models) <= max_solutions:
            out.append((n, clauses, models))
    return out


def keyed_uniform_ideal(models, cnf, total: float) -> dict[int, float]:
    """{assignment_key: total/S} over the true solution set: the uniform
    expectation every battery statistic is computed against."""
    S = max(len(models), 1)
    keyed = {}
    for row in models:
        asgn = VariableAssignment(cnf.number_of_vars(), cnf.clauses())
        asgn.assign_all_from_bit_list([int(b) for b in row])
        keyed[int(asgn)] = total / S
    return keyed


def count_stats(counts: dict, models, cnf, n_samples: int) -> dict:
    S = len(models)
    # the expectation of the samples actually collected: a sampler that
    # stops early is not chi2-penalized for the missing draws
    got = max(sum(counts.values()), 1)
    pval = chi_square_likelihood(counts, keyed_uniform_ideal(models, cnf,
                                                             got))
    total = max(sum(counts.values()), 1)
    ce = -sum((c / total) * np.log(max(c / total, 1e-12))
              for c in counts.values())
    return {"distinct": len(counts), "true_solutions": S,
            "n_collected": got,
            "diversity": round(len(counts) / max(S, 1), 4),
            "chi2_p": float(pval),
            "count_entropy": round(float(ce), 4),
            "uniform_entropy": round(float(np.log(max(S, 1))), 4)}


def sampler_factories(cnf: CNF, fi: int, selected: set[str] | None,
                      diffusion=None) -> list:
    """[(variant, make_sampler)] for formula `fi`, in the TPU package's
    order and with its seeds. `diffusion(seed, **kw)` builds a
    `DiffusionSampler` of the loaded model (None: no diffusion variants)."""
    def want(name):
        return selected is not None and name in selected

    out = [("uniform", lambda: ExactUniformSampler(cnf, seed=1 + fi)),
           ("walksat", lambda: WalkSatSampler(cnf, seed=2 + fi))]
    if want("walksat_mh"):
        out.append(("walksat_mh", lambda: MetropolisRefiner(
            cnf, WalkSatSampler(cnf, seed=2 + fi), seed=12 + fi)))
    if want("walksat_mh_xor"):
        out.append(("walksat_mh_xor", lambda: XorCellJumpRefiner(
            cnf, WalkSatSampler(cnf, seed=2 + fi), seed=22 + fi)))
    if diffusion is not None:
        # early freeze pins a graph the moment its prediction satisfies; the
        # full trajectory (nofreeze) is near-uniform at a lower success
        # rate; late freeze pins only over the last quarter of the chain
        out.append(("diffusion", lambda: diffusion(3 + fi)))
        out.append(("diffusion_nofreeze",
                    lambda: diffusion(4 + fi, freeze_sat=False)))
        out.append(("diffusion_latefreeze",
                    lambda: diffusion(5 + fi, late_freeze=True)))
        if want("diffusion_sample"):
            out.append(("diffusion_sample", lambda: diffusion(
                6 + fi, freeze_sat=False, final_sample=True)))
        if want("diffusion_mh"):
            out.append(("diffusion_mh", lambda: MetropolisRefiner(
                cnf, diffusion(7 + fi, freeze_sat=False), seed=17 + fi)))
        if want("diffusion_mh_xor"):
            # cross-component XOR-cell jumps on top of the MH sweeps
            out.append(("diffusion_mh_xor", lambda: XorCellJumpRefiner(
                cnf, diffusion(7 + fi, freeze_sat=False), seed=27 + fi)))
        for tok in sorted(selected or ()):
            m = _TEMPERATURE.fullmatch(tok)
            if m:
                out.append((tok, lambda m=m: diffusion(
                    9 + fi, freeze_sat=False,
                    final_sample=m.group(1) == "sample",
                    temperature=float(m.group(2)))))
        if want("diffusion_latefreeze_mh"):
            out.append(("diffusion_latefreeze_mh", lambda: MetropolisRefiner(
                cnf, diffusion(8 + fi, late_freeze=True), seed=18 + fi)))
    if selected is not None:
        out = [(n, f) for n, f in out if n in selected]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_ckpt", default=None,
                   help="<ckpt dir | .npz>: a training run's "
                        "checkpoint directory or a portable params file")
    p.add_argument("--n_formulas", type=int, default=8)
    p.add_argument("--skip_formulas", type=int, default=0,
                   help="skip the first N formulas of the deterministic "
                        "sequence (resume an interrupted battery)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--diffusion_steps", type=int, default=32)
    p.add_argument("--test_rounds", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="benchmarks_flagship.jsonl")
    p.add_argument("--summary_out", default=None)
    p.add_argument("--variants", default=None,
                   help="comma-separated subset of samplers to run "
                        "(uniform,walksat,walksat_mh,walksat_mh_xor,"
                        "diffusion,diffusion_nofreeze,diffusion_latefreeze,"
                        "diffusion_sample,diffusion_mh,diffusion_mh_xor,"
                        "diffusion_latefreeze_mh,diffusion_{nofreeze,"
                        "sample}_t<T>); default: " + ",".join(CORE_VARIANTS))
    p.add_argument("--layout", choices=sorted(LAYOUTS), default="auto",
                   help="reverse chain of the diffusion variants")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    selected = set(args.variants.split(",")) if args.variants else None

    diffusion_for = None
    if args.model_ckpt:
        from diffusionsat_torch.device import resolve_device
        from diffusionsat_torch.diffusion.sampler import DiffusionSampler
        from diffusionsat_torch.train.checkpoint import load_model
        dev = resolve_device(args.device)
        params, cfg = load_model(args.model_ckpt, dev,
                                 test_rounds=args.test_rounds)
        print("model params restored", flush=True)

        def diffusion_for(cnf):
            def make(seed, late_freeze=False, **kw):
                return DiffusionSampler(
                    params, cfg, cnf, diffusion_steps=args.diffusion_steps,
                    test_rounds=args.test_rounds, seed=seed,
                    dense=LAYOUTS[args.layout], device=dev,
                    freeze_from=(args.diffusion_steps * 3 // 4
                                 if late_freeze else 0), **kw)
            return make

    formulas = gen_benchmark_formulas(args.n_formulas, seed=args.seed)
    print(f"{len(formulas)} benchmark formulas: "
          f"{[(n, len(m)) for n, _, m in formulas]}", flush=True)

    store = BenchmarksFile(args.out)
    agg: dict[str, list] = {}
    for fi, (n, clauses, models) in enumerate(formulas):
        if fi < args.skip_formulas:
            continue
        cnf = CNF(n_vars=n, clauses=clauses)
        S = len(models)
        n_samples = args.k * S
        record = {"formula": fi, "n_vars": n, "n_clauses": len(clauses),
                  "n_solutions": S, "n_samples": n_samples}
        factories = sampler_factories(
            cnf, fi, selected, diffusion_for and diffusion_for(cnf))
        for name, make in factories:
            sampler = make()
            t0 = time.perf_counter()
            counts = sampler.samples(n_samples)
            elapsed = time.perf_counter() - t0
            stats = count_stats(counts, models, cnf, n_samples)
            stats["elapsed_s"] = round(elapsed, 2)
            stats["ms_per_distinct"] = round(
                1000 * elapsed / max(len(counts), 1), 2)
            if name.startswith("diffusion"):
                stats["success_rate"] = getattr(sampler, "success_rate",
                                                None)
            if isinstance(sampler, MetropolisRefiner):
                stats["refine_s"] = round(sampler.refine_seconds, 3)
            record[name] = {"counts": {str(k): v
                                       for k, v in counts.items()},
                            **stats}
            agg.setdefault(name, []).append(stats)
            print(f"[formula {fi}] {name}: {stats}", flush=True)
        store.write(clauses, record)

    summary = {}
    for name, rows in agg.items():
        summary[name] = {
            "mean_diversity": round(float(np.mean(
                [r["diversity"] for r in rows])), 4),
            "median_chi2_p": round(float(np.median(
                [r["chi2_p"] for r in rows])), 6),
            "mean_entropy_gap": round(float(np.mean(
                [r["uniform_entropy"] - r["count_entropy"]
                 for r in rows])), 4),
        }
    print(json.dumps({"summary": summary}, indent=1))
    if args.summary_out:
        Path(args.summary_out).write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
