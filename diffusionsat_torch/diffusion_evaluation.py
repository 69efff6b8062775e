"""Uniformity of one formula: the diffusion sampler against exact-uniform and
WalkSAT.

    python -m diffusionsat_torch.diffusion_evaluation --dimacs file.cnf \
        --model_ckpt pretrained/query_sat_3sat_diffusion_mlk64.npz

Counterpart of the TPU package's root `diffusion_evaluation.py`, with its
flags: count the formula's solutions, draw n_solutions * k samples from each
sampler, record each sampler's speed (ms per distinct solution) and
histogram to the benchmark store, and report the chi-square uniformity
probability against the keyed uniform ideal. The diffusion sampler runs on
the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import time

from diffusionsat_torch.sat.cnf import CNF
from diffusionsat_torch.sat.solvers import enumerate_models
from diffusionsat_torch.uniformity.benchmarks_file import BenchmarksFile
from diffusionsat_torch.uniformity.samplers import (
    ExactUniformSampler,
    WalkSatSampler,
)
from diffusionsat_torch.uniformity_benchmark import keyed_uniform_ideal
from diffusionsat_torch.utils.chi_square import chi_square_likelihood


def run_sampler(name: str, sampler, n_samples: int) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    counts = sampler.samples(n_samples)
    elapsed = time.perf_counter() - t0
    stats = {
        "sampler": name,
        "n_samples": sum(counts.values()),
        "distinct": len(counts),
        "elapsed_s": elapsed,
        "ms_per_distinct": 1000 * elapsed / max(len(counts), 1),
    }
    return counts, stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dimacs", required=True)
    p.add_argument("--model_ckpt", default=None,
                   help="<ckpt dir | .npz>: a training run's "
                        "checkpoint directory or a portable params file")
    p.add_argument("--k", type=int, default=10,
                   help="samples per solution (n = k * n_solutions)")
    p.add_argument("--diffusion_steps", type=int, default=32)
    p.add_argument("--test_rounds", type=int, default=32)
    p.add_argument("--benchmarks_file", default="benchmarks.jsonl")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    sampler = None
    if args.model_ckpt:
        from diffusionsat_torch.diffusion.sampler import DiffusionSampler
        from diffusionsat_torch.train.checkpoint import load_model
        params, cfg = load_model(args.model_ckpt, args.device,
                                 test_rounds=args.test_rounds)
        sampler = DiffusionSampler(
            params, cfg, CNF.load(args.dimacs), device=args.device,
            diffusion_steps=args.diffusion_steps,
            test_rounds=args.test_rounds)

    cnf = CNF.load(args.dimacs)
    models, complete = enumerate_models(cnf.clauses(), cnf.number_of_vars())
    n_solutions = len(models)
    n_samples = args.k * max(n_solutions, 1)
    print(f"{n_solutions} solutions ({'exact' if complete else 'capped'}), "
          f"drawing {n_samples} samples per sampler")

    store = BenchmarksFile(args.benchmarks_file)
    record = {"n_solutions": n_solutions, "n_samples": n_samples}
    runs = [("uniform", ExactUniformSampler(cnf, seed=1)),
            ("walksat", WalkSatSampler(cnf, seed=2))]
    if sampler is not None:
        runs.append(("diffusion", sampler))
    all_counts = {}
    for name, s in runs:
        counts, stats = run_sampler(name, s, n_samples)
        if name == "diffusion":
            stats["success_rate"] = s.success_rate
        print(stats)
        record[name] = {"counts": {str(k): v for k, v in counts.items()},
                        **stats}
        all_counts[name] = counts

    # chi-square uniformity against the ideal uniform expectation
    keyed_ideal = keyed_uniform_ideal(models, cnf, n_samples)
    for name, counts in all_counts.items():
        pval = chi_square_likelihood(counts, keyed_ideal)
        print(f"{name}/ideal chi2 uniformity probability = {pval * 100:.2f}%")
        record[f"{name}_chi2_p"] = pval

    store.write(cnf.clauses(), record)
    print(f"record appended to {args.benchmarks_file}")
    return record


if __name__ == "__main__":
    main()
