"""Offline uniformity analysis over the benchmark store.

Counterpart of the TPU package's root `diffusion_metrics.py`, with the same
output: read benchmarks.jsonl records (written by `diffusion_evaluation`
or `uniformity_benchmark`), recompute chi-square uniformity p-values
against the ideal histogram, and count-histogram cross-entropies between
samplers. Host code only.

    python -m diffusionsat_torch.diffusion_metrics \
        [--benchmarks_file benchmarks.jsonl]
"""

from __future__ import annotations

import argparse
import math

from diffusionsat_torch.evaluation.noise_sweep import (
    count_histogram_cross_entropy,
)
from diffusionsat_torch.uniformity.benchmarks_file import BenchmarksFile
from diffusionsat_torch.utils.chi_square import chi_square_likelihood


def analyze_record(rec: dict) -> None:
    n_solutions = rec.get("n_solutions", 0)
    n_samples = rec.get("n_samples", 0)
    samplers = [k for k in ("uniform", "walksat", "diffusion") if k in rec]
    if not samplers or not n_solutions:
        return
    print(f"key={rec.get('key', '?')[:12]} n_solutions={n_solutions} "
          f"n_samples={n_samples}")

    ideal = {f"ideal_{i}": n_samples / n_solutions
             for i in range(n_solutions)}

    counts = {}
    for s in samplers:
        counts[s] = {k: v for k, v in rec[s].get("counts", {}).items()}

    for s in samplers:
        # align observed counts onto the ideal support size: pad missing
        # solutions with zeros by merging key spaces
        obs = dict(counts[s])
        merged_ideal = {k: n_samples / n_solutions for k in obs}
        extra = n_solutions - len(obs)
        for i in range(max(extra, 0)):
            merged_ideal[f"missing_{i}"] = n_samples / n_solutions
            obs.setdefault(f"missing_{i}", 0)
        p = chi_square_likelihood(obs, merged_ideal)
        logp = "-inf" if p == 0 else f"{math.log2(p):.1f}"
        print(f"  {s}/ideal chi2 p={p * 100:.2f}% (log2 {logp}) "
              f"distinct={len(counts[s])} "
              f"ms/distinct={rec[s].get('ms_per_distinct', 0):.1f}")

    if "uniform" in counts:
        for s in samplers:
            if s == "uniform":
                continue
            xent = count_histogram_cross_entropy(counts[s], counts["uniform"])
            print(f"  {s}/uniform count-histogram cross-entropy={xent:.3f}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--benchmarks_file", default="benchmarks.jsonl")
    args = p.parse_args(argv)
    store = BenchmarksFile(args.benchmarks_file)
    records = store.read_all()
    if not records:
        print(f"no records in {args.benchmarks_file}")
        return
    for rec in records:
        analyze_record(rec)


if __name__ == "__main__":
    main()
