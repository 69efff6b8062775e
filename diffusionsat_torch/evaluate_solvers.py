"""Classic-solver cactus baseline.

Counterpart of the TPU package's root `evaluate_solvers.py`: run WalkSAT
and CDCL over generated threshold 3-SAT test formulas, recording each
instance's solve time and success into a cactus CSV. Host code only.

    python -m diffusionsat_torch.evaluate_solvers --min_vars 20 \
        --max_vars 100 --count 100
"""

from __future__ import annotations

import argparse
import csv
import time

from diffusionsat_torch.data.generators import SAT3Instances
from diffusionsat_torch.sat.solvers import solve, walksat


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--min_vars", type=int, default=20)
    p.add_argument("--max_vars", type=int, default=100)
    p.add_argument("--count", type=int, default=100)
    p.add_argument("--max_flips", type=int, default=500_000)
    p.add_argument("--out", default="solver_cactus.csv")
    args = p.parse_args(argv)

    gen = SAT3Instances(min_vars=args.min_vars, max_vars=args.max_vars,
                        train_size=1, test_size=args.count)
    rows = []
    for i, (n_vars, clauses, _) in enumerate(gen.test_generator()):
        t0 = time.perf_counter()
        ok_w, _ = walksat(clauses, n_vars, seed=i, max_flips=args.max_flips)
        t_walk = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok_c, _ = solve(clauses, n_vars, seed=i)
        t_cdcl = time.perf_counter() - t0
        rows.append([n_vars, int(ok_w), t_walk, int(ok_c), t_cdcl])
        if (i + 1) % 10 == 0:
            print(f"{i + 1}/{args.count} done")

    rows.sort()
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["var_count", "walksat_solved", "walksat_time",
                    "cdcl_solved", "cdcl_time"])
        w.writerows(rows)
    print(f"written {args.out}")


if __name__ == "__main__":
    main()
