"""Variable-permutation scrambler for DIMACS files.

Counterpart of the TPU package's root `dimacs_shuffle.py`: relabels
variables by a random permutation (optionally flipping polarities),
shuffles the literals of each clause and the clauses, and rewrites the
file, to test model invariance. Host code only.

    python -m diffusionsat_torch.dimacs_shuffle in.cnf out.cnf \
        [--seed N] [--flip]
"""

from __future__ import annotations

import argparse
import random

from diffusionsat_torch.sat.cnf import CNF


def shuffle_dimacs(cnf: CNF, seed: int = 0, flip_polarity: bool = False
                   ) -> CNF:
    rng = random.Random(seed)
    n = cnf.number_of_vars()
    perm = list(range(1, n + 1))
    rng.shuffle(perm)
    signs = [rng.choice([1, -1]) if flip_polarity else 1 for _ in range(n)]
    new_clauses = []
    for clause in cnf.clauses():
        new_clause = []
        for lit in clause:
            v = abs(lit) - 1
            new_lit = perm[v] * signs[v] * (1 if lit > 0 else -1)
            new_clause.append(new_lit)
        rng.shuffle(new_clause)
        new_clauses.append(new_clause)
    rng.shuffle(new_clauses)
    return CNF(n_vars=n, clauses=new_clauses)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--flip", action="store_true")
    args = p.parse_args(argv)
    cnf = CNF.load(args.input)
    out = shuffle_dimacs(cnf, seed=args.seed, flip_polarity=args.flip)
    out.filename = args.output
    out.store()


if __name__ == "__main__":
    main()
