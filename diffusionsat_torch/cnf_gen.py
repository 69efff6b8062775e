"""Standalone SHA-1 CNF batch generator CLI.

Counterpart of the TPU package's root `cnf_gen.py` (the reference drives
the external cgen binary): generates r-round SHA-1 preimage DIMACS files
with a swept number of free message bits into an output directory,
filtered by CNF variable count, with the port's pure-Python Tseitin
encoder (`data/sha.py`). Each file carries its witness as a `c sol`
comment. Host code only.

    python -m diffusionsat_torch.cnf_gen --bits_from 4 --bits_to 6 \
        --samples 2 --rounds 2 --out_dir output
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from diffusionsat_torch.data.sha import sha1_cnf
from diffusionsat_torch.sat.cnf import CNF


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bits_from", type=int, default=8)
    p.add_argument("--bits_to", type=int, default=12)
    p.add_argument("--samples", type=int, default=2,
                   help="random instances per free-bit count")
    p.add_argument("--rounds", type=int, default=4,
                   help="SHA-1 rounds, 1..80 (reference cgen.py:25). NB our\n"
                        "encoder constant-folds aggressively: at <4 rounds\n"
                        "with few free bits the instance can collapse to\n"
                        "0 clauses and be skipped by the var filter")
    p.add_argument("--min_vars", type=int, default=20)
    p.add_argument("--max_vars", type=int, default=100_000,
                   help="skip instances outside [min_vars, max_vars] "
                        "(reference cgen.py:31-32)")
    p.add_argument("--out_dir", default="output")
    p.add_argument("--cleanup", action="store_true",
                   help="wipe out_dir first (reference cgen.py:14)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    out = Path(args.out_dir)
    if args.cleanup and out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True, exist_ok=True)

    written = skipped = 0
    for bits in range(args.bits_from, args.bits_to + 1):
        for k in range(args.samples):
            seed = args.seed + 7919 * bits + k
            n_vars, clauses, witness = sha1_cnf(
                rounds=args.rounds, free_bits=bits, seed=seed)
            if not (args.min_vars <= n_vars <= args.max_vars):
                skipped += 1
                continue
            cnf = CNF(n_vars=n_vars, clauses=clauses)
            name = f"sha1_r{args.rounds}_b{bits}_s{k}.dimacs"
            body = cnf.to_string()
            # store the witness like the pipeline does (reference
            # data/dimac.py:146-152 'c sol' comment convention)
            sol_line = "c sol " + " ".join(
                str(i + 1) if v else str(-(i + 1))
                for i, v in enumerate(witness)) + "\n"
            (out / name).write_text(sol_line + body)
            written += 1
    print(f"wrote {written} DIMACS files to {out} (skipped {skipped} "
          f"outside var bounds)")


if __name__ == "__main__":
    main()
