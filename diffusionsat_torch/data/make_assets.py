"""Generate the bundled task assets under `data/assets/` (committed).

The port's copy of the TPU package's `data/make_assets.py`, which writes
the same bytes: the port reads its own copy of the assets and names no
file of that package. The reference ships real-world SPLOT feature models
and pre-fetched toughsat factoring CNFs; these are deterministic
stand-ins in the same file formats:

- `splot/`: synthetic 3-CNF feature models in the SPLOT XML layout that
  `loaders.SplotInstances` parses (a <constraints> block of
  `Clause3CNF_k: f OR ~g OR h` lines over named features), each SAT by
  construction (clauses generated around a hidden assignment);
- `primes/`: factoring CNFs from `primes_gen.py` (an exact Tseitin
  multiplier whose models are exactly the nontrivial factor pairs);
- `satlib/`: uf20-91-style satisfiable uniform random 3-SAT (SATLIB's
  smallest class: 20 vars, 91 clauses), generated around a hidden
  assignment.

    python -m diffusionsat_torch.data.make_assets [--out_dir DIR]
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from diffusionsat_torch.data.primes_gen import semiprime_instances

ASSETS = Path(__file__).resolve().parent / "assets"


def make_splot_xml(n_features: int, n_clauses: int, seed: int,
                   name: str) -> str:
    rng = random.Random(seed)
    feats = [f"f_{i + 1}" for i in range(n_features)]
    hidden = {f: rng.random() < 0.5 for f in feats}
    lines = []
    for k in range(1, n_clauses + 1):
        picks = rng.sample(feats, 3)
        # the hidden assignment satisfies the clause: one literal agrees
        # with it
        lits = []
        sat_pos = rng.randrange(3)
        for i, f in enumerate(picks):
            if i == sat_pos:
                neg = not hidden[f]
            else:
                neg = rng.random() < 0.5
            lits.append(("~" if neg else "") + f)
        lines.append(f"Clause3CNF_{k}:" + " OR ".join(lits))
    body = "\n".join(lines)
    return (f'<feature_model name="{name}">\n'
            f"<constraints>\n{body}\n</constraints>\n"
            f"</feature_model>\n")


def _dimacs(n_vars: int, clauses: list[list[int]]) -> str:
    lines = [f"p cnf {n_vars} {len(clauses)}"]
    lines += [" ".join(map(str, c)) + " 0" for c in clauses]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", default=str(ASSETS))
    args = ap.parse_args(argv)
    out = Path(args.out_dir)

    splot_dir = out / "splot"
    splot_dir.mkdir(parents=True, exist_ok=True)
    for i in range(10):
        # a near-threshold ratio (4.1) keeps the model count small enough
        # for the exact-enumeration labeler
        n_feat = 16 + 3 * i
        n_cls = int(n_feat * 4.1)
        name = f"SYNTH-3CNF-FM-{n_feat}-{n_cls}-SAT-{i + 1}"
        (splot_dir / f"{name}.xml").write_text(
            make_splot_xml(n_feat, n_cls, seed=1000 + i, name=name))
        print(f"wrote splot/{name}.xml")

    primes_dir = out / "primes"
    primes_dir.mkdir(parents=True, exist_ok=True)
    for name, n_vars, clauses in semiprime_instances(count=12, seed=0):
        (primes_dir / f"{name}.cnf").write_text(_dimacs(n_vars, clauses))
        print(f"wrote primes/{name}.cnf ({n_vars} vars)")

    satlib_dir = out / "satlib"
    satlib_dir.mkdir(parents=True, exist_ok=True)
    for i in range(10):
        rng = random.Random(2000 + i)
        n, m = 20, 91
        hidden = [rng.random() < 0.5 for _ in range(n)]
        clauses = []
        for _ in range(m):
            vs = rng.sample(range(1, n + 1), 3)
            sat_pos = rng.randrange(3)
            lits = []
            for j, v in enumerate(vs):
                if j == sat_pos:
                    neg = not hidden[v - 1]
                else:
                    neg = rng.random() < 0.5
                lits.append(-v if neg else v)
            clauses.append(lits)
        (satlib_dir / f"uf20-synth-{i + 1}.cnf").write_text(
            _dimacs(n, clauses))
        print(f"wrote satlib/uf20-synth-{i + 1}.cnf")


if __name__ == "__main__":
    main()
