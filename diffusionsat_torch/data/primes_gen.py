"""Factoring CNFs from scratch: N = a*b as a Tseitin-encoded multiplier.

A copy of the TPU package's `data/primes_gen.py` (pure Python, so both
packages write the same files): an n-bit x m-bit schoolbook multiplier
(AND partial products, full/half-adder column compression) with the
product bits fixed to N and both factors constrained > 1, so the only
models are the nontrivial factorizations. The reference reads
pre-fetched toughsat files of the same kind instead.

    python -m diffusionsat_torch.data.primes_gen --out_dir <dir> --count 12
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path


class _CnfBuilder:
    def __init__(self):
        self.n = 0
        self.clauses: list[list[int]] = []

    def var(self) -> int:
        self.n += 1
        return self.n

    def add(self, *lits: int) -> None:
        self.clauses.append(list(lits))

    def and_gate(self, x: int, y: int) -> int:
        t = self.var()
        self.add(-t, x)
        self.add(-t, y)
        self.add(t, -x, -y)
        return t

    def xor_gate(self, x: int, y: int) -> int:
        z = self.var()
        self.add(-z, x, y)
        self.add(-z, -x, -y)
        self.add(z, x, -y)
        self.add(z, -x, y)
        return z

    def full_adder(self, x: int, y: int, c: int) -> tuple[int, int]:
        """Returns (sum, carry): s = x^y^c, cout = maj(x,y,c)."""
        s1 = self.xor_gate(x, y)
        s = self.xor_gate(s1, c)
        cout = self.var()
        self.add(-x, -y, cout)
        self.add(-x, -c, cout)
        self.add(-y, -c, cout)
        self.add(x, y, -cout)
        self.add(x, c, -cout)
        self.add(y, c, -cout)
        return s, cout

    def half_adder(self, x: int, y: int) -> tuple[int, int]:
        return self.xor_gate(x, y), self.and_gate(x, y)


def factoring_cnf(n_value: int, a_bits: int, b_bits: int
                  ) -> tuple[int, list[list[int]], int, list[int], list[int]]:
    """CNF whose models are exactly {a, b > 1 : a*b == n_value} with a in
    a_bits bits and b in b_bits bits. Returns (n_vars, clauses, n_value,
    a_vars, b_vars)."""
    cb = _CnfBuilder()
    a = [cb.var() for _ in range(a_bits)]
    b = [cb.var() for _ in range(b_bits)]
    # nontrivial factors: a > 1 and b > 1 (some bit above bit0 set)
    cb.add(*a[1:])
    cb.add(*b[1:])

    # schoolbook partial products into bit columns
    n_out = a_bits + b_bits
    cols: list[list[int]] = [[] for _ in range(n_out)]
    for i in range(a_bits):
        for j in range(b_bits):
            cols[i + j].append(cb.and_gate(a[i], b[j]))

    # column compression with full/half adders
    out_bits: list[int] = []
    for k in range(n_out):
        col = cols[k]
        while len(col) > 1:
            if len(col) >= 3:
                x, y, c = col.pop(), col.pop(), col.pop()
                s, cout = cb.full_adder(x, y, c)
            else:
                x, y = col.pop(), col.pop()
                s, cout = cb.half_adder(x, y)
            col.append(s)
            if k + 1 < n_out:
                cols[k + 1].append(cout)
            else:
                cb.add(-cout)  # overflow beyond product width must be 0
        out_bits.append(col[0] if col else 0)

    # fix the product to N
    for k in range(n_out):
        bit = (n_value >> k) & 1
        if out_bits[k] == 0:
            if bit:
                cb.add(cb.var())  # impossible: force UNSAT (shouldn't occur)
        else:
            cb.add(out_bits[k] if bit else -out_bits[k])
    return cb.n, cb.clauses, n_value, a, b


_SMALL_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47,
                 53, 59, 61]


def semiprime_instances(count: int = 12, seed: int = 0,
                        max_factor_bits: int = 6):
    """Deterministic stream of (name, n_vars, clauses) factoring CNFs
    over small semiprimes (both factors prime, > 1)."""
    rng = random.Random(seed)
    out = []
    seen = set()
    while len(out) < count:
        p = rng.choice(_SMALL_PRIMES)
        q = rng.choice(_SMALL_PRIMES)
        if p.bit_length() > max_factor_bits or \
                q.bit_length() > max_factor_bits:
            continue
        n = p * q
        if n in seen:
            continue
        seen.add(n)
        n_vars, clauses, _, _, _ = factoring_cnf(
            n, max(p.bit_length(), 2), max(q.bit_length(), 2))
        out.append((f"primes_{n}_{p}x{q}", n_vars, clauses))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--count", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, n_vars, clauses in semiprime_instances(args.count, args.seed):
        lines = [f"p cnf {n_vars} {len(clauses)}"]
        lines += [" ".join(map(str, c)) + " 0" for c in clauses]
        (out_dir / f"{name}.cnf").write_text("\n".join(lines) + "\n")
        print(f"wrote {name}.cnf ({n_vars} vars, {len(clauses)} clauses)")


if __name__ == "__main__":
    main()
