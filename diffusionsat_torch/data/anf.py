"""ANF instance generation: random XOR-AND systems.

A copy of the TPU package's `data/anf.py` (pure Python on
`random.Random`: the same systems from the same seeds). The reference
builds ANF systems by driving cgen + Bosphorus binaries on SHA-1 preimage
problems (`data/sha_anf.py:304-440`); those binaries are not available, so
this module provides a synthetic random XOR-AND system generator with a
known satisfying assignment: the same data contract, solver-free. The
SHA-1 systems are `data/sha_anf.py`.
"""

from __future__ import annotations

import random
from typing import Iterator

Term = tuple


class RandomAnfInstances:
    """Random ANF systems consistent with a hidden assignment.

    Each equation XORs a few variable/AND/constant terms; a constant-one
    term is appended when needed so the equation evaluates to 0 under the
    hidden assignment (the encoding the ANFSAT loss drives to, see
    graph/anf_batch.evaluate_anf).
    """

    def __init__(self, min_vars: int = 4, max_vars: int = 20,
                 train_size: int = 10_000, test_size: int = 1_000,
                 eq_per_var: float = 1.2, terms_per_eq: int = 4,
                 and_fraction: float = 0.5, seed: int = 0):
        self.min_vars = min_vars
        self.max_vars = max_vars
        self.train_size = train_size
        self.test_size = test_size
        self.eq_per_var = eq_per_var
        self.terms_per_eq = terms_per_eq
        self.and_fraction = and_fraction
        self.seed = seed

    def train_generator(self):
        return self._generator(self.train_size, self.seed)

    def test_generator(self):
        return self._generator(self.test_size, self.seed + 1_000_003)

    def _generator(self, size: int, seed: int
                   ) -> Iterator[tuple[int, list[list[Term]], list[int]]]:
        rng = random.Random(seed)
        for _ in range(size):
            n = rng.randint(self.min_vars, self.max_vars)
            bits = [rng.randint(0, 1) for _ in range(n)]
            n_eq = max(1, int(self.eq_per_var * n))
            equations = []
            for _ in range(n_eq):
                k = rng.randint(2, self.terms_per_eq)
                terms: list[Term] = []
                parity = 0
                for _ in range(k):
                    if rng.random() < self.and_fraction and n >= 2:
                        i, j = rng.sample(range(1, n + 1), 2)
                        terms.append((i, j))
                        parity ^= bits[i - 1] & bits[j - 1]
                    else:
                        i = rng.randint(1, n)
                        terms.append((i,))
                        parity ^= bits[i - 1]
                if parity == 1:
                    terms.append(())  # constant one balances to 0
                equations.append(terms)
            yield n, equations, bits
