"""SAT instance generators, driven by the native solver.

The same streams as the TPU package's `data/generators.py`: the two random
streams (`random.Random` and numpy's `default_rng`) interleave in the same
order and the solver gets the same seeds, so both packages generate the
same instances.

- `KSatInstances`: NeuroSAT-style k-SAT: random clauses of geometric length
  until the formula turns UNSAT, one literal of the last clause negated,
  then clauses removed to multiply the expected solution count;
- `SAT3Instances`: random 3-SAT at the satisfiability threshold
  m = 4.258 n + 58.26 n^(-2/3), rejection-sampled for SAT, each instance
  with the solver's model attached.
- `DiffusionSatInstances`: wraps a generator and attaches a solution per
  instance: the base generator's, a uniform sample (`use_unigen=True`) or a
  CDCL model, or a bank of K uniform samples (`n_label_samples > 1`); in
  test mode it can repeat one fixed formula (`test_cnf`).
"""

from __future__ import annotations

import math
import random
from abc import ABC, abstractmethod
from typing import Iterator

import numpy as np

from diffusionsat_torch.sat import cnf as cnf_mod
from diffusionsat_torch.sat.solvers import (
    UniformSampler,
    enumerate_models,
    solve,
)

Instance = tuple[int, list[list[int]], list[int] | None]


class SatInstances(ABC):
    """Instance stream contract: yields (n_vars, clauses,
    solution-bits-or-None)."""

    @abstractmethod
    def train_generator(self) -> Iterator[Instance]:
        ...

    @abstractmethod
    def test_generator(self) -> Iterator[Instance]:
        ...

    def split(self, n_shards: int) -> list["SatInstances"] | None:
        """Return n_shards disjoint-seed copies covering the same totals,
        enabling process-parallel generation. None = not splittable."""
        return None


def _dedup_and_subsume(clauses: list[list[int]]) -> list[list[int]]:
    f = cnf_mod.CNF(clauses=clauses)
    f.reduce_clauses()
    return f.clauses()


class KSatInstances(SatInstances):
    """NeuroSAT-paper k-SAT generation."""

    def __init__(self, min_vars: int = 3, max_vars: int = 30,
                 train_size: int = 300_000, test_size: int = 10_000,
                 desired_multiplier_for_the_number_of_solutions: int = 10,
                 seed: int = 0):
        self.min_vars = min_vars
        self.max_vars = max_vars
        self.train_size = train_size
        self.test_size = test_size
        self.multiplier = desired_multiplier_for_the_number_of_solutions
        self.seed = seed
        self.p_k_2 = 0.3
        self.p_geo = 0.4

    def train_generator(self):
        return self._generator(self.train_size, self.seed)

    def test_generator(self):
        return self._generator(self.test_size, self.seed + 1_000_003)

    def split(self, n_shards: int):
        shards = []
        for i in range(n_shards):
            size = self.train_size // n_shards + \
                (1 if i < self.train_size % n_shards else 0)
            tsize = self.test_size // n_shards + \
                (1 if i < self.test_size % n_shards else 0)
            shards.append(KSatInstances(
                self.min_vars, self.max_vars, train_size=size,
                test_size=tsize,
                desired_multiplier_for_the_number_of_solutions=self.multiplier,
                seed=self.seed + 7919 * (i + 1)))
        return shards

    def _generate_k_clause(self, rng: random.Random, nprng, n: int, k: int
                           ) -> list[int]:
        vs = nprng.choice(n, size=min(n, k), replace=False)
        return [int(v + 1) if rng.random() < 0.5 else -int(v + 1) for v in vs]

    def _generator(self, size: int, seed: int):
        rng = random.Random(seed)
        nprng = np.random.default_rng(seed)
        for _ in range(size):
            n_vars = rng.randint(self.min_vars, self.max_vars)
            clauses: list[list[int]] = []
            while True:
                k_base = 1 if rng.random() < self.p_k_2 else 2
                k = k_base + int(nprng.geometric(self.p_geo))
                clause = self._generate_k_clause(rng, nprng, n_vars, k)
                is_sat, _ = solve(clauses + [clause], n_vars, seed=seed)
                if is_sat:
                    clauses.append(clause)
                else:
                    # negate one literal to regain satisfiability
                    clauses.append([-clause[0]] + clause[1:])
                    break
            clauses = _dedup_and_subsume(clauses)
            if self.multiplier > 1:
                # remove clauses to multiply the expected solution count
                m = len(clauses)
                x = pow(2, n_vars * 1.0 / m)
                d = round(math.log(self.multiplier, x), 0) if x > 1 else 0
                d = int(max(min(d, m - 1), 0))
                for i in sorted(rng.sample(range(m), d), reverse=True):
                    clauses = clauses[:i] + clauses[i + 1:]
            yield n_vars, clauses, None


class SAT3Instances(SatInstances):
    """Random hard 3-SAT at the SAT threshold."""

    def __init__(self, min_vars: int = 5, max_vars: int = 30,
                 train_size: int = 100_000, test_size: int = 5_000,
                 seed: int = 0):
        self.min_vars = min_vars
        self.max_vars = max_vars
        self.train_size = train_size
        self.test_size = test_size
        self.seed = seed

    def train_generator(self):
        return self._generator(self.train_size, self.seed)

    def test_generator(self):
        return self._generator(self.test_size, self.seed + 1_000_003)

    def split(self, n_shards: int):
        shards = []
        for i in range(n_shards):
            size = self.train_size // n_shards + \
                (1 if i < self.train_size % n_shards else 0)
            tsize = self.test_size // n_shards + \
                (1 if i < self.test_size % n_shards else 0)
            shards.append(SAT3Instances(
                self.min_vars, self.max_vars, train_size=size,
                test_size=tsize, seed=self.seed + 7919 * (i + 1)))
        return shards

    def _generator(self, size: int, seed: int):
        rng = random.Random(seed)
        nprng = np.random.default_rng(seed)
        for idx in range(size):
            n_vars = rng.randint(self.min_vars, self.max_vars)
            n_clauses = int(4.258 * n_vars + 58.26 * n_vars ** (-2.0 / 3.0))
            attempt = 0
            while True:
                attempt += 1
                clauses = []
                for _ in range(n_clauses):
                    vs = nprng.choice(n_vars, size=min(3, n_vars),
                                      replace=False)
                    clauses.append([int(v + 1) if rng.random() < 0.5
                                    else -int(v + 1) for v in vs])
                is_sat, solution = solve(clauses, n_vars,
                                         seed=seed + idx * 1000 + attempt)
                if is_sat:
                    break
            bits = [1 if l > 0 else 0 for l in solution]
            yield n_vars, clauses, bits


class DiffusionSatInstances(SatInstances):
    """Attach a (uniform) solution sample per instance.

    `use_unigen=True`: uniform over all models (exact enumeration, XOR-hash
    cells over the budget); False: a CDCL model. In test mode a fixed
    formula (`test_cnf`) is repeated `n_solutions * k` times, each copy with
    an independently drawn uniform label.

    `n_label_samples` > 1 attaches K independent uniform samples per
    instance (a [K, n_vars] bit list), drawn by a `UniformSampler` seeded
    `seed + idx`; the train step then draws its target row per step.
    """

    def __init__(self, base: SatInstances, use_unigen: bool = True,
                 test_cnf: cnf_mod.CNF | None = None,
                 test_solutions_multiplier_k: int = 10,
                 max_enumerate: int = 200_000, seed: int = 0,
                 n_label_samples: int = 1):
        if n_label_samples > 1 and not use_unigen:
            raise ValueError("n_label_samples > 1 requires use_unigen=True "
                             "(multi-label banks must be uniform samples)")
        self.base = base
        self.use_unigen = use_unigen
        self.test_cnf = test_cnf
        self.k = test_solutions_multiplier_k
        self.max_enumerate = max_enumerate
        self.seed = seed
        self.n_label_samples = n_label_samples

    def _solution_for(self, n_vars: int, clauses: list[list[int]],
                      idx: int):
        """One solution (list) or, for K > 1, a K-row bank (list of lists);
        None when the formula is UNSAT."""
        if self.use_unigen:
            sampler = UniformSampler(max_enumerate=self.max_enumerate,
                                     seed=self.seed + idx)
            dimacs = cnf_mod.CNF(n_vars=n_vars, clauses=clauses).to_string()
            K = self.n_label_samples
            is_sat, samples = sampler.multiple_samples(dimacs, K)
            if not is_sat:
                return None
            bits = [[1 if l > 0 else 0 for l in s] for s in samples]
            return bits if K > 1 else bits[0]
        is_sat, model = solve(clauses, n_vars, seed=self.seed + idx)
        if not is_sat:
            return None
        return [1 if l > 0 else 0 for l in model]

    def _wrap(self, gen):
        for idx, (n_vars, clauses, solution) in enumerate(gen):
            # a base-attached solution is one model; a K-row bank needs K
            # uniform draws, so it is drawn regardless
            if solution is None or self.n_label_samples > 1:
                solution = self._solution_for(n_vars, clauses, idx)
                if solution is None:
                    raise ValueError("UNSAT instance in diffusion data")
            yield n_vars, clauses, solution

    def split(self, n_shards: int):
        base_shards = self.base.split(n_shards)
        if base_shards is None:
            return None
        return [DiffusionSatInstances(
            b, use_unigen=self.use_unigen, test_cnf=self.test_cnf,
            test_solutions_multiplier_k=self.k,
            max_enumerate=self.max_enumerate,
            seed=self.seed + 104729 * (i + 1),
            n_label_samples=self.n_label_samples)
            for i, b in enumerate(base_shards)]

    def train_generator(self):
        return self._wrap(self.base.train_generator())

    def test_generator(self):
        if self.test_cnf is not None:
            return self._repeat_test_cnf()
        return self._wrap(self.base.test_generator())

    def _repeat_test_cnf(self):
        """The fixed formula n_solutions * k times, each copy with an
        independently drawn uniform solution label."""
        clauses = self.test_cnf.clauses()
        n_vars = self.test_cnf.number_of_vars()
        models, _ = enumerate_models(clauses, n_vars,
                                     max_models=self.max_enumerate,
                                     seed=self.seed)
        n_solutions = max(len(models), 1)
        rng = np.random.default_rng(self.seed)
        for _ in range(n_solutions * self.k):
            row = models[rng.integers(0, len(models))] if len(models) \
                else None
            yield n_vars, clauses, None if row is None else row.tolist()
