"""Baseline samplers with the `.samples(n) -> {solution_int: count}` contract.

Counterpart of the TPU package's `uniformity/samplers.py`: host numpy on the
same `np.random.default_rng` streams, so equal inputs and seeds give equal
counts.

Analogs of the reference's UnigenSampler / QuickSampler
(`satuniformity/UnigenSampler.py:12-35`, `satuniformity/QuickSampler.py`):
ExactUniformSampler draws from the enumerated model set (the Unigen slot);
WalkSatSampler draws via randomized local search (the QuickSampler slot —
fast, biased, used as the non-uniform baseline).
"""

from __future__ import annotations

import time

import numpy as np

from diffusionsat_torch.sat.cnf import CNF, VariableAssignment
from diffusionsat_torch.sat.solvers import UniformSampler, walksat


class ExactUniformSampler:
    def __init__(self, cnf: CNF, seed: int = 0, max_enumerate: int = 200_000):
        self.cnf = cnf
        self.seed = seed
        self.max_enumerate = max_enumerate
        # the model set is formula-static: enumerate once, reuse across
        # samples() calls (was re-enumerated per call)
        self._sampler = UniformSampler(max_enumerate=max_enumerate,
                                       seed=seed)
        self._dimacs = cnf.to_string()

    def samples(self, n_samples: int) -> dict[int, int]:
        is_sat, rows = self._sampler.multiple_samples(self._dimacs,
                                                      n_samples)
        counts: dict[int, int] = {}
        if not is_sat:
            return counts
        for lits in rows:
            asgn = VariableAssignment(self.cnf.number_of_vars(),
                                      self.cnf.clauses())
            asgn.assign_all_from_int_list(lits)
            k = int(asgn)
            counts[k] = counts.get(k, 0) + 1
        return counts


class MetropolisRefiner:
    """Uniformizing Metropolis refiner over the solution set.

    Wraps any base sampler with the `.samples(n) -> {solution_int: count}`
    contract: each collected solution seeds a Metropolis chain on the
    hypercube restricted to satisfying assignments — propose flipping one
    uniformly-random variable, accept iff the result still satisfies.
    The proposal is symmetric and the target uniform, so detailed balance
    gives a uniform stationary distribution over each connected component
    of the solution graph (rejection self-loops make it aperiodic).

    The refiner therefore removes within-component bias from the base
    sampler while preserving its across-component mass — the diffusion
    sampler supplies diverse component coverage (its job), MH supplies
    exact within-component uniformity (its job). No reference analog:
    the reference's Unigen slot gets uniformity from XOR hashing instead
    (`satuniformity/UnigenSampler.py:12-35`); this is the TPU-era hybrid
    (model proposes, exact chain corrects).
    """

    def __init__(self, cnf: CNF, base, n_steps: int | None = None,
                 seed: int = 0):
        self.cnf = cnf
        self.base = base
        n = cnf.number_of_vars()
        # ~20 sweeps of the n-dim solution subgraph mixes far past the
        # benchmark sizes (10-16 vars); override for bigger formulas
        self.n_steps = n_steps if n_steps is not None else 20 * n
        self.rng = np.random.default_rng(seed)
        # clause tensors for vectorized evaluation: var index + wanted sign
        k = max(len(c) for c in cnf.clauses())
        self._cl_var = np.zeros((len(cnf.clauses()), k), dtype=np.int64)
        self._cl_pos = np.zeros((len(cnf.clauses()), k), dtype=bool)
        self._cl_msk = np.zeros((len(cnf.clauses()), k), dtype=bool)
        for ci, cl in enumerate(cnf.clauses()):
            for j, lit in enumerate(cl):
                self._cl_var[ci, j] = abs(lit) - 1
                self._cl_pos[ci, j] = lit > 0
                self._cl_msk[ci, j] = True

    def _sat(self, x: np.ndarray) -> np.ndarray:
        """x [B, n] bool -> [B] all-clauses-satisfied."""
        lit_true = x[:, self._cl_var] == self._cl_pos   # [B, C, k]
        lit_true &= self._cl_msk
        return lit_true.any(axis=2).all(axis=1)

    def _keys_to_bits(self, counts: dict[int, int]) -> np.ndarray:
        """Expand a count histogram into a [B, n] bool chain-state array."""
        n = self.cnf.number_of_vars()
        seeds = [key for key, c in counts.items() for _ in range(c)]
        x = np.zeros((len(seeds), n), dtype=bool)
        for i, key in enumerate(seeds):
            for b in range(n):
                x[i, b] = (key >> b) & 1
        return x

    def _bits_to_counts(self, x: np.ndarray) -> dict[int, int]:
        n = self.cnf.number_of_vars()
        out: dict[int, int] = {}
        weights = 1 << np.arange(n, dtype=object)
        for row in x:
            key = int(sum(w for w, b in zip(weights, row) if b))
            out[key] = out.get(key, 0) + 1
        return out

    def _mh_steps(self, x: np.ndarray, n_steps: int) -> np.ndarray:
        """`n_steps` vectorized 1-flip Metropolis steps on every chain."""
        n = self.cnf.number_of_vars()
        B = len(x)
        if B == 0 or n_steps == 0:
            return x
        flips = self.rng.integers(0, n, size=(n_steps, B))
        for t in range(n_steps):
            idx = flips[t]
            x[np.arange(B), idx] ^= True
            ok = self._sat(x)
            x[np.arange(B)[~ok], idx[~ok]] ^= True     # reject: revert
        return x

    def refine(self, counts: dict[int, int]) -> dict[int, int]:
        """Run the MH chain from every collected sample; recount."""
        x = self._keys_to_bits(counts)
        if len(x) == 0:
            return {}
        if not self._sat(x).all():
            raise ValueError("refiner seeded with an UNSAT assignment")
        x = self._mh_steps(x, self.n_steps)
        return self._bits_to_counts(x)

    def samples(self, n_samples: int) -> dict[int, int]:
        counts = self.base.samples(n_samples)
        t0 = time.perf_counter()
        refined = self.refine(counts)
        # host seconds of the refinement alone, apart from the base sampler
        self.refine_seconds = time.perf_counter() - t0
        self.success_rate = getattr(self.base, "success_rate", None)
        return refined


class XorCellJumpRefiner(MetropolisRefiner):
    """MetropolisRefiner plus XOR-cell *jump* moves that cross solution
    components.

    The MH chain-length study (MH_CHAIN_STUDY.json) showed the 1-flip
    Metropolis kernel saturates: it is uniform within each connected
    component of the solution graph but provably preserves the base
    sampler's across-component mass. This kernel closes that gap.

    Jump move from solution x: draw m random XOR constraints whose
    variable subsets come from the density-d hash family (independent of
    x) and whose parities are set so x satisfies them; enumerate the cell
    = models(F ∧ XORs) up to `cell_budget`; if the enumeration completes,
    move to a uniformly-random element of the cell, else stay.

    Correctness: for y ≠ x, q(y|x) = Σ_{subsets S: y ∈ cell} P(S)/|cell|
    with the sum over hashes whose parities agree on x and y — a set (and
    summand) symmetric in x and y, and P(S) does not depend on x. Hence
    q(y|x) = q(x|y): a symmetric proposal, so with a uniform target the
    Metropolis acceptance is 1 (always move). The budget rejection rule
    depends only on |cell| (a property of the hash, not the endpoint),
    preserving symmetry. Any pair x, y lands in a common cell with
    probability 2^-m over hash draws, so the chain is irreducible over
    the WHOLE solution set, not per-component. Interleaved 1-flip sweeps
    (also uniform-stationary) supply cheap within-component mixing.

    This is the same XOR machinery the Unigen slot uses
    (`sat/xor_hash.py`; reference `satuniformity/UnigenSampler.py:12-35`)
    recast as an MCMC move, so it scales past exact enumeration: each
    jump enumerates only an expected-count/2^m cell, never the full set.
    """

    def __init__(self, cnf: CNF, base, n_jumps: int = 4,
                 cell_target: int = 8, cell_budget: int | None = None,
                 density: float | None = None, sweeps_between: int = 5,
                 seed: int = 0):
        n = cnf.number_of_vars()
        super().__init__(cnf, base, n_steps=sweeps_between * n, seed=seed)
        self.n_jumps = n_jumps
        self.cell_target = cell_target
        self.cell_budget = cell_budget or 4 * cell_target
        # match xor_hash.py's wide-formula density taper (long XOR chains
        # make the CDCL's life hard without improving the hash)
        self.density = density if density is not None else (
            0.5 if n <= 64 else min(0.5, 16.0 / n))
        self._m: int | None = None

    def _choose_m(self) -> int:
        """m with expected cell size ~cell_target, from an approximate
        model count (lazy: one count per formula, reused by every jump)."""
        if self._m is None:
            from diffusionsat_torch.sat.xor_hash import approx_count
            cnt = approx_count(self.cnf.clauses(),
                               self.cnf.number_of_vars(),
                               seed=int(self.rng.integers(1 << 30)),
                               exact_budget=4 * self.cell_budget)
            c = max(cnt.count, 1.0)
            self._m = max(0, int(np.ceil(np.log2(
                max(c / self.cell_target, 1.0)))))
        return self._m

    def _jump(self, x: np.ndarray) -> np.ndarray:
        """One XOR-cell jump from solution x ([n] bool)."""
        from diffusionsat_torch.sat.xor_hash import _cell_models
        n = self.cnf.number_of_vars()
        m = self._choose_m()
        xors = []
        for _ in range(m):
            mask = self.rng.random(n) < self.density
            vars_in = (np.nonzero(mask)[0] + 1).tolist()
            parity = int(x[mask].sum() % 2)  # pass the hash through x
            xors.append((vars_in, parity))
        cell = _cell_models(self.cnf.clauses(), n, xors,
                            bound=self.cell_budget + 1,
                            seed=int(self.rng.integers(1 << 30)))
        if len(cell) == 0 or len(cell) > self.cell_budget:
            return x  # truncated (oversized) cell: stay, by symmetric rule
        return cell[self.rng.integers(0, len(cell))].astype(bool)

    def refine(self, counts: dict[int, int]) -> dict[int, int]:
        x = self._keys_to_bits(counts)
        if len(x) == 0:
            return {}
        if not self._sat(x).all():
            raise ValueError("refiner seeded with an UNSAT assignment")
        for _ in range(self.n_jumps):
            for i in range(len(x)):
                x[i] = self._jump(x[i])
            x = self._mh_steps(x, self.n_steps)
        return self._bits_to_counts(x)


class WalkSatSampler:
    def __init__(self, cnf: CNF, seed: int = 0, max_flips: int = 500_000):
        self.cnf = cnf
        self.seed = seed
        self.max_flips = max_flips

    def samples(self, n_samples: int) -> dict[int, int]:
        counts: dict[int, int] = {}
        n = self.cnf.number_of_vars()
        clauses = self.cnf.clauses()
        rng = np.random.default_rng(self.seed)
        got = 0
        attempts = 0
        while got < n_samples and attempts < n_samples * 20:
            attempts += 1
            init = rng.integers(0, 2, size=n).astype(np.int8)
            ok, model = walksat(clauses, n, seed=int(rng.integers(1 << 30)),
                                max_flips=self.max_flips, init=init)
            if not ok:
                continue
            asgn = VariableAssignment(n, clauses)
            asgn.assign_all_from_int_list(model)
            k = int(asgn)
            counts[k] = counts.get(k, 0) + 1
            got += 1
        return counts
