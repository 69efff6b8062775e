"""XOR-hash approximate model counting and near-uniform sampling.

Counterpart of the TPU package's `sat/xor_hash.py`: the same host code on
the same numpy streams, so equal seeds give equal cells and samples.

The reference labels diffusion training data with Unigen (hash-based
almost-uniform sampling, `satsolvers/Unigen.py:17-43`) and counts models
with approxmc (`utils/AllSolutions.py:20-41`) — both external C++ binaries
built on the same idea: conjoin the formula with random XOR parity
constraints, each of which halves the solution space in expectation, until
the surviving "cell" is small enough to enumerate exactly.

This module implements that idea over the in-process native CDCL
(sat/solvers.py): random XOR constraints are Tseitin-encoded to CNF
(chained binary XORs with auxiliary variables), cells are enumerated with
the budgeted native enumerator, and

- `approx_count` runs the ApproxMC-style median-of-estimates algorithm
  ("Algorithmic Improvements in Approximate Counting for Probabilistic
  Inference", Chakraborty/Meel/Vardi, see PAPERS.md);
- `HashUniformSampler` draws UniGen-style near-uniform samples: hash the
  space into cells of a target size, enumerate one random cell, pick one
  of its models uniformly.

Auxiliary Tseitin variables are functionally determined by the original
variables, so enumeration over the extended variable set visits each
original model exactly once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from diffusionsat_torch.sat.solvers import SatSolver, enumerate_models
from diffusionsat_torch.sat.cnf import CNF


def xor_to_cnf(var_ids: list[int], parity: int, next_aux: int
               ) -> tuple[list[list[int]], int]:
    """CNF-encode XOR(var_ids) = parity via a chain of binary XORs.

    Returns (clauses, next_free_aux_var). Empty XOR: parity 0 is a
    tautology (no clauses), parity 1 is falsified — encoded as the two
    contradictory unit clauses on a fresh variable."""
    if not var_ids:
        if parity == 0:
            return [], next_aux
        return [[next_aux], [-next_aux]], next_aux + 1
    acc = var_ids[0]
    clauses: list[list[int]] = []
    for v in var_ids[1:]:
        t = next_aux
        next_aux += 1
        # t <-> acc XOR v
        clauses += [[-acc, -v, -t], [acc, v, -t],
                    [-acc, v, t], [acc, -v, t]]
        acc = t
    clauses.append([acc] if parity else [-acc])
    return clauses, next_aux


def random_xors(rng: np.random.Generator, n_vars: int, m: int,
                density: float = 0.5) -> list[tuple[list[int], int]]:
    """m random parity constraints; each variable joins a constraint with
    probability `density` (the classic pairwise-independent hash family at
    density=0.5)."""
    out = []
    for _ in range(m):
        mask = rng.random(n_vars) < density
        vars_in = (np.nonzero(mask)[0] + 1).tolist()
        out.append((vars_in, int(rng.integers(0, 2))))
    return out


def _cell_models(clauses, n_vars: int, xors, bound: int, seed: int
                 ) -> np.ndarray:
    """Models of clauses ∧ xors, enumerated up to `bound` (projected to
    the original n_vars). Returns [k, n_vars] uint8, k <= bound."""
    ext = [list(c) for c in clauses]
    next_aux = n_vars + 1
    for var_ids, parity in xors:
        xc, next_aux = xor_to_cnf(var_ids, parity, next_aux)
        ext += xc
    models, _ = enumerate_models(ext, next_aux - 1, max_models=bound,
                                 seed=seed)
    return models[:, :n_vars] if len(models) else models


@dataclass
class CountResult:
    count: float
    exact: bool
    m: int  # XOR constraints at the final estimate (0 when exact)


def approx_count(clauses, n_vars: int, epsilon: float = 0.8,
                 delta: float = 0.2, seed: int = 0,
                 exact_budget: int | None = None) -> CountResult:
    """ApproxMC-style (epsilon, delta) model counting.

    Exact when the count fits `exact_budget` (defaults to pivot);
    otherwise median over O(log 1/delta) rounds of cell-count * 2^m with
    m chosen so the cell holds <= pivot models."""
    rng = np.random.default_rng(seed)
    pivot = int(2 * np.ceil(4.94 * (1 + 1 / epsilon) ** 2))
    budget = exact_budget if exact_budget is not None else pivot
    models, complete = enumerate_models(clauses, n_vars,
                                        max_models=max(budget, pivot) + 1,
                                        seed=seed)
    if complete:
        return CountResult(float(len(models)), True, 0)
    if n_vars > 64:  # XOR chains over very wide formulas get CDCL-hard
        density = min(0.5, 16.0 / n_vars)
    else:
        density = 0.5

    t = int(np.ceil(17 * np.log2(3 / delta))) // 4 + 1  # pragmatic rounds
    estimates = []
    m_prev = 1
    for it in range(t):
        m, cell = _search_m(clauses, n_vars, pivot, rng, m_prev, density,
                            seed + 1000 * (it + 1))
        if cell is None:
            continue
        estimates.append(len(cell) * (2.0 ** m))
        m_prev = m
    if not estimates:
        # hashing failed to isolate a small cell; report the budget floor
        return CountResult(float(len(models)), False, 0)
    return CountResult(float(np.median(estimates)), False, m_prev)


def _search_m(clauses, n_vars, pivot, rng, m_start, density, seed):
    """Find m with 1 <= |cell(m)| <= pivot. Returns (m, models) or
    (m, None) when no m isolates a non-empty small cell."""
    m = max(1, min(m_start, n_vars - 1))
    xors = random_xors(rng, n_vars, n_vars, density)
    prev_dir = 0
    for _ in range(2 * n_vars + 4):
        cell = _cell_models(clauses, n_vars, xors[:m], pivot + 1, seed)
        if len(cell) == 0:
            if m <= 1 or prev_dir > 0:  # oscillating: no m isolates a cell
                return m, None
            m -= 1
            prev_dir = -1
        elif len(cell) > pivot:
            if m >= n_vars or prev_dir < 0:
                return m, None
            m += 1
            prev_dir = 1
        else:
            return m, cell
    return m, None


class HashUniformSampler(SatSolver):
    """UniGen-style near-uniform sampler over XOR-hashed cells.

    Replaces the non-uniform random-polarity CDCL fallback of
    `UniformSampler` (sat/solvers.py) for formulas whose model count
    exceeds the exact-enumeration budget: hash the solution space into
    cells of ~`cell_target` models, enumerate one cell, sample uniformly
    within it. Within-cell choice is exactly uniform; across cells the
    hash family keeps cell sizes concentrated, so the overall distribution
    is near-uniform (reference behavior: `satsolvers/Unigen.py:17-43`)."""

    def __init__(self, cell_target: int = 48, seed: int = 0,
                 count_epsilon: float = 0.8):
        self.cell_target = cell_target
        self.seed = seed
        self.count_epsilon = count_epsilon

    def sample_bits(self, clauses, n_vars: int, n_samples: int
                    ) -> np.ndarray | None:
        """[n_samples, n_vars] uint8 near-uniform solutions, or None if
        UNSAT."""
        rng = np.random.default_rng(self.seed)
        cnt = approx_count(clauses, n_vars, epsilon=self.count_epsilon,
                           seed=self.seed,
                           exact_budget=max(self.cell_target * 4, 200))
        if cnt.count == 0:
            return None
        if cnt.exact:
            models, _ = enumerate_models(
                clauses, n_vars, max_models=int(cnt.count) + 1,
                seed=self.seed)
            rows = rng.integers(0, len(models), size=n_samples)
            return models[rows]
        m_base = max(1, int(np.floor(np.log2(cnt.count / self.cell_target))))
        density = 0.5 if n_vars <= 64 else min(0.5, 16.0 / n_vars)
        out = []
        attempts = 0
        hi = self.cell_target * 4
        while len(out) < n_samples and attempts < 8 * n_samples + 32:
            attempts += 1
            m = m_base
            xors = random_xors(rng, n_vars, max(m_base + 4, 8), density)
            cell = _cell_models(clauses, n_vars, xors[:m], hi + 1,
                                self.seed + attempts)
            # adjust once in each direction rather than a full search —
            # keeps per-sample cost bounded and the cell distribution
            # close to the plain hash family
            if len(cell) > hi and m + 2 <= n_vars:
                cell = _cell_models(clauses, n_vars, xors[:m + 2], hi + 1,
                                    self.seed + attempts)
            if len(cell) == 0 and m >= 3:
                cell = _cell_models(clauses, n_vars, xors[:m - 2], hi + 1,
                                    self.seed + attempts)
            if 0 < len(cell) <= hi:
                out.append(cell[rng.integers(0, len(cell))])
        if not out:
            return None
        if len(out) < n_samples:
            # no-silent-caps: padding duplicates already-drawn samples,
            # over-weighting their cells — make the shortfall visible
            print(f"[xor_hash] cell sampling shortfall: {len(out)}/"
                  f"{n_samples} drawn; padding by resampling", flush=True)
        while len(out) < n_samples:  # pad from what we have
            out.append(out[rng.integers(0, len(out))])
        return np.asarray(out[:n_samples], dtype=np.uint8)

    def multiple_samples(self, dimacs: str, n_samples: int
                         ) -> tuple[bool, list[list[int]]]:
        cnf = CNF.from_string(dimacs)
        clauses, n_vars = cnf.clauses(), cnf.number_of_vars()
        bits = self.sample_bits(clauses, n_vars, n_samples)
        if bits is None:
            return False, []
        out = [[(i + 1) if row[i] else -(i + 1) for i in range(n_vars)]
               for row in bits]
        return True, out
