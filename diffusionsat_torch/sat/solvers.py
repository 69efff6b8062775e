"""SAT solver layer: native CDCL, enumeration and WalkSAT behind ctypes.

Counterpart of the TPU package's `sat/solvers.py`: one in-process native
library (`sat/native/solver.cpp`, the same source), built at first use. The
public `SatSolver` contract is kept: `one_sample(dimacs) -> (is_sat,
[+/-int])` and `multiple_samples(dimacs, n) -> (is_sat, [[+/-int], ...])`.

The uniform sampler enumerates every model and picks uniformly when the
model count fits a budget, and falls back to XOR-hash near-uniform cell
sampling (`sat/xor_hash.py`) otherwise. Both draw from the same numpy
streams as the TPU package's, so equal seeds give equal samples.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from diffusionsat_torch.sat.cnf import CNF
from diffusionsat_torch.sat.native.build import build as _build_native

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def _native_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build_native()))
            lib.dsat_solve.restype = ctypes.c_int
            lib.dsat_solve.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int8), ctypes.c_uint64, ctypes.c_int,
                ctypes.c_longlong,
            ]
            lib.dsat_enumerate.restype = ctypes.c_longlong
            lib.dsat_enumerate.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int8), ctypes.c_longlong,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_int),
            ]
            lib.dsat_solve_seeded.restype = ctypes.c_int
            lib.dsat_solve_seeded.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int8), ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.dsat_walksat.restype = ctypes.c_int
            lib.dsat_walksat.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int8), ctypes.c_uint64,
                ctypes.c_longlong, ctypes.c_double, ctypes.c_int,
            ]
            _lib = lib
        return _lib


def _flatten_clauses(clauses: Sequence[Sequence[int]], n_vars: int
                     ) -> np.ndarray:
    """Zero-terminated clause list for the native calls; raises when a
    literal names a variable beyond `n_vars`."""
    flat: list[int] = []
    for c in clauses:
        flat.extend(int(x) for x in c)
        flat.append(0)
    out = np.asarray(flat, dtype=np.int32)
    if out.size and int(np.abs(out).max()) > n_vars:
        raise ValueError(f"a literal exceeds n_vars = {n_vars}")
    return out


def _n_vars_of(clauses, n_vars: int | None) -> int:
    if n_vars is None:
        return max((abs(l) for c in clauses for l in c), default=0)
    return n_vars


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _signed(model: np.ndarray) -> list[int]:
    return [(i + 1) if model[i] else -(i + 1) for i in range(len(model))]


def solve(clauses: Sequence[Sequence[int]], n_vars: int | None = None,
          seed: int = 0, rand_polarity: bool = False,
          conflict_budget: int = -1) -> tuple[bool, list[int]]:
    """CDCL-solve a clause list. Returns (is_sat, model as signed int list)."""
    n_vars = _n_vars_of(clauses, n_vars)
    flat = _flatten_clauses(clauses, n_vars)
    model = np.zeros(n_vars, dtype=np.int8)
    r = _native_lib().dsat_solve(
        n_vars, _ptr(flat, ctypes.c_int32), len(flat),
        _ptr(model, ctypes.c_int8), seed, 1 if rand_polarity else 0,
        conflict_budget)
    if r == 1:
        return True, _signed(model)
    if r == 0:
        return False, []
    raise TimeoutError("CDCL conflict budget exhausted")


def solve_seeded(clauses: Sequence[Sequence[int]], n_vars: int | None = None,
                 seed: int = 0, polarity: np.ndarray | None = None,
                 activity: np.ndarray | None = None,
                 conflict_budget: int = -1
                 ) -> tuple[bool, list[int], int]:
    """CDCL with model-seeded search (`dsat_solve_seeded`).

    `polarity`: per-var int8, -1 = solver default, 0/1 = try that value
    first (phase init = the neural prediction). `activity`: per-var f32
    initial VSIDS priors (confidence-ordered decisions). Returns (is_sat,
    signed model, conflicts). Raises TimeoutError on budget exhaustion,
    with the conflict count in the message.
    """
    n_vars = _n_vars_of(clauses, n_vars)
    flat = _flatten_clauses(clauses, n_vars)
    model = np.zeros(n_vars, dtype=np.int8)
    pol_ptr = act_ptr = None
    if polarity is not None:
        polarity = np.ascontiguousarray(polarity, dtype=np.int8)
        if polarity.shape != (n_vars,):
            raise ValueError(f"polarity must be [{n_vars}]")
        pol_ptr = _ptr(polarity, ctypes.c_int8)
    if activity is not None:
        activity = np.ascontiguousarray(activity, dtype=np.float32)
        if activity.shape != (n_vars,):
            raise ValueError(f"activity must be [{n_vars}]")
        act_ptr = _ptr(activity, ctypes.c_float)
    conflicts = ctypes.c_longlong(0)
    r = _native_lib().dsat_solve_seeded(
        n_vars, _ptr(flat, ctypes.c_int32), len(flat),
        _ptr(model, ctypes.c_int8), seed, pol_ptr, act_ptr,
        conflict_budget, ctypes.byref(conflicts))
    if r == 1:
        return True, _signed(model), int(conflicts.value)
    if r == 0:
        return False, [], int(conflicts.value)
    raise TimeoutError(
        f"CDCL conflict budget exhausted ({int(conflicts.value)} conflicts)")


def enumerate_models(clauses: Sequence[Sequence[int]],
                     n_vars: int | None = None,
                     max_models: int = 1 << 20, seed: int = 0,
                     ) -> tuple[np.ndarray, bool]:
    """Enumerate models. Returns (models [k, n_vars] uint8, complete)."""
    n_vars = _n_vars_of(clauses, n_vars)
    flat = _flatten_clauses(clauses, n_vars)
    models = np.zeros((max_models, max(n_vars, 1)), dtype=np.int8)
    complete = ctypes.c_int(0)
    found = _native_lib().dsat_enumerate(
        n_vars, _ptr(flat, ctypes.c_int32), len(flat),
        _ptr(models, ctypes.c_int8), max_models, seed,
        ctypes.byref(complete))
    return models[:found, :n_vars].astype(np.uint8), bool(complete.value)


def count_models(clauses: Sequence[Sequence[int]], n_vars: int | None = None,
                 max_models: int = 1 << 20) -> tuple[int, bool]:
    """Count models up to max_models. Returns (count, exact)."""
    models, complete = enumerate_models(clauses, n_vars, max_models)
    return len(models), complete


def walksat(clauses: Sequence[Sequence[int]], n_vars: int | None = None,
            seed: int = 0, max_flips: int = 500_000, noise: float = 0.5,
            init: np.ndarray | None = None) -> tuple[bool, list[int]]:
    """WalkSAT local search from `init` (or a seeded random start)."""
    n_vars = _n_vars_of(clauses, n_vars)
    flat = _flatten_clauses(clauses, n_vars)
    model = np.zeros(n_vars, dtype=np.int8)
    init_from_model = 0
    if init is not None:
        model[:] = np.asarray(init, dtype=np.int8)
        init_from_model = 1
    r = _native_lib().dsat_walksat(
        n_vars, _ptr(flat, ctypes.c_int32), len(flat),
        _ptr(model, ctypes.c_int8), seed, max_flips, noise, init_from_model)
    if r == 1:
        return True, _signed(model)
    return False, []


class SatSolver:
    """Solver contract: one or several models of a DIMACS formula."""

    def one_sample(self, dimacs: str) -> tuple[bool, list[int]]:
        is_sat, samples = self.multiple_samples(dimacs, n_samples=1)
        return is_sat, samples[0] if samples else []

    def multiple_samples(self, dimacs: str, n_samples: int
                         ) -> tuple[bool, list[list[int]]]:
        is_sat, sample = self.one_sample(dimacs)
        return is_sat, [sample] * n_samples if is_sat else []


class NativeCDCL(SatSolver):
    """In-process CDCL; every call takes the next seed."""

    def __init__(self, rand_polarity: bool = False, seed: int = 0):
        self.rand_polarity = rand_polarity
        self._seed = seed

    def one_sample(self, dimacs: str) -> tuple[bool, list[int]]:
        cnf = CNF.from_string(dimacs)
        self._seed += 1
        return solve(cnf.clauses(), cnf.number_of_vars(),
                     seed=self._seed, rand_polarity=self.rand_polarity)


class NativeWalkSAT(SatSolver):
    """In-process WalkSAT; every call takes the next seed."""

    def __init__(self, max_flips: int = 500_000, noise: float = 0.5,
                 seed: int = 0):
        self.max_flips = max_flips
        self.noise = noise
        self._seed = seed

    def one_sample(self, dimacs: str) -> tuple[bool, list[int]]:
        cnf = CNF.from_string(dimacs)
        self._seed += 1
        return walksat(cnf.clauses(), cnf.number_of_vars(), seed=self._seed,
                       max_flips=self.max_flips, noise=self.noise)


class UniformSampler(SatSolver):
    """Uniform solution sampler.

    Exact: enumerate all models (budgeted) and sample uniformly. Over the
    budget, XOR-hash the solution space into cells and sample near-uniformly
    within a random cell (`sat/xor_hash.HashUniformSampler`); random-polarity
    CDCL is the last resort when hashing isolates no cell.
    """

    def __init__(self, max_enumerate: int = 200_000, seed: int = 0):
        self.max_enumerate = max_enumerate
        self.seed = seed
        # repeated calls on one DIMACS text (the uniformity benchmark's
        # pattern) enumerate once
        self._enum_cache: dict[str, tuple[np.ndarray, bool]] = {}
        self._rng = np.random.default_rng(seed)

    def multiple_samples(self, dimacs: str, n_samples: int
                         ) -> tuple[bool, list[list[int]]]:
        from diffusionsat_torch.sat.xor_hash import HashUniformSampler

        cnf = CNF.from_string(dimacs)
        clauses, n_vars = cnf.clauses(), cnf.number_of_vars()
        if dimacs in self._enum_cache:  # keyed by the text: no hash clash
            models, complete = self._enum_cache[dimacs]
        else:
            models, complete = enumerate_models(
                clauses, n_vars, max_models=self.max_enumerate,
                seed=self.seed)
            if len(self._enum_cache) < 64:
                self._enum_cache[dimacs] = (models, complete)
        if len(models) == 0:
            return False, []
        rng = self._rng  # persistent: successive calls draw fresh samples
        if complete:
            picked = models[rng.integers(0, len(models), size=n_samples)]
        else:
            # a fresh hash seed per call, so successive calls draw fresh
            # cells
            call_seed = int(rng.integers(1 << 31))
            picked = HashUniformSampler(seed=call_seed).sample_bits(
                clauses, n_vars, n_samples)
            if picked is None:
                rows = []
                for k in range(n_samples):
                    ok, m = solve(clauses, n_vars, seed=self.seed + 1 + k,
                                  rand_polarity=True)
                    if not ok:
                        raise RuntimeError("CDCL found no model of a "
                                           "formula with enumerated models")
                    rows.append([1 if l > 0 else 0 for l in m])
                picked = np.asarray(rows, dtype=np.uint8)
        return True, [_signed(row) for row in picked]


def default_solver() -> SatSolver:
    return NativeCDCL()
