"""SAT solver layer: the native CDCL solver behind ctypes.

Counterpart of the `solve` half of the TPU package's `sat/solvers.py`: one
in-process native library (`sat/native/solver.cpp`, the same source), built
at first use. The enumeration, WalkSAT and uniform-sampling wrappers of that
module are not ported yet (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

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
            _lib = lib
        return _lib


def _flatten_clauses(clauses: Sequence[Sequence[int]]) -> np.ndarray:
    flat: list[int] = []
    for c in clauses:
        flat.extend(int(x) for x in c)
        flat.append(0)
    return np.asarray(flat, dtype=np.int32)


def solve(clauses: Sequence[Sequence[int]], n_vars: int | None = None,
          seed: int = 0, rand_polarity: bool = False,
          conflict_budget: int = -1) -> tuple[bool, list[int]]:
    """CDCL-solve a clause list. Returns (is_sat, model as signed int list)."""
    if n_vars is None:
        n_vars = max((abs(l) for c in clauses for l in c), default=0)
    flat = _flatten_clauses(clauses)
    if flat.size and int(np.abs(flat).max()) > n_vars:
        raise ValueError(f"a literal exceeds n_vars = {n_vars}")
    model = np.zeros(n_vars, dtype=np.int8)
    r = _native_lib().dsat_solve(
        n_vars, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(flat), model.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), seed,
        1 if rand_polarity else 0, conflict_budget)
    if r == 1:
        return True, [(i + 1) if model[i] else -(i + 1) for i in range(n_vars)]
    if r == 0:
        return False, []
    raise TimeoutError("CDCL conflict budget exhausted")
