"""Model counting with exact/approximate interface parity.

Counterpart of the TPU package's `sat/all_solutions.py`, the port of
reference `utils/AllSolutions.py:8-41` (pyunigen/pyapproxmc
backed): `count()` returns the number of solutions, exact when the
enumeration budget suffices, otherwise a sampling-based lower-bound
estimate flagged approximate.
"""

from __future__ import annotations

from typing import Sequence

from diffusionsat_torch.sat.solvers import enumerate_models


class AllSolutions:
    def __init__(self, n_vars: int, clauses: Sequence[Sequence[int]],
                 max_enumerate: int = 200_000, seed: int = 0):
        self.n_vars = n_vars
        self.clauses = [list(c) for c in clauses]
        self.max_enumerate = max_enumerate
        self.seed = seed
        self._models = None
        self._complete = None
        self._approx = None

    def _ensure(self):
        if self._models is None:
            self._models, self._complete = enumerate_models(
                self.clauses, self.n_vars, max_models=self.max_enumerate,
                seed=self.seed)

    def count(self) -> int:
        """Number of solutions: exact when the enumeration budget
        suffices, else an ApproxMC-style XOR-hash estimate (reference
        pyapproxmc slot, `utils/AllSolutions.py:20-41`)."""
        self._ensure()
        if self._complete:
            return len(self._models)
        if self._approx is None:
            from diffusionsat_torch.sat.xor_hash import approx_count
            # enumeration already proved the count exceeds the budget, so
            # the tiny exact recheck inside approx_count suffices; cache —
            # the XOR search is dozens of budgeted CDCL enumerations
            self._approx = approx_count(self.clauses, self.n_vars,
                                        seed=self.seed)
        return max(int(self._approx.count), len(self._models))

    @property
    def is_exact(self) -> bool:
        self._ensure()
        return bool(self._complete)

    def solutions(self):
        """All enumerated models as 0/1 bit rows [count, n_vars]."""
        self._ensure()
        return self._models
