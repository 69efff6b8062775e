"""Random threshold 3-SAT workload packed to a node budget.

The same generator as the TPU package's `data/bench_workloads.py`: clause
count m = 4.258n + 58.26 n^(-2/3), formulas packed while 2V + C stays
within the budget, either as they come (`threshold_3sat_batch`) or sorted
by size first (`threshold_3sat_batches_sorted`, the batch stream of the
training driver and of `diffusionsat_torch.bench`). The same `rng` state
gives the same formulas in both packages.
"""

from __future__ import annotations

import numpy as np

from diffusionsat_torch.graph.batch import BucketSpec, SatBatch, build_batch


def threshold_3sat_batch(rng: np.random.Generator, budget: int,
                         min_vars: int = 3, max_vars: int = 30,
                         bucket: BucketSpec | None = None,
                         max_graphs: int = 512) -> tuple[SatBatch, int]:
    """Pack random threshold 3-SAT formulas to the node budget.

    Returns (SatBatch, real_edge_count). Labels are random bits (they need
    not be true solutions)."""
    if bucket is None:
        bucket = BucketSpec.for_node_budget(budget, max_graphs=max_graphs)
    formulas, sols = [], []
    v_tot = c_tot = e_tot = 0
    while True:
        n = int(rng.integers(min_vars, max_vars + 1))
        m = int(4.258 * n + 58.26 * n ** (-2.0 / 3.0))
        clauses = []
        for _ in range(m):
            vs = rng.choice(n, size=3, replace=False) + 1
            clauses.append([int(v) if rng.random() < 0.5 else -int(v)
                            for v in vs])
        if (2 * (v_tot + n) + c_tot + m > budget
                or v_tot + n > bucket.max_vars
                or c_tot + m > bucket.max_clauses
                or e_tot + 3 * m > bucket.max_edges
                or len(formulas) >= bucket.max_graphs):
            break
        formulas.append((n, clauses))
        sols.append(rng.integers(0, 2, size=n).tolist())
        v_tot += n
        c_tot += m
        e_tot += 3 * m
    return build_batch(formulas, bucket, solutions=sols), e_tot


def threshold_3sat_batches_sorted(rng: np.random.Generator, budget: int,
                                  n_batches: int, min_vars: int = 3,
                                  max_vars: int = 30,
                                  max_graphs: int = 512,
                                  with_formulas: bool = False) -> list:
    """Size-sorted packing, the layout the training driver runs: enough
    formulas for `n_batches` full batches, sorted by variable count and
    packed greedily, so batches are size-homogeneous and the dense blocks
    pad little.

    Returns a list of (SatBatch, real_edge_count), with the batch's raw
    (formulas, solutions) appended when `with_formulas`."""
    bucket = BucketSpec.for_node_budget(budget, max_graphs=max_graphs)
    formulas, sols = [], []
    # about n_batches worth of real nodes, so the sorted stream spans the
    # whole size range
    node_target = budget * n_batches
    nodes = 0
    while nodes < node_target:
        n = int(rng.integers(min_vars, max_vars + 1))
        m = int(4.258 * n + 58.26 * n ** (-2.0 / 3.0))
        clauses = []
        for _ in range(m):
            vs = rng.choice(n, size=3, replace=False) + 1
            clauses.append([int(v) if rng.random() < 0.5 else -int(v)
                            for v in vs])
        formulas.append((n, clauses))
        sols.append(rng.integers(0, 2, size=n).tolist())
        nodes += 2 * n + m
    order = sorted(range(len(formulas)), key=lambda i: formulas[i][0])
    out = []
    cur_f, cur_s = [], []
    v_tot = c_tot = e_tot = 0

    def emit():
        rec = (build_batch(cur_f, bucket, solutions=cur_s), e_tot)
        if with_formulas:
            rec = rec + (list(cur_f), list(cur_s))
        out.append(rec)

    for i in order:
        n, clauses = formulas[i]
        m = len(clauses)
        if cur_f and (2 * (v_tot + n) + c_tot + m > budget
                      or v_tot + n > bucket.max_vars
                      or c_tot + m > bucket.max_clauses
                      or e_tot + 3 * m > bucket.max_edges
                      or len(cur_f) >= bucket.max_graphs):
            emit()
            cur_f, cur_s = [], []
            v_tot = c_tot = e_tot = 0
        cur_f.append((n, clauses))
        cur_s.append(sols[i])
        v_tot += n
        c_tot += m
        e_tot += 3 * m
    # the trailing partial batch holds the largest formulas of the sorted
    # stream: dropping it would cut the top of the size range
    if cur_f:
        emit()
    return out
