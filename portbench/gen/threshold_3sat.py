"""Threshold 3-SAT formulas, sorted by size and packed to a node budget.

Copied from `diffusionsat_torch/data/bench_workloads.py`
(`threshold_3sat_batches_sorted`, commit ca3446b): m = int(4.258 n +
58.26 n^(-2/3)) clauses of three distinct variables, each negated with
probability 1/2, random label bits, formulas sorted by variable count and
packed greedily while 2V + C stays within the node budget and the bucket
of `BucketSpec.for_node_budget` holds them. Changed here: the sizes come
from the traffic (`formulas_per_size` of every n, so every seed packs the
same batch shapes and the seed changes only what the formulas say), and a
formula's clauses are drawn in one numpy call (another random stream than
the program's copy for the same seed).
"""

from __future__ import annotations

import numpy as np


def clause_count(n: int) -> int:
    return int(4.258 * n + 58.26 * n ** (-2.0 / 3.0))


def bucket_limits(budget: int, max_graphs: int) -> dict:
    """`graph/batch.BucketSpec.for_node_budget` (mean clause length 3.2)."""
    up = lambda x, m: ((int(x) + m - 1) // m) * m  # noqa: E731
    max_clauses = up(max(int(budget * 0.75), 128), 128)
    return {"max_vars": up(max(budget // 4, 128), 128),
            "max_clauses": max_clauses,
            "max_edges": up(int(max_clauses * 3.2), 512),
            "max_graphs": max_graphs}


def formula(rng: np.random.Generator, n: int) -> list[list[int]]:
    m = clause_count(n)
    var = np.argsort(rng.random((m, n)), axis=1)[:, :3] + 1
    sign = np.where(rng.random((m, 3)) < 0.5, 1, -1)
    return (var * sign).tolist()


def formulas(rng: np.random.Generator, sizes) -> list[tuple]:
    """[(n, clauses, label bits)] for the variable counts in `sizes`, in
    that order."""
    return [(n, formula(rng, n), rng.integers(0, 2, size=n).tolist())
            for n in sizes]


def sized_pool(rng: np.random.Generator, traffic: dict) -> list[tuple]:
    """`formulas_per_size` formulas of every n in [min_vars, max_vars], in
    an order drawn from `rng`."""
    k = traffic["formulas_per_size"]
    pool = []
    for n in range(traffic["min_vars"], traffic["max_vars"] + 1):
        m = clause_count(n)
        var = np.argsort(rng.random((k, m, n)), axis=2)[:, :, :3] + 1
        sign = np.where(rng.random((k, m, 3)) < 0.5, 1, -1)
        bits = rng.integers(0, 2, size=(k, n))
        pool += [(n, (var[i] * sign[i]).tolist(), bits[i].tolist())
                 for i in range(k)]
    return [pool[i] for i in rng.permutation(len(pool))]


def pack(items, budget: int, limits: dict, sort: bool = True) -> list[list]:
    """Greedy packing of (n, clauses, ...) items: sorted by variable count
    (stable) when `sort`, else in arrival order; a batch is cut where the
    next item would break the node budget or the bucket."""
    order = sorted(range(len(items)), key=lambda i: items[i][0]) if sort \
        else range(len(items))
    out, cur = [], []
    v = c = e = 0
    for i in order:
        n, clauses = items[i][0], items[i][1]
        m = len(clauses)
        if cur and (2 * (v + n) + c + m > budget
                    or v + n > limits["max_vars"]
                    or c + m > limits["max_clauses"]
                    or e + 3 * m > limits["max_edges"]
                    or len(cur) >= limits["max_graphs"]):
            out.append(cur)
            cur, v, c, e = [], 0, 0, 0
        cur.append(items[i])
        v, c, e = v + n, c + m, e + 3 * m
    if cur:
        out.append(cur)
    return out
