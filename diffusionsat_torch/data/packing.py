"""Greedy size-sorted packing of formulas into static-shape buckets.

The same packer as the TPU package's `data/packing.py`: sort instances by
node count (2V + C), greedily fill batches against the bucket's static
limits (vars / clauses / edges / graphs), shuffle the batch order.
"""

from __future__ import annotations

import random
from typing import Sequence

from diffusionsat_torch.graph.batch import BucketSpec

Instance = tuple[int, list[list[int]], list[int] | None]


def pack_instances(instances: Sequence[Instance], bucket: BucketSpec,
                   shuffle_batches: bool = True, seed: int = 0,
                   utilization: float = 1.0) -> list[list[Instance]]:
    """Pack instances into batches that fit the bucket.

    `utilization` scales the effective limits (e.g. 0.9 leaves headroom).
    Instances too large for the (scaled) bucket are dropped with a warning.
    """
    v_lim = int(bucket.max_vars * utilization)
    c_lim = int(bucket.max_clauses * utilization)
    e_lim = int(bucket.max_edges * utilization)
    g_lim = bucket.max_graphs

    def size_of(inst: Instance) -> tuple[int, int, int]:
        n_vars, clauses, _ = inst
        return n_vars, len(clauses), sum(len(c) for c in clauses)

    sized = [(size_of(inst), inst) for inst in instances]
    dropped = [s for s, _ in sized
               if s[0] > v_lim or s[1] > c_lim or s[2] > e_lim]
    if dropped:
        print(f"WARNING: {len(dropped)} formulas exceed the bucket and were "
              f"dropped")
    sized = [(s, inst) for s, inst in sized
             if s[0] <= v_lim and s[1] <= c_lim and s[2] <= e_lim]
    # similar sizes batch together -> less padding waste
    sized.sort(key=lambda x: (2 * x[0][0] + x[0][1], x[0][2]))

    batches: list[list[Instance]] = []
    cur: list[Instance] = []
    cv = cc = ce = 0
    for (v, c, e), inst in sized:
        if cur and (cv + v > v_lim or cc + c > c_lim or ce + e > e_lim
                    or len(cur) >= g_lim):
            batches.append(cur)
            cur, cv, cc, ce = [], 0, 0, 0
        cur.append(inst)
        cv += v
        cc += c
        ce += e
    if cur:
        batches.append(cur)

    if shuffle_batches:
        random.Random(seed).shuffle(batches)
    return batches
