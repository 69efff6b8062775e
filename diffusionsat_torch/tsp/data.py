"""Euclidean and asymmetric TSP instances with optimal-tour labels.

Counterpart of the TPU package's `tsp/data.py`, host numpy only, drawing
from the same numpy streams, so equal seeds give equal batches byte for
byte. Optimal tours come from the native Held-Karp DP up to n = 20
(`dsat_tsp_held_karp` of `sat/native/solver.cpp`), the native
branch-and-bound with an MST bound up to `EXACT_LABEL_MAX_N` = 30
(`dsat_tsp_branch_bound`), the Python DP as fallback up to 13, and
nearest-neighbour + 2-opt beyond. Labels mark both directions of each tour
edge for Euclidean instances and the tour's own direction for asymmetric
ones; padding rows and columns hold `PADDING_VALUE`.
"""

from __future__ import annotations

import ctypes
import random
from typing import Iterator

import numpy as np

from diffusionsat_torch.tsp import PADDING_VALUE

# labels are exact up to this size: Held-Karp DP to 20, branch-and-bound
# to 30; beyond it they are 2-opt tours (TSP_LABEL_FIDELITY.json measured
# 1.2-1.8 % mean gap for 2-opt labels at n 14-20)
EXACT_LABEL_MAX_N = 30


def held_karp(dist: np.ndarray) -> list[int]:
    """Exact TSP tour via Held-Karp DP. O(n^2 2^n); n <= ~15."""
    n = len(dist)
    full = 1 << n
    dp = np.full((full, n), np.inf)
    parent = np.full((full, n), -1, dtype=np.int64)
    dp[1][0] = 0.0
    for mask in range(1, full):
        if not mask & 1:
            continue
        for last in range(n):
            if not mask & (1 << last) or not np.isfinite(dp[mask][last]):
                continue
            base = dp[mask][last]
            for nxt in range(n):
                if mask & (1 << nxt):
                    continue
                nm = mask | (1 << nxt)
                cand = base + dist[last][nxt]
                if cand < dp[nm][nxt]:
                    dp[nm][nxt] = cand
                    parent[nm][nxt] = last
    best_last = int(np.argmin(dp[full - 1] + dist[:, 0]))
    tour = []
    mask, last = full - 1, best_last
    while last != -1:
        tour.append(last)
        nlast = parent[mask][last]
        mask ^= 1 << last
        last = int(nlast)
    return tour[::-1]


_tsp_ready = False


def tsp_lib() -> ctypes.CDLL | None:
    """The native solver library with its TSP entry points bound; None if
    it cannot be built here."""
    global _tsp_ready
    try:
        from diffusionsat_torch.sat.solvers import _native_lib
        lib = _native_lib()
    except Exception:
        return None
    if not _tsp_ready:
        lib.dsat_tsp_held_karp.restype = ctypes.c_double
        lib.dsat_tsp_held_karp.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int)]
        lib.dsat_tsp_branch_bound.restype = ctypes.c_double
        lib.dsat_tsp_branch_bound.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.c_longlong]
        lib.dsat_tsp_subtours.restype = ctypes.c_longlong
        lib.dsat_tsp_subtours.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
        _tsp_ready = True
    return lib


def _native_tour(fn_name: str, dist: np.ndarray, *extra) -> list[int] | None:
    lib = tsp_lib()
    if lib is None:
        return None
    n = len(dist)
    d = np.ascontiguousarray(dist, dtype=np.float32)
    tour = np.zeros(n, dtype=np.int32)
    length = getattr(lib, fn_name)(
        n, d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tour.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), *extra)
    if length < 0:
        return None
    return [int(x) for x in tour]


def native_held_karp(dist: np.ndarray) -> list[int] | None:
    """Exact tour via the native bitmask DP (`dsat_tsp_held_karp`); None if
    the library is unavailable."""
    return _native_tour("dsat_tsp_held_karp", dist)


def native_branch_bound(dist: np.ndarray,
                        node_budget: int = 50_000_000) -> list[int] | None:
    """Exact tour via native DFS branch-and-bound with an MST lower bound
    (`dsat_tsp_branch_bound`), past Held-Karp's 2^n memory wall. None if the
    library is unavailable or the node budget ran out before optimality
    was proven (the caller falls back to 2-opt)."""
    return _native_tour("dsat_tsp_branch_bound", dist, node_budget)


def optimal_tour(dist: np.ndarray, seed: int = 0,
                 exact_max_n: int = EXACT_LABEL_MAX_N) -> list[int]:
    """Best available tour: native exact DP to n <= 20, native exact
    branch-and-bound to `exact_max_n`, Python DP fallback to 13, 2-opt
    beyond (or if the branch-and-bound budget runs out)."""
    n = len(dist)
    if n <= min(exact_max_n, 20):
        tour = native_held_karp(dist)
        if tour is not None:
            return tour
        if n <= 13:
            return held_karp(dist)
    elif n <= exact_max_n:
        tour = native_branch_bound(dist)
        if tour is not None:
            return tour
    return two_opt_tour(dist, seed)


def two_opt_tour(dist: np.ndarray, seed: int = 0) -> list[int]:
    """Nearest-neighbour + 2-opt refinement for larger n."""
    n = len(dist)
    rng = random.Random(seed)
    cur = rng.randrange(n)
    unvisited = set(range(n)) - {cur}
    tour = [cur]
    while unvisited:
        nxt = min(unvisited, key=lambda j: dist[cur][j])
        tour.append(nxt)
        unvisited.remove(nxt)
        cur = nxt
    improved = True
    while improved:
        improved = False
        for i in range(1, n - 1):
            for j in range(i + 1, n):
                a, b = tour[i - 1], tour[i]
                c, d = tour[j], tour[(j + 1) % n]
                if a == c or b == d:
                    continue
                if dist[a][c] + dist[b][d] < dist[a][b] + dist[c][d] - 1e-12:
                    tour[i:j + 1] = tour[i:j + 1][::-1]
                    improved = True
    return tour


def tour_length(dist: np.ndarray, tour: list[int]) -> float:
    return float(sum(dist[tour[i]][tour[(i + 1) % len(tour)]]
                     for i in range(len(tour))))


def tour_to_label_matrix(tour: list[int], padded: int) -> np.ndarray:
    lbl = np.zeros((padded, padded), dtype=np.float32)
    n = len(tour)
    for i in range(n):
        a, b = tour[i], tour[(i + 1) % n]
        lbl[a, b] = 1.0
        lbl[b, a] = 1.0
    lbl[len(tour):, :] = PADDING_VALUE
    lbl[:, len(tour):] = PADDING_VALUE
    return lbl


class EuclideanTSP:
    """Random points in the unit square with optimal tour labels, as padded
    [B, P, P] arrays."""

    def __init__(self, min_node_count: int = 16, max_node_count: int = 16,
                 train_size: int = 100_000, test_size: int = 10_000,
                 padded_size: int | None = None, seed: int = 0):
        self.min_node_count = min_node_count
        self.max_node_count = max_node_count
        self.train_size = train_size
        self.test_size = test_size
        self.padded_size = padded_size or max_node_count
        self.seed = seed

    def _one(self, rng: np.random.Generator, seed: int):
        n = int(rng.integers(self.min_node_count, self.max_node_count + 1))
        coords = rng.random((n, 2)).astype(np.float32)
        dist = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2
                        ).sum(-1)).astype(np.float32)
        tour = optimal_tour(dist, seed)
        p = self.padded_size
        adj = np.full((p, p), PADDING_VALUE, dtype=np.float32)
        adj[:n, :n] = dist
        cpad = np.full((p, 2), PADDING_VALUE, dtype=np.float32)
        cpad[:n] = coords
        label = tour_to_label_matrix(tour, p)
        return adj, cpad, label

    def _generator(self, size: int, seed: int) -> Iterator:
        rng = np.random.default_rng(seed)
        for i in range(size):
            yield self._one(rng, seed + i)

    def train_generator(self):
        return self._generator(self.train_size, self.seed)

    def test_generator(self):
        return self._generator(self.test_size, self.seed + 1_000_003)

    def batches(self, mode: str, batch_size: int) -> Iterator[dict]:
        """Dicts of stacked numpy arrays: `adj_matrix` [B, P, P], `coords`
        [B, P, 2], `labels` [B, P, P]; the last batch may be smaller."""
        gen = self.train_generator() if mode == "train" \
            else self.test_generator()
        batch = []
        for item in gen:
            batch.append(item)
            if len(batch) == batch_size:
                yield self._stack(batch)
                batch = []
        if batch:
            yield self._stack(batch)

    @staticmethod
    def _stack(items) -> dict:
        adj = np.stack([a for a, _, _ in items])
        coords = np.stack([c for _, c, _ in items])
        labels = np.stack([l for _, _, l in items])
        return {"adj_matrix": adj, "coords": coords, "labels": labels}


class AsymmetricTSP(EuclideanTSP):
    """Random asymmetric distance matrices with exact small-n labels."""

    def _one(self, rng: np.random.Generator, seed: int):
        n = int(rng.integers(self.min_node_count, self.max_node_count + 1))
        dist = rng.random((n, n)).astype(np.float32)
        np.fill_diagonal(dist, 0.0)
        tour = optimal_tour(dist, seed)
        p = self.padded_size
        adj = np.full((p, p), PADDING_VALUE, dtype=np.float32)
        adj[:n, :n] = dist
        label = np.zeros((p, p), dtype=np.float32)
        for i in range(n):
            label[tour[i], tour[(i + 1) % n]] = 1.0
        label[n:, :] = PADDING_VALUE
        label[:, n:] = PADDING_VALUE
        cpad = np.full((p, 2), PADDING_VALUE, dtype=np.float32)
        return adj, cpad, label
