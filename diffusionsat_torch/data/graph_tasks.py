"""Graph-derived CNF tasks: Clique, DominatingSet, KColor.

Counterpart of the TPU package's `data/graph_tasks.py`: the same
encodings (slot variables; distinctness; adjacency constraints) over
Erdős–Rényi graphs, SAT-filtered by the native CDCL solver. That package
draws its graphs with networkx's `gnp_random_graph`; the port carries the
same draw in `gnp_random_graph` below (the card's machine has no
networkx), with networkx's vertex, neighbour and edge orders, so both
packages build the same formulas from the same seeds.
"""

from __future__ import annotations

import itertools
import random
from typing import Iterator

from diffusionsat_torch.data.generators import Instance, SatInstances
from diffusionsat_torch.sat.solvers import solve


class Graph:
    """A simple undirected graph on vertices 0..n-1 that keeps networkx's
    orders: `nodes()` ascending, each vertex's neighbours in the order
    their edges were added, `edges()` as (u, v) with u visited first."""

    def __init__(self, n: int):
        self._adj: dict[int, dict[int, None]] = {v: {} for v in range(n)}

    def add_edge(self, u: int, v: int) -> None:
        self._adj[u][v] = None
        self._adj[v][u] = None

    def nodes(self) -> list[int]:
        return list(self._adj)

    def neighbors(self, v: int) -> Iterator[int]:
        return iter(self._adj[v])

    def has_edge(self, u: int, v: int) -> bool:
        return v in self._adj[u]

    def edges(self) -> list[tuple[int, int]]:
        seen: set[int] = set()
        out = []
        for u, nbrs in self._adj.items():
            out.extend((u, v) for v in nbrs if v not in seen)
            seen.add(u)
        return out


def gnp_random_graph(n: int, p: float, seed: int) -> Graph:
    """G(n, p) as networkx draws it for an integer seed: one
    `random.Random(seed).random()` per vertex pair in
    `itertools.combinations` order, an edge where it lies below p; the
    complete graph for p >= 1 and the empty one for p <= 0, drawing
    nothing."""
    g = Graph(n)
    if p >= 1:
        for u, v in itertools.combinations(range(n), 2):
            g.add_edge(u, v)
        return g
    if p <= 0:
        return g
    rng = random.Random(seed)
    for u, v in itertools.combinations(range(n), 2):
        if rng.random() < p:
            g.add_edge(u, v)
    return g


def clique_formula(graph: Graph, k: int) -> tuple[int, list[list[int]]]:
    """x_{i,v}: slot i (of k) is vertex v. Clauses: each slot filled;
    slots pairwise adjacent & distinct."""
    nodes = list(graph.nodes())
    n = len(nodes)
    idx = {v: j for j, v in enumerate(nodes)}

    def var(i: int, v) -> int:
        return i * n + idx[v] + 1

    clauses = [[var(i, v) for v in nodes] for i in range(k)]
    for i in range(k):
        for j in range(i + 1, k):
            for u in nodes:
                for v in nodes:
                    if u == v or not graph.has_edge(u, v):
                        clauses.append([-var(i, u), -var(j, v)])
    return k * n, clauses


def dominating_set_formula(graph: Graph, d: int
                           ) -> tuple[int, list[list[int]]]:
    """y_{i,v}: slot i (of d) is vertex v. Each slot filled; every vertex
    dominated by some slot vertex in its closed neighborhood."""
    nodes = list(graph.nodes())
    n = len(nodes)
    idx = {v: j for j, v in enumerate(nodes)}

    def var(i: int, v) -> int:
        return i * n + idx[v] + 1

    clauses = [[var(i, v) for v in nodes] for i in range(d)]
    for v in nodes:
        closed = [v] + list(graph.neighbors(v))
        clauses.append([var(i, u) for i in range(d) for u in closed])
    return d * n, clauses


def coloring_formula(graph: Graph, c: int) -> tuple[int, list[list[int]]]:
    """x_{v,j}: vertex v has color j. Some color; at most one; adjacent
    vertices differ."""
    nodes = list(graph.nodes())
    idx = {v: j for j, v in enumerate(nodes)}

    def var(v, j: int) -> int:
        return idx[v] * c + j + 1

    clauses = [[var(v, j) for j in range(c)] for v in nodes]
    for v in nodes:
        for j1 in range(c):
            for j2 in range(j1 + 1, c):
                clauses.append([-var(v, j1), -var(v, j2)])
    for u, v in graph.edges():
        for j in range(c):
            clauses.append([-var(u, j), -var(v, j)])
    return len(nodes) * c, clauses


class _GraphTaskInstances(SatInstances):
    def __init__(self, min_vertices: int, max_vertices: int, train_size: int,
                 test_size: int, seed: int = 0):
        self.min_vertices = min_vertices
        self.max_vertices = max_vertices
        self.train_size = train_size
        self.test_size = test_size
        self.seed = seed

    def train_generator(self) -> Iterator[Instance]:
        return self._generator(self.train_size, self.seed)

    def test_generator(self) -> Iterator[Instance]:
        return self._generator(self.test_size, self.seed + 1_000_003)

    def _make(self, rng: random.Random) -> tuple[int, list[list[int]]]:
        raise NotImplementedError

    def _generator(self, size: int, seed: int) -> Iterator[Instance]:
        rng = random.Random(seed)
        for i in range(size):
            attempt = 0
            while True:
                attempt += 1
                n_vars, clauses = self._make(rng)
                # only the verdict counts: the draws are the same either way
                is_sat, _ = solve(clauses, n_vars, seed=seed + i + attempt)
                if is_sat:
                    break
            yield n_vars, clauses, None


class CliqueInstances(_GraphTaskInstances):
    """Triangle detection in Erdős–Rényi graphs: p chosen so that a
    triangle exists w.p. ~0.5."""

    def __init__(self, min_vertices: int = 4, max_vertices: int = 40,
                 train_size: int = 50_000, test_size: int = 10_000,
                 clique_size_min: int = 3, clique_size_max: int = 3,
                 seed: int = 0):
        super().__init__(min_vertices, max_vertices, train_size, test_size,
                         seed)
        self.clique_size_min = clique_size_min
        self.clique_size_max = clique_size_max

    def _make(self, rng):
        n = rng.randint(self.min_vertices, self.max_vertices)
        p = 3 ** (1 / 3) / (n * (2 - 3 * n + n ** 2)) ** (1 / 3)
        g = gnp_random_graph(n, p, seed=rng.randint(0, 1 << 30))
        k = rng.randint(self.clique_size_min, self.clique_size_max)
        return clique_formula(g, k)


class DomSetInstances(_GraphTaskInstances):
    """Dominating set of size ceil(n/3) in G(n, 0.2)."""

    def __init__(self, min_vertices: int = 4, max_vertices: int = 12,
                 train_size: int = 10_000, test_size: int = 5_000,
                 seed: int = 0):
        super().__init__(min_vertices, max_vertices, train_size, test_size,
                         seed)

    def _make(self, rng):
        n = rng.randint(self.min_vertices, self.max_vertices)
        d = (n + 2) // 3
        g = gnp_random_graph(n, 0.2, seed=rng.randint(0, 1 << 30))
        return dominating_set_formula(g, d)


class KColorInstances(_GraphTaskInstances):
    """Graph coloring with ~n/5+1 colors in G(n, 0.5)."""

    def __init__(self, min_vertices: int = 4, max_vertices: int = 20,
                 train_size: int = 50_000, test_size: int = 10_000,
                 seed: int = 0):
        super().__init__(min_vertices, max_vertices, train_size, test_size,
                         seed)

    def _make(self, rng):
        n = rng.randint(self.min_vertices, self.max_vertices)
        c = (n // 5) + 1
        if c == 2:
            c = 3
        g = gnp_random_graph(n, 0.5, seed=rng.randint(0, 1 << 30))
        return coloring_formula(g, c)
