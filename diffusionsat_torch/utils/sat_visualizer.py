"""CNF structure pictures: the variable-interaction graph and the factor
graph, each saved to a PNG.

Counterpart of the TPU package's `utils/sat_visualizer.py` (the reference's
networkx drawings rebuilt without networkx): a force-directed layout in
numpy on `np.random.default_rng(seed)`, equal to that package's layout bit
for bit, and matplotlib line collections. The layout is host code and
touches no device. matplotlib is imported by the drawing functions alone,
so the module imports without it and a drawing call raises ImportError
where it is missing.
"""

from __future__ import annotations

import itertools
import math
from pathlib import Path

import numpy as np


def _spring_layout(n_nodes: int, edges: np.ndarray, iters: int = 60,
                   seed: int = 0) -> np.ndarray:
    """Fruchterman-Reingold force layout (the nx.spring_layout slot)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, size=(n_nodes, 2))
    k = 1.0 / math.sqrt(max(n_nodes, 1))
    t = 0.1
    for _ in range(iters):
        delta = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(delta, axis=-1) + 1e-9
        # repulsion between all pairs
        force = (k * k / dist ** 2)[..., None] * delta
        disp = force.sum(axis=1)
        # attraction along edges
        if len(edges):
            d = pos[edges[:, 0]] - pos[edges[:, 1]]
            dn = np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
            pull = d * dn / k
            np.add.at(disp, edges[:, 0], -pull)
            np.add.at(disp, edges[:, 1], pull)
        length = np.linalg.norm(disp, axis=-1, keepdims=True) + 1e-9
        pos = pos + disp / length * np.minimum(length, t)
        t *= 0.95
    return pos


def draw_interaction_graph(var_count: int, clauses: list,
                           out_path: str | Path = "interaction_graph.png"
                           ) -> Path:
    """Variable-interaction graph (Sinz, SAT-2005; reference
    utils/sat_visualizer.py:10-44): vertices are variables, an edge joins
    two variables sharing a clause, darker = more co-occurrences."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    counts: dict[tuple[int, int], int] = {}
    for clause in clauses:
        for u, v in itertools.combinations(clause, 2):
            a, b = sorted((abs(u) - 1, abs(v) - 1))
            if a != b:
                counts[(a, b)] = counts.get((a, b), 0) + 1
    edges = np.asarray(list(counts.keys()), dtype=int).reshape(-1, 2)
    weights = np.asarray(list(counts.values()), dtype=float)
    pos = _spring_layout(var_count, edges)

    fig, ax = plt.subplots(figsize=(6, 6))
    if len(edges):
        shade = np.log10(weights + 1)
        shade = shade / max(shade.max(), 1e-9)
        for (a, b), s in zip(edges, shade):
            ax.plot(pos[[a, b], 0], pos[[a, b], 1],
                    color=str(0.9 - 0.8 * s), lw=1, zorder=1)
    ax.scatter(pos[:, 0], pos[:, 1], s=20, c="green", zorder=2)
    ax.set_axis_off()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def draw_factor_graph(var_count: int, clauses: list,
                      out_path: str | Path = "factor_graph.png") -> Path:
    """Bipartite variable-clause factor graph (reference
    utils/sat_visualizer.py:47-75): blue edges = positive literal, red =
    negated; green nodes = variables, cyan = clauses."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = var_count + len(clauses)
    edges, colors = [], []
    for ci, clause in enumerate(clauses):
        for lit in clause:
            edges.append((abs(lit) - 1, var_count + ci))
            colors.append("b" if lit > 0 else "r")
    edges = np.asarray(edges, dtype=int).reshape(-1, 2)
    pos = _spring_layout(n, edges)

    fig, ax = plt.subplots(figsize=(6, 6))
    for (a, b), c in zip(edges, colors):
        ax.plot(pos[[a, b], 0], pos[[a, b], 1], color=c, lw=0.8,
                alpha=0.6, zorder=1)
    ax.scatter(pos[:var_count, 0], pos[:var_count, 1], s=24, c="green",
               zorder=2, label="variables")
    ax.scatter(pos[var_count:, 0], pos[var_count:, 1], s=24, c="cyan",
               zorder=2, label="clauses")
    ax.legend(loc="lower right", fontsize=8)
    ax.set_axis_off()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
