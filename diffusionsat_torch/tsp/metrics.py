"""TSP decoders and the optimality-gap metric, host numpy.

Counterpart of the TPU package's `tsp/metrics.py`: greedy and beam-search
tour decoding from the model's edge probability matrix, and the relative
optimality gap against the labelled tour.
"""

from __future__ import annotations

import numpy as np

from diffusionsat_torch.tsp import PADDING_VALUE
from diffusionsat_torch.tsp.data import EXACT_LABEL_MAX_N, tour_length


def get_unpadded_size(row: np.ndarray) -> int:
    idx = np.where(row == PADDING_VALUE)[0]
    return int(idx[0]) if len(idx) else len(row)


def greedy_decode(probs: np.ndarray, n: int) -> list[int]:
    """Follow max-probability outgoing edges from node 0."""
    visited = [0]
    cur = 0
    for _ in range(n - 1):
        order = np.argsort(-probs[cur, :n])
        for nxt in order:
            if nxt not in visited:
                visited.append(int(nxt))
                cur = int(nxt)
                break
    return visited


def beam_decode(probs: np.ndarray, n: int, beam_width: int = 128
                ) -> list[int]:
    """Beam search over partial tours scored by the sum of log-probs."""
    logp = np.log(np.clip(probs[:n, :n], 1e-12, 1.0))
    beams = [(0.0, [0], 1 << 0)]
    for _ in range(n - 1):
        cand = []
        for score, tour, mask in beams:
            cur = tour[-1]
            for nxt in range(n):
                if mask & (1 << nxt):
                    continue
                cand.append((score + logp[cur, nxt], tour + [nxt],
                             mask | (1 << nxt)))
        cand.sort(key=lambda x: -x[0])
        beams = cand[:beam_width]
    best = max(beams, key=lambda x: x[0] + logp[x[1][-1], 0])
    return best[1]


class TSPMetrics:
    """Mean optimality gap of decoded tours against the labels. The labels
    are exact up to `EXACT_LABEL_MAX_N` nodes (tsp/data.py); beyond it they
    are 2-opt tours, and the values say so (`label_basis_note`)."""

    EXACT_LABEL_MAX_N = EXACT_LABEL_MAX_N

    def __init__(self, beam_width: int = 128, use_beam: bool = True):
        self.beam_width = beam_width
        self.use_beam = use_beam
        self.gaps: list[float] = []
        self.sizes: list[int] = []

    def update_state(self, model_output: dict, batch: dict) -> None:
        """`model_output["prediction"]`: [B, P, P] logits (a tensor on any
        device, or an array); `batch`: the data's dict of arrays."""
        preds = model_output["prediction"]
        if hasattr(preds, "detach"):
            preds = preds.detach().cpu().numpy()
        preds = np.asarray(preds)
        adj = np.asarray(batch["adj_matrix"])
        labels = np.asarray(batch["labels"])
        probs = 1.0 / (1.0 + np.exp(-preds))
        for g in range(preds.shape[0]):
            n = get_unpadded_size(adj[g][0])
            if n < 3:
                continue
            dist = adj[g][:n, :n]
            if self.use_beam:
                tour = beam_decode(probs[g], n, self.beam_width)
            else:
                tour = greedy_decode(probs[g], n)
            # the optimal length from the label matrix (Euclidean labels
            # mark both directions: walk avoiding revisits)
            model_len = tour_length(dist, tour)
            neigh: dict[int, list[int]] = {}
            for i, j in np.argwhere(labels[g][:n, :n] == 1.0):
                neigh.setdefault(int(i), []).append(int(j))
            opt_tour = [0]
            seen = {0}
            while len(opt_tour) < n:
                options = [j for j in neigh.get(opt_tour[-1], [])
                           if j not in seen]
                if not options:
                    break
                opt_tour.append(options[0])
                seen.add(options[0])
            opt_len = tour_length(dist, opt_tour)
            if opt_len > 0:
                self.gaps.append(model_len / opt_len - 1.0)
                self.sizes.append(n)

    def get_values(self, reset_state: bool = True) -> dict:
        out = {"optimality_gap": float(np.mean(self.gaps)) if self.gaps
               else 0.0,
               "solved_optimal": float(np.mean([g <= 1e-6 for g in
                                                self.gaps]))
               if self.gaps else 0.0}
        exact = [g for g, n in zip(self.gaps, self.sizes)
                 if n <= self.EXACT_LABEL_MAX_N]
        heur = [g for g, n in zip(self.gaps, self.sizes)
                if n > self.EXACT_LABEL_MAX_N]
        if heur:
            out["gap_vs_exact_labels"] = (float(np.mean(exact))
                                          if exact else None)
            out["gap_vs_2opt_labels"] = float(np.mean(heur))
            out["label_basis_note"] = (
                f"{len(heur)} tours scored against 2-opt labels (n > "
                f"{self.EXACT_LABEL_MAX_N}; heuristic labels carry "
                "~1.2-1.8% mean bias, TSP_LABEL_FIDELITY.json)")
        if reset_state:
            self.gaps = []
            self.sizes = []
        return out
