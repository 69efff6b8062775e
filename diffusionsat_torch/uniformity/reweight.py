"""Closed-loop per-solution label reweighting.

Counterpart of the TPU package's `uniformity/reweight.py`. The raw
diffusion sampler's residual non-uniformity is a stable per-solution bias.
`measure_bank_freq` samples the trained model on its own training formulas
and counts how often each bank row is emitted; this module turns the counts
into label-selection logits ``-beta * log(freq_hat)`` (shrunk, centred and
clamped), so over-sampled solutions receive fewer label draws on the next
training pass.

A frequency table carries two identities per batch. `fingerprint_i` is the
TPU package's: the packing only (per-graph variable counts, graph count,
bank size), so each package reads the other's tables. It cannot tell two
caches with the same packing but other formulas or banks apart, so the
port's tables add `content_fingerprint_i`, a hash of the bank and the edge
arrays, and `attach_logit_table` checks it wherever a table has it.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from diffusionsat_torch.graph.batch import attach_label_isolation


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def batch_fingerprint(batch) -> str:
    """The TPU package's identity of a packed flat batch: the per-graph
    variable counts, the graph count and the bank size."""
    nv = _np(batch.n_vars_per_graph).astype(np.int64)
    ng = int(batch.n_graphs)
    K = 0 if batch.solutions_k is None else int(batch.solutions_k.shape[0])
    h = hashlib.sha1()
    h.update(nv.tobytes())
    h.update(np.int64([ng, K]).tobytes())
    return h.hexdigest()[:16]


def content_fingerprint(batch) -> str:
    """Identity of a flat batch's content: the label bank (or the single
    label row) and the clause-sorted edge arrays, so a cache rebuilt with
    the same packing but other formulas or solutions differs."""
    h = hashlib.sha1()
    bank = batch.solutions if batch.solutions_k is None else \
        batch.solutions_k
    for t in (bank, batch.edge_lit_c, batch.edge_clause_c,
              batch.edge_mask_c):
        a = np.ascontiguousarray(_np(t))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def row_groups(sol_rows: np.ndarray) -> np.ndarray:
    """Group ids [K] over a graph's bank rows: rows with identical content
    share an id. The bank draws solutions with replacement, so duplicate
    rows are one solution and share one frequency estimate."""
    K = sol_rows.shape[0]
    _, inv = np.unique(sol_rows, axis=0, return_inverse=True)
    return inv.astype(np.int32).reshape(K)


def neglog_freq_logits(counts: np.ndarray, groups: np.ndarray,
                       tau: float = 0.5, clamp: float = 2.5) -> np.ndarray:
    """Per-row ``-log(freq_hat)`` selection logits from matched counts.

    `counts[k]` is the number of sampled assignments equal to bank row k
    (duplicate rows carry identical counts). Frequencies are shrunk toward
    the graph's mean matched frequency (pseudo-count ``tau * total / D`` per
    distinct solution); the output is centred over the K rows and clamped
    to +-clamp.
    """
    counts = np.asarray(counts, np.float64)
    groups = np.asarray(groups)
    D = int(groups.max()) + 1 if groups.size else 1
    # total matched over distinct solutions (duplicates counted once)
    first_idx = np.array([np.argmax(groups == j) for j in range(D)])
    total = float(counts[first_idx].sum())
    if total <= 0.0:
        return np.zeros(counts.shape[0], np.float32)
    prior = tau * total / D
    neglog = -np.log(counts + prior)
    neglog -= neglog.mean()
    return np.clip(neglog, -clamp, clamp).astype(np.float32)


def finalize_counts(batch, counts: np.ndarray, tau: float = 0.5,
                    clamp: float = 2.5) -> np.ndarray:
    """[K, ng] neglog-frequency logits for one flat batch from its measured
    per-row counts [K, ng] (real graphs only)."""
    sk = _np(batch.solutions_k)
    var_graph = _np(batch.var_graph)
    ng = int(batch.n_graphs)
    K = sk.shape[0]
    out = np.zeros((K, ng), np.float32)
    for g in range(ng):
        rows = sk[:, var_graph == g]
        if rows.shape[1] == 0:
            continue
        out[:, g] = neglog_freq_logits(counts[:, g], row_groups(rows),
                                       tau=tau, clamp=clamp)
    return out


def compose_label_logits(batch, iso_alpha: float, beta: float,
                         neglog: np.ndarray | None):
    """A copy of the flat batch whose `label_isolation_k` holds the combined
    per-row selection logits ``iso_alpha * isolation + beta * neglog_freq``,
    padded to the batch's graph slots. The train step reads them with
    `isolation_alpha = 1.0`."""
    K = batch.solutions_k.shape[0]
    G = batch.graph_mask.shape[0]
    logits = np.zeros((K, G), np.float32)
    if iso_alpha != 0.0:
        iso = _np(attach_label_isolation(batch).label_isolation_k)
        logits += np.float32(iso_alpha) * iso
    if neglog is not None and beta != 0.0:
        ng = neglog.shape[1]
        logits[:, :ng] += np.float32(beta) * neglog.astype(np.float32)
    return dataclasses.replace(
        batch, label_isolation_k=torch.from_numpy(logits).to(batch.device))


def attach_logit_table(batches: list, table: dict, iso_alpha: float,
                       beta: float, require_all: bool = False) -> int:
    """Attach a measured frequency table (a `measure_bank_freq` npz opened
    as a dict) to a training batch list in cache order, in place. Batches
    without a measured entry get the isolation-only logits. A measured
    batch whose fingerprint, or content fingerprint where the table has
    one, differs from the batch's raises: the table was measured on another
    cache. Returns the number of batches that got measured logits."""
    n_measured = 0
    for i, b in enumerate(batches):
        neglog = table.get(f"neglog_{i}")
        if neglog is not None:
            checks = [("fingerprint", table.get(f"fingerprint_{i}"),
                       batch_fingerprint)]
            if f"content_fingerprint_{i}" in table:
                checks.append(("content_fingerprint",
                               table[f"content_fingerprint_{i}"],
                               content_fingerprint))
            for name, want, fn in checks:
                if want is None or str(np.asarray(want)) != fn(b):
                    raise ValueError(
                        f"frequency table batch {i} {name} mismatch "
                        f"({None if want is None else np.asarray(want)} vs "
                        f"{fn(b)}): the table was measured on a different "
                        "cache build")
        elif require_all:
            raise ValueError(f"frequency table missing batch {i}")
        batches[i] = compose_label_logits(b, iso_alpha, beta, neglog)
        if neglog is not None:
            n_measured += 1
    return n_measured
