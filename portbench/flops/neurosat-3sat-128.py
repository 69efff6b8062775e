"""Useful work of NeuroSAT train steps, by product class.

Per round, on the real rows (`reference/neurosat-3sat-128.py`'s widths):

- `mlp`: the literal message MLP on the 2V literal rows, the clause reply
  MLP on the C clause rows, the vote MLP on the V variable rows;
- `lstm`: the clause cell's two products ([x, h] of widths d and d into
  4d) on the C clause rows, the literal cell's ([x, h] of widths 2d and
  d into 4d) on the 2V literal rows;
- `incidence`: d multiply-adds per real edge in each of the two message
  sums (literals into clauses, clauses into literals). The loss's sums
  (three columns an edge) are left out: under 2 % of the class.

No padding, no recomputation, every round (an untrained batch never
freezes): a train step is the forward of `rounds` rounds plus twice that
for the backward.
"""

from __future__ import annotations

from portbench import harness

_ref = harness.load_module("reference", "neurosat-3sat-128")


def _macs(d: list[int]) -> int:
    return sum(a * b for a, b in zip(d[:-1], d[1:]))


def step_flops(cfg: dict, item: dict, kind: str) -> dict:
    """FLOPs by product class ("mlp", "lstm", "incidence") of one train
    step over `item` (its real `n_vars`, `n_clauses`, `n_edges`)."""
    f = cfg["feature_maps"]
    dims = _ref.mlp_dims(cfg)
    lstm_in = _ref.lstm_dims(cfg)
    lits, clauses = 2 * item["n_vars"], item["n_clauses"]
    macs = {
        "mlp": lits * _macs(dims["LC_msg"]) + clauses * _macs(dims["CL_msg"])
        + item["n_vars"] * _macs(dims["L_vote"]),
        "lstm": clauses * (lstm_in["C_update"] + f) * 4 * f
        + lits * (lstm_in["L_update"] + f) * 4 * f,
        "incidence": 2 * item["n_edges"] * f}
    factor = 2 * cfg["rounds"] * 3
    return {k: v * factor for k, v in macs.items()}
