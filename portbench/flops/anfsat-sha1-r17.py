"""Useful work of ANFSAT train steps, by product class.

Per round: every MLP on the real rows it runs on (variables, AND nodes,
clauses), summed over the reference's layer widths
(`reference/anfsat-sha1-r17.py`, `mlp_dims`), and one multiply-add per
real membership edge and column in the sums (the query's angle and length
sums and the messages into clauses, 2q columns; the replies into nodes, q
columns) and per AND operand slot in the scatter back to the variables (q
columns). No padding, no recomputation: a train step is the forward of
`train_rounds` rounds plus twice that for the backward (the program
recomputes every round in the backward; that is not counted).
"""

from __future__ import annotations

from portbench import harness

_ref = harness.load_module("reference", "anfsat-sha1-r17")

_ROWS = {"variables_query": "n_vars", "var2clause_mlp": "n_vars",
         "update_gate": "n_vars", "variables_output": "n_vars",
         "var2ands_mlp": "n_ands", "ands_mlp": "n_ands",
         "clause_mlp": "n_clauses"}


def step_flops(cfg: dict, item: dict, kind: str) -> dict:
    """FLOPs by product class ("mlp", "incidence") of one train step over
    `item` (its real `n_vars`, `n_ands`, `n_clauses`, `n_edges`)."""
    dims = _ref.mlp_dims(cfg)
    q = cfg["query_maps"]
    mlp = sum(item[rows] * sum(a * b for a, b in zip(dims[n][:-1],
                                                      dims[n][1:]))
              for n, rows in _ROWS.items())
    sums = 3 * q * item["n_edges"] + 2 * q * item["n_ands"]
    factor = 2 * cfg["train_rounds"] * 3
    return {"mlp": mlp * factor, "incidence": sums * factor}
