"""Useful matrix work of QuerySAT steps, by product class.

The accounting of `_useful_macs` in `diffusionsat_torch/bench.py` (commit
ca3446b): per round, the MLP rows of every real variable and clause, and
q multiply-adds per real edge in each of the four literal-clause
products; no padding, no recomputation. A train step is the forward of
`train_rounds` rounds plus twice that for the backward; a solving pass is
the forward of its rounds. The MLP part is summed over the layer widths
of the reference (`reference/querysat-3sat-128.py`, `mlp_dims`), not
copied from `_mlp_row_macs`: that formula counts the clause MLP's two
layers with a third hidden-by-hidden product and the message MLP's
4q x 4q layer as 4q^2 multiply-adds instead of 16q^2.
"""

from __future__ import annotations

from portbench import harness

_ref = harness.load_module("reference", "querysat-3sat-128")

# which rows each MLP runs on
_VAR_MLPS = ("update_gate", "variables_output", "variables_query",
             "lit_mlp")
_CLAUSE_MLPS = ("clause_mlp",)


def row_macs(cfg: dict) -> tuple[int, int]:
    """Multiply-adds of one round's MLPs per variable row and per clause
    row."""
    dims = _ref.mlp_dims(cfg)

    def macs(d):
        return sum(a * b for a, b in zip(d[:-1], d[1:]))
    return (sum(macs(dims[n]) for n in _VAR_MLPS),
            sum(macs(dims[n]) for n in _CLAUSE_MLPS))


def step_flops(cfg: dict, item: dict, kind: str) -> dict:
    """FLOPs by product class ("mlp", "incidence") of one step over `item`
    (its real `n_vars`, `n_clauses`, `n_edges`): kind "train" (the
    configuration's train rounds, forward and backward) or "solve"
    (`item["rounds"]` forward rounds)."""
    var_macs, clause_macs = row_macs(cfg)
    macs = {"mlp": item["n_vars"] * var_macs + item["n_clauses"] * clause_macs,
            "incidence": 4 * item["n_edges"] * cfg["query_maps"]}
    factor = 2 * cfg["train_rounds"] * 3 if kind == "train" \
        else 2 * item["rounds"]
    return {k: v * factor for k, v in macs.items()}
