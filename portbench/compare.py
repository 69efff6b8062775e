"""The numbers that decide `correct`, computed the same way for every cell.

Training cells read four numbers against the reference's:

- `loss_gap`: the mean gap of a step's loss from the reference's over
  every step followed, over the largest reference loss among them. Over
  the largest, because a step's own loss can be near zero (QuerySAT's
  diffusion loss at a noise level t >= 0.9801 keeps only a small term
  quadratic in the logits, and a gap relative to it reads 20x what it
  reads at any other t); the mean, because a step's gap is a signed sum
  of rounding errors whose size swings from step to step;
- `early_loss_gap`: the same over the steps taken before AdaBelief's
  rectification opens (`SHUT_STEPS`): after it, round-off grows into the
  losses of an f32 program as it does into those of the controls;
- `grad1_gap`: the first gradient as the optimizer gets it, before its
  clip, by the worst leaf: the gap between the two leaf norms over the
  larger of the reference leaf's norm and the median leaf's. (After the
  clip, which holds every leaf of the first step at a norm of 0.01 at
  most, the norms would say nothing);
- `change3_gap`: the parameters' change over the first three steps, by the
  worst leaf, measured the same way. Leaves whose reference gradient, as
  the optimizer takes it after its clip, is under a thousandth of the
  median leaf's move by round-off alone under AdaBelief and are left out
  of it.

A cell's `limits` name the numbers its check compares; `PERF.md` says
which, and why the others are not.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3   # of the median leaf's first-gradient norm
# a state's first losses taken before AdaBelief's rectification opens:
# from its 6th update on (the SMA past 5) each entry's step is divided by
# that entry's own spread, which blows round-off up into the later losses
SHUT_STEPS = 6


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, keys=None) -> list[float]:
    """Per leaf, the gap between its two norms over the larger of the
    reference leaf's norm and the median leaf's (a NaN reads inf)."""
    pn, rn = _norms(prog), _norms(ref)
    keys = list(rn) if keys is None else list(keys)
    med = statistics.median(rn[k] for k in rn)
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]
    return [float("inf") if g != g else g for g in gaps]


def moving_leaves(ref_grad1: dict) -> list:
    rn = _norms(ref_grad1)
    med = statistics.median(rn.values())
    return [k for k, v in rn.items() if v >= NEGLIGIBLE * med]


def mean_loss_gap(prog: list, ref: list) -> float:
    """The mean gap of the losses over the largest reference loss."""
    if not ref:
        return 0.0
    if any(a != a for a in prog):
        return float("inf")
    scale = max(max(abs(b) for b in ref), 1e-30)
    return statistics.fmean(abs(a - b) for a, b in zip(prog, ref)) / scale


def training(prog: dict, ref: dict) -> dict:
    """`prog` and `ref`: {"losses": [...], "grad1": {leaf: tensor},
    "p0": {...}, "p_end": {...}} over the same steps; `prog` also holds
    "at", each loss's step in its state (from 0), and `ref` "taken1", the
    first gradient after the clip. Returns the numbers."""
    n = len(ref["losses"])
    pl, rl = prog["losses"][:n], ref["losses"]
    shut = [i for i, k in enumerate(prog["at"][:n]) if k < SHUT_STEPS]
    keys = moving_leaves(ref["taken1"])
    change_p = {k: prog["p_end"][k] - prog["p0"][k] for k in keys}
    change_r = {k: ref["p_end"][k] - ref["p0"][k] for k in keys}
    return {"loss_gap": mean_loss_gap(pl, rl),
            "early_loss_gap": mean_loss_gap([pl[i] for i in shut],
                                            [rl[i] for i in shut]),
            "grad1_gap": max(leaf_gaps(prog["grad1"], ref["grad1"])),
            "change3_gap": max(leaf_gaps(change_p, change_r))}


def as_checks(numbers: dict, limits: dict) -> dict:
    """The numbers a cell's limits name, each beside its limit."""
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
