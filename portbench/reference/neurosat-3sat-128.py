"""Plain reference of NeuroSAT (Selsam et al., arXiv:1802.03685).

Plain PyTorch in float32 on the formulas' own edge list: `index_add_`
segment sums, no kernel, plan, graph, padding or batching of the program,
TF32 off. It follows the algorithm of `model/neuro_sat.py` of
LUMII-Syslab/DiffusionSAT, as the program's `models/neuro_sat.py` ports it
(commit 6676f08): each round a 3-layer MLP message from every literal
summed into its clauses, an LSTM cell that updates the clauses, a 3-layer
MLP reply summed into the literals, joined with the flipped literal
state, a second LSTM cell that updates the literals, and a 3-layer vote
MLP on each variable's two literal states. AdaBelief is the program's
(`_adabelief.py` beside this file). It imports nothing of the program or
of JAX.

Where it departs from the paper, as DiffusionSAT does:

- training runs 32 rounds (the paper trains at 26);
- the loss is unsupervised: each round's `softplus_log_square` loss of
  the vote's logits, summed over the clauses and over the rounds and
  divided by the rounds taken less one (the paper: the cross-entropy of
  the mean vote against a single SAT/UNSAT bit, after the last round);
- the vote is one logit per variable, an assignment, from the
  concatenation of its two literal states (the paper: a vote per
  literal, averaged);
- once the rounded assignment satisfies every clause of the batch and the
  round's loss is under 0.5, the states, the loss and the rounds taken
  freeze (the paper runs a fixed number of rounds);
- the LSTM cells are Keras LSTMCells without layer norm, gate order i, f,
  c, o, unit forget bias; the MLPs' hidden activation is leaky ReLU
  (slope 0.2), where the paper uses layer-normed LSTMs and ReLU.

The initial literal and clause states are learned rows over sqrt(d), as in
the paper's code. The program draws nothing in a step, so there are no
draws to replay.

`precision` rounds the operands of every product (MLP layers, the LSTM
products, the message sums) as in `querysat-3sat-128.py`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def _sibling(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_reference_{name.replace('-', '_')}",
        Path(__file__).with_name(f"{name}.py"))
    if spec.name not in sys.modules:
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[spec.name]


_qs = _sibling("querysat-3sat-128")
AdaBelief, rounder, flatten = _qs.AdaBelief, _qs.rounder, _qs.flatten

EPS = 1e-8
LOG_ONE = float(torch.log(torch.tensor(1 + EPS, dtype=torch.float32)))


def mlp_dims(cfg: dict) -> dict[str, list[int]]:
    """Layer widths [in, hidden..., out] of the three MLPs."""
    f, ml, vl = cfg["feature_maps"], cfg["msg_layers"], cfg["vote_layers"]
    return {"LC_msg": [f] * (ml + 1), "CL_msg": [f] * (ml + 1),
            "L_vote": [2 * f] * vl + [1]}


def lstm_dims(cfg: dict) -> dict[str, int]:
    """Input width of each LSTM cell (hidden width `feature_maps`)."""
    f = cfg["feature_maps"]
    return {"L_update": 2 * f, "C_update": f}


def init_params(cfg: dict, seed: int, device) -> dict:
    """The program's tree, from `seed` on `device`: init rows N(0, 0.05),
    glorot-uniform input and MLP kernels, orthogonal recurrent kernels,
    zero biases but the LSTMs' unit forget gate."""
    f = cfg["feature_maps"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def glorot(a, b):
        lim = math.sqrt(6.0 / (a + b))
        return torch.rand((a, b), generator=gen, device=device) * \
            (2 * lim) - lim

    params = {
        "L_init": torch.randn((1, f), generator=gen, device=device) * 0.05,
        "C_init": torch.randn((1, f), generator=gen, device=device) * 0.05}
    for name, d_in in lstm_dims(cfg).items():
        q, r = torch.linalg.qr(torch.randn((4 * f, f), generator=gen,
                                           device=device))
        bias = torch.zeros(4 * f, device=device)
        bias[f:2 * f] = 1.0
        params[name] = {"kernel": glorot(d_in, 4 * f),
                        "recurrent": (q * torch.sign(torch.diagonal(r)))
                        .T.contiguous(),
                        "bias": bias}
    for name, d in mlp_dims(cfg).items():
        params[name] = {"w": [glorot(a, b) for a, b in zip(d[:-1], d[1:])],
                        "b": [torch.zeros(b, device=device) for b in d[1:]]}
    return params


@dataclasses.dataclass
class Graph:
    """Formulas in one index space: variable v of the batch is literal v,
    its negation literal V + v."""
    V: int
    C: int
    lit: torch.Tensor        # [E] literal of each edge
    clause: torch.Tensor     # [E] clause of each edge


def build_graph(formulas, device) -> Graph:
    """`formulas`: [(n_vars, clauses)], clauses as signed 1-based ints."""
    V = sum(n for n, _ in formulas)
    lit, clause = [], []
    v_off = c_off = 0
    for n, clauses in formulas:
        for c in clauses:
            for x in c:
                var = v_off + abs(x) - 1
                lit.append(var if x > 0 else V + var)
                clause.append(c_off)
            c_off += 1
        v_off += n
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),  # noqa
                                  device=device)
    return Graph(V=V, C=c_off, lit=t(lit), clause=t(clause))


def _seg(x, index, n):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add_(0, index, x)


def l2c(gr: Graph, x):
    """[2V, F] literal rows summed into their clauses: [C, F]."""
    return _seg(x[gr.lit], gr.clause, gr.C)


def c2l(gr: Graph, y):
    """[C, F] clause rows summed into their literals: [2V, F]."""
    return _seg(y[gr.clause], gr.lit, 2 * gr.V)


def mlp(p, x, q):
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = q(x) @ q(w) + b
        if i < n - 1:
            x = F.leaky_relu(x, 0.2)
    return x


def lstm(p, x, h, c, q):
    """A Keras LSTMCell: gates i, f, c, o from [x, h]; returns (h, c)."""
    z = q(x) @ q(p["kernel"]) + q(h) @ q(p["recurrent"]) + p["bias"]
    zi, zf, zg, zo = torch.chunk(z, 4, dim=1)
    c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    return torch.sigmoid(zo) * torch.tanh(c), c


def clause_loss(gr: Graph, logits):
    """The round's loss: the sum over the clauses of the square of
    -log(1 - exp(-sum over the clause's literals of softplus(+/-logit)))."""
    lits = torch.cat([logits, -logits], dim=0)
    v = torch.exp(-l2c(gr, F.softplus(lits)))
    return torch.sum(torch.square(-(torch.log(1 - v + EPS) - LOG_ONE)))


def unsatisfied(gr: Graph, logits) -> int:
    """Clauses with no true literal under the rounded assignment."""
    x = torch.round(torch.sigmoid(logits.detach()))
    true_lits = l2c(gr, torch.cat([x, 1 - x], dim=0))
    return int((true_lits == 0).sum())


def forward(params, cfg: dict, gr: Graph, rounds: int, precision="f32"):
    """Returns (loss, logits [V, 1] of the last state's vote, each round's
    loss, rounds taken)."""
    q = rounder(precision)
    V, f = gr.V, cfg["feature_maps"]
    dev = gr.lit.device

    def vote(lits):
        return mlp(params["L_vote"], torch.cat([lits[:V], lits[V:]], dim=1),
                   q)

    lh = (params["L_init"] / math.sqrt(f)).repeat(2 * V, 1)
    ch = (params["C_init"] / math.sqrt(f)).repeat(gr.C, 1)
    lc = torch.zeros((2 * V, f), device=dev)
    cc = torch.zeros((gr.C, f), device=dev)
    per_round = []
    for _ in range(rounds):
        msg = l2c(gr, q(mlp(params["LC_msg"], lh, q)))
        ch, cc = lstm(params["C_update"], msg, ch, cc, q)
        reply = c2l(gr, q(mlp(params["CL_msg"], ch, q)))
        flipped = torch.cat([lh[V:], lh[:V]], dim=0)
        lh, lc = lstm(params["L_update"], torch.cat([reply, flipped], dim=1),
                      lh, lc, q)
        logits = vote(lh)
        loss = clause_loss(gr, logits)
        per_round.append(loss)
        if float(loss.detach()) < 0.5 and unsatisfied(gr, logits) == 0:
            break
    loss = torch.stack(per_round).sum() / max(len(per_round) - 1, 1)
    return loss, vote(lh), per_round, len(per_round)


def train_steps(params, cfg: dict, steps, optimizer, precision="f32",
                keep_after: int | None = None):
    """`steps`: [Graph], one a step. Returns (losses, the first step's
    gradients as the optimizer gets them and as it takes them after its
    clip, the params after step `keep_after`, by default the last)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaves = dict(flatten(params))
    state = optimizer.init(leaves)
    losses, first, kept = [], None, None
    for i, gr in enumerate(steps):
        p = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        loss, _, _, _ = forward(unflatten(p), cfg, gr, cfg["rounds"],
                                precision)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), grads)}
        leaves, state, taken = optimizer.update(grads, state, leaves)
        if first is None:
            first = ({k: g.detach() for k, g in grads.items()}, taken)
        losses.append(float(loss.detach()))
        if i + 1 == keep_after:
            kept = leaves
    return losses, *first, leaves if kept is None else kept


def unflatten(leaves: dict) -> dict:
    """The tree of `flatten`'s keys: `L_init`, `L_update/kernel`,
    `LC_msg/w/0`."""
    out: dict = {}
    for key, v in leaves.items():
        parts = key.split("/")
        if len(parts) == 1:
            out[key] = v
        elif len(parts) == 2:
            out.setdefault(parts[0], {})[parts[1]] = v
        else:
            out.setdefault(parts[0], {"w": [], "b": []})[parts[1]].append(v)
    return out
