"""Plain reference of ANFSAT (a GNN over ANF equation systems).

Plain PyTorch in float32 with `index_add_` segment sums and no kernel,
plan, graph or padding of the program. It follows the algorithm of
`diffusionsat_torch/models/anf_sat.py` and `losses/anf.py` at commit
ca3446b (reference `model/anf_sat.py` of LUMII-Syslab/DiffusionSAT):
complex-valued query clause evaluation, variable and AND-node messages
into clauses, a clause MLP with PairNorm, an AND-node MLP whose output is
added back to both operand variables, the supervised cross-entropy with
0.1 label smoothing, the 0.2 / 0.8 state blend. It builds its graph from
the equations themselves and imports nothing of the program or of JAX.

`precision` rounds the operands of every product and membership sum as in
`querysat-3sat-128.py`. The program's only draw in a train step is the
per-round noise, [V, 4] at the padded variable count: `train_draws`
replays it and keeps the real rows.
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
_seg, _pair_norm = _qs._seg, _qs._pair_norm


def mlp_dims(cfg: dict) -> dict[str, list[int]]:
    f, q = cfg["feature_maps"], cfg["query_maps"]
    h_up = int(f * cfg["update_scale"])
    h_cl = int(f * cfg["clauses_scale"])
    ml, vl = cfg["msg_layers"], cfg["vote_layers"]

    def d(i, h, o, n):
        return [i] + [h] * (n - 1) + [o]
    return {
        "update_gate": d(f + q, h_up, f, ml),
        "variables_output": d(f, int(f * cfg["output_scale"]), 1, vl),
        "variables_query": d(f + 4, int(q * cfg["query_scale"]), q, vl),
        "clause_mlp": d(f + 2 * q, h_up, f + q, ml),
        "grad_mlp": d(q, h_cl, q, ml),
        "ands_mlp": d(2 * f + q, h_cl, q, ml),
        "var2ands_mlp": d(2 * f, h_cl, q, ml),
        "var2clause_mlp": d(f, h_cl, q, ml),
    }


def init_params(cfg: dict, seed: int, device) -> dict:
    """Glorot-uniform kernels and zero biases from `seed` in one draw on
    `device`, and the constant node's row `zero_var` at 0.02, as the
    program initializes it (`grad_mlp` is part of the tree, unused)."""
    dims = mlp_dims(cfg)
    shapes = [(a, b) for d in dims.values() for a, b in zip(d[:-1], d[1:])]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(a * b for a, b in shapes), generator=gen,
                   device=device)
    params, at = {}, 0
    for name, d in dims.items():
        ws, bs = [], []
        for a, b in zip(d[:-1], d[1:]):
            lim = math.sqrt(6.0 / (a + b))
            ws.append((u[at:at + a * b].view(a, b) * (2 * lim) - lim)
                      .contiguous())
            bs.append(torch.zeros(b, device=device))
            at += a * b
        params[name] = {"w": ws, "b": bs}
    params["zero_var"] = torch.full((1, cfg["query_maps"]), 0.02,
                                    device=device)
    return params


@dataclasses.dataclass
class Graph:
    """Systems in one index space: node 0 the constant one, nodes 1..V the
    variables, V+1..V+A the AND pairs (one per distinct pair a system
    holds)."""
    V: int
    A: int
    C: int
    G: int
    node: torch.Tensor          # [E] member node of each edge
    clause: torch.Tensor        # [E]
    and1: torch.Tensor          # [A] 0-based variable rows
    and2: torch.Tensor
    var_graph: torch.Tensor     # [V]
    clause_graph: torch.Tensor  # [C]
    n_vars: torch.Tensor        # [G] f32
    n_clauses: torch.Tensor     # [G] f32


def build_graph(systems, device) -> Graph:
    """`systems`: [(n_vars, equations)], each equation a list of terms:
    () the constant, (i,) variable i (1-based), (i, j) the AND of two."""
    V = sum(n for n, _ in systems)
    node, clause, a1, a2, vg, cg = [], [], [], [], [], []
    v_off = c_off = 0
    for g, (n, eqs) in enumerate(systems):
        pairs: dict = {}
        for ci, eq in enumerate(eqs):
            for t in eq:
                if len(t) == 0:
                    nd = 0
                elif len(t) == 1:
                    nd = 1 + v_off + t[0] - 1
                else:
                    key = (min(t), max(t))
                    if key not in pairs:
                        pairs[key] = len(a1)
                        a1.append(v_off + key[0] - 1)
                        a2.append(v_off + key[1] - 1)
                    nd = -1 - pairs[key]     # AND nodes numbered below
                node.append(nd)
                clause.append(c_off + ci)
        vg += [g] * n
        cg += [g] * len(eqs)
        v_off += n
        c_off += len(eqs)
    node = np.asarray(node)
    node = np.where(node < 0, 1 + V + (-1 - node), node)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),  # noqa
                                  device=device)
    return Graph(V=V, A=len(a1), C=c_off, G=len(systems), node=t(node),
                 clause=t(clause), and1=t(a1), and2=t(a2), var_graph=t(vg),
                 clause_graph=t(cg),
                 n_vars=torch.tensor([float(n) for n, _ in systems],
                                     device=device),
                 n_clauses=torch.tensor([float(len(e)) for _, e in systems],
                                        device=device))


def mlp(p, x, q):
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = q(x) @ q(w) + b
        if i < n - 1:
            x = F.leaky_relu(x, 0.2)
    return x


def _zero_state(n, f, device):
    onehot = torch.zeros((n, f), device=device)
    onehot[:, 0] = 1.0
    return (onehot - 1.0 / f) * math.sqrt(f) * 0.25


def _cplx_and(a, b):
    ar, ai = torch.chunk(a, 2, dim=-1)
    br, bi = torch.chunk(b, 2, dim=-1)
    a1r, b1r, a1i, b1i = (1 - ar) / 2, (1 - br) / 2, -ai / 2, -bi / 2
    return 1 - 2 * (a1r * b1r), -2 * (a1r * b1i + a1i * b1r)


def forward(params, cfg: dict, gr: Graph, labels, round_noise, rounds: int,
            precision="f32"):
    """Returns (loss, logits [V, 1])."""
    q = rounder(precision)
    dev = gr.node.device
    V, Q, f = gr.V, cfg["query_maps"], cfg["feature_maps"]
    n_nodes = 1 + V + gr.A
    ones_e = torch.ones((gr.node.shape[0], 1), device=dev)
    deg_w = torch.rsqrt(_seg(ones_e, gr.node, n_nodes).clamp(min=1.0))
    cdeg_w = torch.rsqrt(_seg(ones_e, gr.clause, gr.C).clamp(min=1.0))
    smoothed = 0.05 + labels.float()[:, None] * 0.9

    def to_clauses(x):
        return _seg(q(x)[gr.node], gr.clause, gr.C)

    def to_nodes(y):
        return _seg(q(y)[gr.clause], gr.node, n_nodes)

    variables = _zero_state(V, f, dev)
    clause_state = _zero_state(gr.C, f, dev)
    loss_sum = torch.zeros((), device=dev)
    logits = None
    for r in range(rounds):
        v1 = torch.cat([variables, round_noise[r]], dim=1)
        query = mlp(params["variables_query"], v1, q)
        n = Q // 2
        one = torch.cat([-torch.ones((1, n), device=dev),
                         torch.zeros((1, n), device=dev)], dim=1)
        values = torch.cat([one, torch.tanh(query)], dim=0)      # [1+V, Q]
        ar, ai = _cplx_and(values[1 + gr.and1], values[1 + gr.and2])
        vr, vi = torch.chunk(values, 2, dim=1)
        re = torch.cat([vr, ar], dim=0)
        im = torch.cat([vi, ai], dim=0)
        angle = torch.atan2(im, re)
        log_len = 0.5 * torch.log(re * re + im * im + 1e-16)
        sums = to_clauses(torch.cat([angle, log_len], dim=1))
        s_ang, s_len = torch.split(sums, n, dim=1)
        query_msg = torch.cat([torch.exp(s_len) * torch.cos(s_ang),
                               torch.exp(s_len) * torch.sin(s_ang)], dim=1)
        ands1, ands2 = variables[gr.and1], variables[gr.and2]
        ands_data = mlp(params["var2ands_mlp"],
                        torch.cat([ands1, ands2], dim=1), q)
        var_data = mlp(params["var2clause_mlp"], variables, q)
        node_data = torch.cat([params["zero_var"], var_data, ands_data])
        cmsg = to_clauses(node_data) * cdeg_w
        cdata = mlp(params["clause_mlp"],
                    torch.cat([clause_state, cmsg, query_msg], dim=1), q)
        clause_state = _pair_norm(cdata[:, Q:], gr.clause_graph,
                                  gr.n_clauses) * 0.25 + 0.1 * clause_state
        nodes_loss = to_nodes(cdata[:, :Q]) * deg_w
        ands_value = mlp(params["ands_mlp"],
                         torch.cat([ands1, ands2, nodes_loss[1 + V:]], dim=1),
                         q)
        vloss = nodes_loss[1:V + 1] + _seg(
            torch.cat([ands_value, ands_value]),
            torch.cat([gr.and1, gr.and2]), V)
        new_vars = mlp(params["update_gate"],
                       torch.cat([variables, vloss], dim=1), q)
        variables = _pair_norm(new_vars, gr.var_graph, gr.n_vars) * 0.25 \
            + 0.1 * variables
        logits = mlp(params["variables_output"], variables, q)
        ce = torch.relu(logits) - logits * smoothed + \
            torch.log1p(torch.exp(-torch.abs(logits)))
        loss_sum = loss_sum + torch.sum(ce) / max(V, 1)
        variables = variables.detach() * 0.2 + variables * 0.8
        clause_state = clause_state.detach() * 0.2 + clause_state * 0.8
    return loss_sum / rounds, logits


def train_draws(gen, device, V_pad: int, n_real: int, rounds: int):
    """One train step's draws: `rounds` noise draws [V_pad, 4]; the first
    `n_real` rows are the real variables."""
    return torch.stack([
        torch.randn((V_pad, 4), generator=gen, device=device)[:n_real]
        for _ in range(rounds)])


def train_steps(params, cfg: dict, steps, optimizer, precision="f32",
                keep_after: int | None = None):
    """`steps`: [(Graph, labels [V], round noise)]. Returns (losses, the
    first step's gradients as the optimizer gets them and as it takes them
    after its clip, the params after step `keep_after`, by default the
    last)."""
    leaves = dict(flatten(params))
    state = optimizer.init(leaves)
    losses, first, kept = [], None, None
    for i, (gr, labels, noise) in enumerate(steps):
        p = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        loss, _ = forward(unflatten(p), cfg, gr, labels, noise,
                          cfg["train_rounds"], precision)
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
    out: dict = {}
    for key, v in leaves.items():
        parts = key.split("/")
        if len(parts) == 1:
            out[key] = v
        else:
            out.setdefault(parts[0], {"w": [], "b": []})[parts[1]].append(v)
    return out
