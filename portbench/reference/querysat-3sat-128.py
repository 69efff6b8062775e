"""Plain reference of QuerySAT (DiffusionSAT's denoiser) for the benchmark.

Plain PyTorch in float32 on the flat edge-list layout, with `index_add_`
segment sums and no kernel, graph or batching of the program. It follows
the algorithm of `diffusionsat_torch/models/query_sat.py` and
`query_sat_dense.py` at commit ca3446b (recurrent query loop, closed-form
query gradient, 8 logit heads sorted by cost, diffusion conditioning,
masked early exit, the 0.2 / 0.8 state blend), the Bernoulli-KL loss of
`diffusion/schedule.py` and AdaBelief of `train/adabelief.py` (in
`_adabelief.py` beside this file). It builds its graph from the formulas
themselves and imports nothing of the program or of JAX.

`precision` names how the operands of every product are rounded before
it (MLP layers, and the literal-clause sums, which the program runs as
products): "f32" (none: the reference), "tf32", "bf16" or "fp8" (e4m3).
The benchmark's controls run the reference one step below the precision
a configuration states. TF32 stays off in the library products here.

Random draws: the program draws from one device generator in a fixed
order. `train_draws` and `predict_draws` replay that order on a generator
seeded alike, at the shapes the program draws at, and return the rows of
the real variables; the reference takes them as inputs.
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

_spec = importlib.util.spec_from_file_location(
    "portbench_reference__adabelief",
    Path(__file__).with_name("_adabelief.py"))
_adabelief = sys.modules.setdefault(_spec.name,
                                    importlib.util.module_from_spec(_spec))
_spec.loader.exec_module(_adabelief)
AdaBelief = _adabelief.AdaBelief

T_POWER = 0.5


def rounder(precision: str):
    """The operand rounding of a product at `precision`, with a
    straight-through gradient (the backward stays f32)."""
    if precision == "f32":
        return lambda x: x
    if precision == "bf16":
        return lambda x: x + (x.detach().to(torch.bfloat16).float() -
                              x.detach())
    if precision == "fp8":
        def q(x):
            d = x.detach().clamp(-448.0, 448.0)
            return x + (d.to(torch.float8_e4m3fn).float() - x.detach())
        return q
    if precision == "tf32":
        def q(x):
            bits = x.detach().contiguous().view(torch.int32)
            r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
            return x + (r - x.detach())
        return q
    raise ValueError(f"unknown precision {precision!r}")


# --- the model's shapes -------------------------------------------------


def mlp_dims(cfg: dict) -> dict[str, list[int]]:
    """Layer widths [in, hidden..., out] of every MLP, by name."""
    f, q, k = cfg["feature_maps"], cfg["query_maps"], cfg["logit_maps"]
    v1 = f + 4 + 5
    up = int(f * cfg["update_scale"])
    out = int(f * cfg["output_scale"])
    qh = int(q * cfg["query_scale"])
    ch = int(f * cfg["clauses_scale"])
    return {
        "update_gate": [q + v1 + 2 * q] + [up] * (cfg["update_layers"] - 1)
        + [f],
        "variables_output": [f] + [out] * (cfg["output_layers"] - 1) + [k],
        "variables_query": [v1] + [qh] * (cfg["query_layers"] - 1) + [q],
        "clause_mlp": [f + 2 * q] + [ch] * (cfg["clauses_layers"] - 1)
        + [f + q],
        "lit_mlp": [v1] + [4 * q] * (cfg["msg_layers"] - 1) + [2 * q],
    }


def init_params(cfg: dict, seed: int, device) -> dict:
    """Glorot-uniform kernels ([in, out]) and zero biases, from `seed`, in
    one draw on `device`: {name: {"w": [...], "b": [...]}}."""
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
    return params


# --- the graph, built from the formulas ---------------------------------


@dataclasses.dataclass
class Graph:
    """Formulas packed into one index space: variables of formula g at
    [off_g, off_g + n_g), literal v (positive) or V + v (negative)."""
    V: int
    C: int
    G: int
    lit: torch.Tensor            # [E] literal of each edge
    clause: torch.Tensor         # [E] clause of each edge
    var_graph: torch.Tensor      # [V]
    clause_graph: torch.Tensor   # [C]
    n_vars: torch.Tensor         # [G] f32
    n_clauses: torch.Tensor      # [G] f32
    var_slot: np.ndarray         # [V] position of the variable in its formula


def build_graph(formulas, device) -> Graph:
    """`formulas`: [(n_vars, clauses)], clauses as signed 1-based ints."""
    V = sum(n for n, _ in formulas)
    lit, clause, vg, cg, slot = [], [], [], [], []
    v_off = c_off = 0
    for g, (n, clauses) in enumerate(formulas):
        cl = np.asarray(clauses, dtype=np.int64).reshape(len(clauses), -1)
        var = np.abs(cl) - 1 + v_off
        lit.append(np.where(cl > 0, var, V + var).ravel())
        clause.append(np.repeat(np.arange(c_off, c_off + len(cl)),
                                cl.shape[1]))
        vg.append(np.full(n, g))
        cg.append(np.full(len(cl), g))
        slot.append(np.arange(n))
        v_off += n
        c_off += len(cl)
    t = lambda a, dt=torch.int64: torch.as_tensor(  # noqa: E731
        np.concatenate(a), dtype=dt, device=device)
    G = len(formulas)
    return Graph(
        V=V, C=c_off, G=G, lit=t(lit), clause=t(clause), var_graph=t(vg),
        clause_graph=t(cg),
        n_vars=torch.tensor([float(n) for n, _ in formulas], device=device),
        n_clauses=torch.tensor([float(len(c)) for _, c in formulas],
                               device=device),
        var_slot=np.concatenate(slot))


def _seg(x, index, n):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add_(0, index, x)


def l2c(gr: Graph, x):
    """[2V, F] literal rows summed into their clauses: [C, F]."""
    return _seg(x[gr.lit], gr.clause, gr.C)


def c2l(gr: Graph, y):
    """[C, F] clause rows summed into their literals: [2V, F]."""
    return _seg(y[gr.clause], gr.lit, 2 * gr.V)


def _pair_norm(x, seg, counts, eps=1e-6):
    mean = (_seg(x, seg, counts.shape[0]) / counts.clamp(min=1.0)[:, None])
    x = x - mean[seg]
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)


def mlp(p, x, q):
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = q(x) @ q(w) + b
        if i < n - 1:
            x = F.leaky_relu(x, 0.2)
    return x


def _dist_at(x, t):
    return x * (1 - t) + t / 2


def _bern_kl(p, q, eps=1e-20):
    p = p.clamp(eps, 1 - eps)
    q = q.clamp(eps, 1 - eps)
    return p * (torch.log(p) - torch.log(q)) + \
        (1 - p) * (torch.log1p(-p) - torch.log1p(-q))


def kl_loss(labels, logits, t, smoothing=0.01):
    t = torch.pow(t, T_POWER)
    t_lab = torch.clamp(t + smoothing, max=1.0)
    loss = _bern_kl(_dist_at(labels, t_lab),
                    _dist_at(torch.sigmoid(logits), t))
    norm = _bern_kl(_dist_at(torch.zeros_like(t), t_lab),
                    _dist_at(torch.zeros_like(t), 1.0))
    return loss / (norm + 1e-4)


def noisy_input(labels, noise_scale, uniform):
    """Labels corrupted to `noise_scale` by randomized rounding with the
    given uniforms, the noise level column and two zero columns: [V, 5]."""
    onehot = F.one_hot(labels.long(), 2).float()
    x0 = _dist_at(onehot, torch.pow(noise_scale, T_POWER))[:, 0:1]
    r = torch.floor(x0 + uniform)
    t_col = torch.zeros_like(r) + noise_scale
    return torch.cat([r, 1 - r, t_col, torch.zeros_like(r),
                      torch.zeros_like(r)], dim=1)


def forward(params, cfg: dict, gr: Graph, labels, noise_scale, uniform,
            round_noise, rounds: int, training: bool, precision="f32"):
    """The recurrent loop. Returns (loss, out_logits [V, 1], logits of every
    head [V, K], rounds taken)."""
    q = rounder(precision)
    V, Q, K = gr.V, cfg["query_maps"], cfg["logit_maps"]
    dev = gr.lit.device
    ones_e = torch.ones_like(gr.lit, dtype=torch.float32)[:, None]
    lit_deg = _seg(ones_e, gr.lit, 2 * V)
    deg_w = torch.rsqrt(lit_deg.clamp(min=1.0))
    var_deg_w = 4.0 * torch.rsqrt((lit_deg[:V] + lit_deg[V:]).clamp(min=1.0))
    rev_deg_w = torch.rsqrt(_seg(ones_e, gr.clause, gr.C).clamp(min=1.0))
    inputs = noisy_input(labels, noise_scale, uniform)
    smooth = labels.float()[:, None].expand(V, K)
    costs = torch.arange(1, K + 1, dtype=torch.float32, device=dev) ** 2

    def l2c_q(x):
        return l2c(gr, q(x))

    def c2l_q(y):
        return c2l(gr, q(y))

    variables = torch.ones((V, cfg["feature_maps"]), device=dev)
    clause_state = torch.ones((gr.C, cfg["feature_maps"]), device=dev)
    last_logits = torch.zeros((V, K), device=dev)
    best = torch.zeros(V, dtype=torch.int64, device=dev)
    loss_sum = torch.zeros((), device=dev)
    count = 0
    done = False
    for r in range(rounds):
        if done:
            break
        v1 = torch.cat([variables, round_noise[r], inputs], dim=1)
        query = mlp(params["variables_query"], v1, q)
        lits = torch.cat([query, -query], dim=0)
        cv = torch.exp(-l2c_q(F.softplus(lits)))
        per_lit = -c2l_q(cv) * torch.sigmoid(lits)
        vgrad = (per_lit[:V] - per_lit[V:]) * var_deg_w
        msg = mlp(params["lit_mlp"], v1, q)
        lit_rows = torch.cat(torch.split(msg, Q, dim=1), dim=0)
        cmsg = l2c_q(lit_rows) * rev_deg_w
        cdata = mlp(params["clause_mlp"],
                    torch.cat([clause_state, cmsg, cv * 4.0], dim=1), q)
        new_clause = _pair_norm(cdata[:, Q:], gr.clause_graph,
                                gr.n_clauses) * 0.25 + 0.1 * clause_state
        vloss = c2l_q(cdata[:, :Q]) * deg_w
        unit = torch.cat([vgrad, v1, vloss[:V], vloss[V:]], dim=1)
        new_vars = _pair_norm(mlp(params["update_gate"], unit, q),
                              gr.var_graph, gr.n_vars) * 0.25 + \
            0.1 * variables
        logits = mlp(params["variables_output"], new_vars, q)
        per_var = kl_loss(smooth, logits, noise_scale)
        per_graph = _seg(per_var, gr.var_graph, gr.G) / \
            gr.n_vars.clamp(min=1.0)[:, None]
        ordered = torch.sort(per_graph, dim=1, descending=True).values
        loss_sum = loss_sum + torch.sum(ordered * costs) / torch.sum(costs)
        count += 1
        head = torch.argmin(per_graph, dim=1)[gr.var_graph]
        out = torch.gather(logits, 1, head[:, None])
        # the batch is solved when the rounded assignment satisfies every
        # clause; its state then freezes and later rounds are no-ops
        val = torch.round(torch.sigmoid(out.detach()))
        sat = l2c(gr, torch.cat([val, 1 - val], dim=0)).clamp(0, 1)
        solved = bool(torch.min(sat) >= 1.0)
        last_logits, best = logits, head
        if solved:
            variables, clause_state = new_vars, new_clause
            done = True
        else:
            variables = new_vars.detach() * 0.2 + new_vars * 0.8
            clause_state = new_clause.detach() * 0.2 + new_clause * 0.8
    loss = loss_sum / max(count, 1)
    out = torch.gather(last_logits, 1, best[:, None])
    return loss, out, last_logits, count


# --- the program's draws, replayed --------------------------------------


def train_draws(gen, device, shape, var_index, rounds):
    """One dense train step's draws: the noise level, the rounding
    uniforms [G, Vg, 1] and `rounds` noise draws [G, Vg, 4]; `var_index`
    (graph, slot) picks the real variables' rows."""
    G, Vg = shape
    gi, si = var_index
    noise_scale = torch.rand((), generator=gen, device=device)
    u = torch.rand((G, Vg, 1), generator=gen, device=device)[gi, si]
    noise = torch.stack([
        torch.randn((G, Vg, 4), generator=gen, device=device)[gi, si]
        for _ in range(rounds)])
    return noise_scale, u, noise


def predict_draws(gen, device, V_pad, n_real, rounds):
    """One flat predict call's draws at a fixed noise level: labels [V],
    rounding uniforms [V, 1] and `rounds` noise draws [V, 4], at the padded
    size; the first `n_real` rows are the real variables."""
    labels = torch.randint(0, 2, (V_pad,), generator=gen, device=device,
                           dtype=torch.int32)[:n_real]
    u = torch.rand((V_pad, 1), generator=gen, device=device)[:n_real]
    noise = torch.stack([
        torch.randn((V_pad, 4), generator=gen, device=device)[:n_real]
        for _ in range(rounds)])
    return labels, u, noise


# --- training steps -------------------------------------------------------


def train_steps(params, cfg: dict, steps, optimizer: AdaBelief,
                precision="f32", keep_after: int | None = None):
    """Run train steps from `params`. `steps`: [(Graph, labels [V],
    (noise_scale, uniforms, round noise))]. Returns (losses, the first
    step's gradients as the optimizer gets them and as it takes them after
    its clip, the params after step `keep_after`, by default the last)."""
    leaves = {k: v for k, v in _flatten(params)}
    state = optimizer.init(leaves)
    losses, first, kept = [], None, None
    for i, (gr, labels, (ns, u, noise)) in enumerate(steps):
        p = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        loss, _, _, _ = forward(_unflatten(p), cfg, gr, labels, ns, u, noise,
                                cfg["train_rounds"], True, precision)
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


def _flatten(params, prefix=""):
    if isinstance(params, torch.Tensor):
        yield prefix, params
    elif isinstance(params, dict):
        for k, v in params.items():
            yield from _flatten(v, f"{prefix}/{k}" if prefix else k)
    else:
        for i, v in enumerate(params):
            yield from _flatten(v, f"{prefix}/{i}")


def _unflatten(leaves: dict) -> dict:
    out: dict = {}
    for key, v in leaves.items():
        name, kind, i = key.split("/")
        out.setdefault(name, {"w": [], "b": []})[kind].append(v)
    return out


flatten = _flatten
