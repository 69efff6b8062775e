"""What the ranks of the port's multi-device tests run.

The ranks are spawned processes (`diffusionsat_torch.parallel.mesh.launch`)
that import torch, numpy and the port only: the test modules, which import
JAX, hand them host inputs (numpy arrays, the port's host batches) and
compare what they return (numpy) with the JAX package's values. Every
function here takes the `RankContext` first and a dict of inputs.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.parallel import dp, graph_partition, halo
from diffusionsat_torch.parallel.comm import transport
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.checkpoint import params_from_numpy
from diffusionsat_torch.train.loop import TrainState, _select_labels

# the TPU package's tests/test_halo.py bucket and batches
BUCKET = dict(max_vars=64, max_clauses=128, max_edges=512, max_graphs=8)


def random_formulas(seed, n_graphs=6):
    """tests/test_halo.py's `random_batch` formulas and solutions."""
    rng = np.random.default_rng(seed)
    formulas = []
    for _ in range(n_graphs):
        n = int(rng.integers(4, 10))
        clauses = [[int(v) if rng.random() < 0.5 else -int(v)
                    for v in (rng.choice(n, size=3, replace=False) + 1)]
                   for _ in range(3 * n)]
        formulas.append((n, clauses))
    sols = [[int(b) for b in rng.integers(0, 2, size=n)]
            for n, _ in formulas]
    return formulas, sols


def random_batch(seed, n_graphs=6, **bucket):
    formulas, sols = random_formulas(seed, n_graphs)
    return build_batch(formulas, BucketSpec(**dict(BUCKET, **bucket)),
                       solutions=sols)


class CaptureGrads:
    """An optimizer that keeps the gradients it is handed as its state and
    leaves the params as they are: a step's gradients, read back."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return params, grads


def leaves_np(tree) -> list[np.ndarray]:
    return [t.detach().cpu().numpy() for t in pytree.tree_leaves(tree)]


def params_hash(params) -> str:
    h = hashlib.sha1()
    for a in leaves_np(params):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _state(params, optimizer, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0, generator=g)


def _draws(d: dict | None, device) -> dict:
    if not d:
        return {}
    return {k: torch.as_tensor(v).to(device) if not isinstance(v, float)
            else v for k, v in d.items()}


def dp_case(ctx, inp: dict) -> dict:
    """One DP step of every rank on its own batch (and draws), gradients
    captured, then `steps` AdaBelief steps from the same params: the
    averaged loss and gradients, and the params' hash on each rank."""
    from diffusionsat_torch.models.anf_sat import anf_sat_apply
    from diffusionsat_torch.models.query_sat import query_sat_apply
    from diffusionsat_torch.models.query_sat_dense import (
        query_sat_dense_apply,
    )

    apply_fn = {"flat": query_sat_apply, "dense": query_sat_dense_apply,
                "anf": anf_sat_apply}[inp["apply"]]
    mesh = ctx.mesh(n_data=ctx.world)
    dev = mesh.device
    params = params_from_numpy(inp["params"], dev)
    batch = inp["batches"][mesh.data_index]
    draws = _draws(inp["draws"][mesh.data_index], dev)
    step = dp.make_dp_train_step(inp["cfg"], CaptureGrads(), mesh, apply_fn)
    state = _state(params, CaptureGrads(), inp["seed"], dev)
    out_state, out = step(state, batch, **draws)
    labels = None
    if getattr(batch, "solutions_k", None) is not None:
        gen = dp.rank_generator(inp["seed"], mesh.data_index, 0, dev)
        labels = _select_labels(batch.to(dev), gen).cpu().numpy()
    opt = adabelief(learning_rate=1e-3)
    adam_step = dp.make_dp_train_step(inp["cfg"], opt, mesh, apply_fn)
    st = _state(params, opt, inp["seed"], dev)
    losses = []
    for _ in range(inp.get("steps", 2)):
        st, o = adam_step(st, batch, **draws)
        losses.append(float(o["loss"]))
    return dict(loss=float(out["loss"]), gradnorm=float(out["gradnorm"]),
                steps=float(out["steps_taken"]),
                grads=leaves_np(out_state.opt_state), labels=labels,
                losses=losses, hash=params_hash(st.params),
                transport=transport(mesh.data_group, dev))


def gp_case(ctx, inp: dict) -> dict:
    """One clause-sharded step (all-reduce, or the halo exchange with
    `inp["halo"]`) over a graph group of the whole world, gradients
    captured; then one AdaBelief step, its params returned."""
    mesh = ctx.mesh(n_data=1, n_graph=ctx.world)
    dev = mesh.device
    n = ctx.world
    batch = inp["batch"]
    local = graph_partition.local_batch(
        graph_partition.build_local_batches(batch, n), mesh.graph_index)
    params = params_from_numpy(inp["params"], dev)
    draws = _draws(inp.get("draws"), dev)

    def make(opt):
        if inp["halo"]:
            return halo.make_halo_gp_train_step(
                inp["cfg"], opt, mesh, halo.build_halo_plan(batch, n))
        return graph_partition.make_gp_train_step(inp["cfg"], opt, mesh)

    st, out = make(CaptureGrads())(
        _state(params, CaptureGrads(), 0, dev), local, **draws)
    res = dict(loss=float(out["loss"]), grads=leaves_np(st.opt_state))
    if inp.get("adabelief"):
        opt = adabelief(learning_rate=1e-3)
        st2, out2 = make(opt)(_state(params, opt, 0, dev), local, **draws)
        res.update(adabelief_params=leaves_np(st2.params),
                   adabelief_loss=float(out2["loss"]))
    return res


def sharded_spmm_case(ctx, inp: dict) -> dict:
    """`make_sharded_spmm` on this rank's block of the sharded edges."""
    mesh = ctx.mesh(n_data=1, n_graph=ctx.world)
    n, batch = ctx.world, inp["batch"]
    sb = graph_partition.shard_batch_by_clause(batch, n)
    e_per = sb.E // n
    blk = slice(mesh.graph_index * e_per, (mesh.graph_index + 1) * e_per)
    edges = (sb.edge_lit_c[blk], sb.edge_clause_c[blk], sb.edge_mask_c[blk])
    l2c, c2l = graph_partition.make_sharded_spmm(mesh, batch.V, batch.C, n)
    c_per = batch.C // n
    cf = torch.from_numpy(inp["clause_feats"])[
        mesh.graph_index * c_per:(mesh.graph_index + 1) * c_per]
    return dict(
        clauses=l2c(torch.from_numpy(inp["lit_feats"]), *edges).numpy(),
        literals=c2l(cf, *edges).numpy())


def halo_exchange_case(ctx, inp: dict) -> dict:
    """`halo_exchange` of this rank's partial aggregate."""
    mesh = ctx.mesh(n_data=1, n_graph=ctx.world)
    plan = halo.build_halo_plan(inp["batch"], ctx.world)
    view = plan.view(mesh.graph_index).to(mesh.device)
    partial = torch.from_numpy(inp["partials"][mesh.graph_index])
    return dict(out=halo.halo_exchange(partial.to(mesh.device), view,
                                       mesh.graph_group).cpu().numpy())


def chain_case(ctx, inp: dict) -> dict:
    """The sharded sampler chain: each rank's batch and generator, the
    bits and solved flags gathered to rank 0."""
    from diffusionsat_torch.diffusion.sampler import make_diffusion_chain

    mesh = ctx.mesh(n_data=ctx.world)
    dev = mesh.device
    params = params_from_numpy(inp["params"], dev)
    chain = make_diffusion_chain(inp["cfg"], **inp["chain_kw"])
    g = torch.Generator(device=dev)
    g.manual_seed(inp["seeds"][mesh.data_index])
    out = dp.dp_chain(chain, params, inp["batches"][mesh.data_index].to(dev),
                      g, mesh)
    if out is None:
        return None
    return dict(bits=out[0].cpu().numpy(), solved=out[1].cpu().numpy())


def run_cases(ctx, cases: list) -> list:
    """Each (name, inputs) case in turn, on every rank; rank results."""
    fns = dict(dp=dp_case, gp=gp_case, sharded_spmm=sharded_spmm_case,
               halo_exchange=halo_exchange_case, chain=chain_case)
    return [fns[name](ctx, inp) for name, inp in cases]


def strip(batch):
    """A host batch with every tensor contiguous and owning its memory
    (what a spawned rank unpickles)."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).clone()
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})


def fail_on_rank(ctx, bad: int):
    """Raises on rank `bad` (the launcher must report it)."""
    if ctx.rank == bad:
        raise ValueError("a planned failure")
    return ctx.rank


def collectives_case(ctx, inp: dict) -> dict:
    """Every collective of `parallel/comm.py` on this rank's device, values
    and gradients, and one halo exchange and one DP step through the
    segsum kernel; returns what the caller checks."""
    from diffusionsat_torch.ops import segsum
    from diffusionsat_torch.parallel import comm

    mesh = ctx.mesh(n_data=ctx.world)
    dev, n, r = mesh.device, ctx.world, ctx.rank
    g = mesh.data_group
    out: dict = {"transport": comm.transport(g, dev)}
    x = torch.full((3, 2), float(r + 1), device=dev, requires_grad=True)
    y = comm.all_reduce_sum(x, g)
    (y * (r + 1)).sum().backward()
    out["all_reduce"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = (torch.arange(n, device=dev, dtype=torch.float32)[:, None] +
         10 * r).repeat(1, 2).requires_grad_(True)
    y = comm.all_to_all(x, g)
    (y * torch.arange(1, n + 1, device=dev)[:, None]).sum().backward()
    out["all_to_all"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    out["min"] = float(comm.all_reduce_min(
        torch.tensor(float(r), device=dev), g))
    gathered = comm.gather_to_root(torch.full((2,), float(r), device=dev), g)
    out["gather"] = None if gathered is None else \
        [t.cpu().numpy() for t in gathered]
    out["bucket"] = [t.cpu().numpy() for t in comm.sum_bucket(
        [torch.ones(2, device=dev) * r, torch.ones((1, 3), device=dev)], g,
        scale=0.5)]

    gp = ctx.mesh(n_data=1, n_graph=n)
    batch = inp["batch"]
    plan = halo.build_halo_plan(batch, n)
    view = plan.view(gp.graph_index).to(dev)
    partial = torch.from_numpy(inp["partials"][gp.graph_index]).to(dev)
    segsum.reset_launch_counts()
    out["halo"] = halo.halo_exchange(partial, view,
                                     gp.graph_group).cpu().numpy()
    out["halo_launches"] = dict(segsum.LAUNCHES)

    cfg = inp["cfg"]
    params = params_from_numpy(inp["params"], dev)
    opt = adabelief(learning_rate=1e-3)
    step = dp.make_dp_train_step(cfg, opt, mesh)
    segsum.reset_launch_counts()
    st, o = step(_state(params, opt, 3, dev), inp["dp_batches"][r])
    out["dp"] = dict(loss=float(o["loss"]), launches=dict(segsum.LAUNCHES),
                     hash=params_hash(st.params))
    return out


class PinnedHeads:
    """`query_sat._head_weighted_loss` with the head order of a reference
    run (`record`, then `replay`), so that a near-tie of two heads cannot
    swap their rank weights between two summation orders."""

    def __init__(self):
        self.orders, self.at = [], None

    def __call__(self, per_graph_loss, logit_maps):
        costs = torch.square(torch.arange(1, logit_maps + 1,
                                          dtype=torch.float32))
        if self.at is None:
            order = torch.argsort(per_graph_loss, dim=-1, descending=True)
            self.orders.append(order)
        else:
            order = self.orders[self.at]
            self.at += 1
        ranked = torch.gather(per_graph_loss, -1, order)
        return torch.sum(ranked * costs) / torch.sum(costs)


def balance_case(ctx, inp: dict) -> dict:
    """The clause-sharded steps (all-reduce and halo) against this rank's
    own single-device step with the same generator draws and the head
    order pinned: the largest gradient error of each, as a share of its
    tensor's largest entry (floored at a hundredth of the largest of
    all)."""
    from diffusionsat_torch.models import query_sat as qs
    from diffusionsat_torch.ops.segsum import build_batch_plans
    from diffusionsat_torch.train.loop import _grad_leaves, _grads_of

    mesh = ctx.mesh(n_data=1, n_graph=ctx.world)
    dev, n, cfg = mesh.device, ctx.world, inp["cfg"]
    params = params_from_numpy(inp["params"], dev)
    whole = inp["batch"]
    local, plans = graph_partition.place_local_batch(
        graph_partition.build_local_batches(whole, n), mesh)
    pinned = PinnedHeads()
    sorted_loss = qs._head_weighted_loss
    qs._head_weighted_loss = pinned
    try:
        tree, leaves, spec = _grad_leaves(params)
        loss = qs.query_sat_apply(
            tree, cfg, whole.to(dev), _state(params, CaptureGrads(), 5,
                                             dev).generator,
            training=True, labels=whole.solutions.to(dev),
            plans=build_batch_plans(whole).to(dev), device=dev)[1]
        ref = _grads_of(loss, leaves, spec)[1]
        top = max(g.abs().max().item() for g in ref)
        out = {}
        for mode in ("all_reduce", "halo"):
            view = halo.build_halo_plan(whole, n).view(mesh.graph_index) \
                if mode == "halo" else None
            step = graph_partition.make_gp_train_step(cfg, CaptureGrads(),
                                                      mesh, halo=view)
            pinned.at = 0
            st, o = step(_state(params, CaptureGrads(), 5, dev), local,
                         plans)
            out[mode] = max(
                (a - b).abs().max().item() / max(b.abs().max().item(),
                                                 top / 100)
                for a, b in zip(pytree.tree_leaves(st.opt_state), ref))
    finally:
        qs._head_weighted_loss = sorted_loss
    return out
