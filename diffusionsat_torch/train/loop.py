"""Training loop: train and predict steps, metric evaluation, the loop.

Counterpart of the TPU package's `train/loop.py`: functions over an
explicit `TrainState`, run as eager PyTorch. The state's random key is a
`torch.Generator` on the device, which every step advances in place. A
step's loss, round count and gradient norm stay on the device; `train`
fetches the losses once per log window.

Many steps per dispatch (`make_scanned_train_step_for` over a chunk that
`stack_batches` stacked, or that `chunk_batches` grouped from planned flat
batches): on the card the N steps of a chunk are one captured CUDA graph,
one per chunk shape, replayed once a chunk (see `cuda_graphs.py`); on the
CPU, or with `DSAT_EAGER=1`, the same function runs the eager step N
times.

A flat batch runs with its kernel plans in every step here (train, self-
supervised, diagnostics, predict): `BatchPlans` for a CNF `SatBatch`,
`ANFPlans` for an `ANFBatch`, so on the card its flat aggregations go
through the segsum kernel, forward and backward. Plans are host-built:
pass a batch together with its plans (`plan_batches`) to build them once,
before the timed or repeated work; a bare flat batch gets its plans built
inside the step, once per call. A step made with `plan_kw="tiles"` takes a
`TiledIncidence` instead (the tiled layout).

While torch's profiler records, an evaluated batch records `eval.batch`
and `predict.step` spans around the CUDA-graph layer's own, and a train
chunk that layer's spans alone (`tracing.py`).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import itertools
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, Sequence

import torch
from torch.utils import _pytree as pytree

from diffusionsat_torch import cuda_graphs, tracing
from diffusionsat_torch.diffusion.schedule import construct_training_input

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.anf_batch import ANFBatch
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.graph.dense_batch import DenseSatBatch
from diffusionsat_torch.losses.sat import is_graph_sat
from diffusionsat_torch.models.query_sat import query_sat_apply
from diffusionsat_torch.ops import dense_ops
from diffusionsat_torch.ops.graph_ops import graph_gather_vars
from diffusionsat_torch.ops.segsum import (
    ANFPlans,
    BatchPlans,
    build_anf_plans,
    build_batch_plans,
)
from diffusionsat_torch.train.metrics import Metric

Batch = SatBatch | DenseSatBatch | ANFBatch
PlannedBatch = tuple[Batch, BatchPlans | ANFPlans | None]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int                            # optimizer steps taken
    generator: torch.Generator | None    # on the device; advanced in place

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def _takes(apply_fn: Callable, name: str) -> bool:
    try:
        return name in inspect.signature(apply_fn).parameters
    except (TypeError, ValueError):
        return False


def _takes_plans(apply_fn: Callable) -> bool:
    return _takes(apply_fn, "plans")


def uses_edge_plans(apply_fn: Callable) -> bool:
    """Whether `apply_fn` sums per-edge rows on the edge plans (graph
    attention), so that its flat batches' plans must carry them."""
    return getattr(apply_fn, "uses_edge_plans", False)


def _accepts_labels(apply_fn: Callable) -> bool:
    return _takes(apply_fn, "labels")


def draw_label_rows(batch: Batch, generator: torch.Generator | None,
                    isolation_alpha: float = 0.0) -> torch.Tensor:
    """The bank row each graph trains on this step: [G] for a dense batch,
    [G + 1] for a flat one (the extra entry serves the padding segment G
    that `var_graph` points padded variables at).

    Uniform over the K rows, or, with `isolation_alpha` != 0 and
    `label_isolation_k` attached, a per-graph softmax draw with logits
    alpha * isolation (Gumbel-max): positive alpha over-samples isolated
    solutions.
    """
    sk = batch.solutions_k
    K, dev = sk.shape[0], sk.device
    G = batch.graph_mask.shape[0]
    flat = sk.dim() == 2
    iso = getattr(batch, "label_isolation_k", None)
    if isolation_alpha != 0.0 and iso is not None:
        u = torch.rand((K, G), generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-38)))
        kg = torch.argmax(isolation_alpha * iso + gumbel, dim=0)
        if flat:
            kg = torch.cat([kg, kg.new_zeros(1)])
        return kg
    return torch.randint(0, K, (G + 1 if flat else G,), generator=generator,
                         device=dev)


def pick_labels(batch: Batch, kg: torch.Tensor) -> torch.Tensor:
    """Labels of the drawn rows: [G, Vg] (dense) or [V] (flat)."""
    sk = batch.solutions_k
    if sk.dim() == 3:  # dense layout: [K, G, Vg]
        return sk[kg, torch.arange(sk.shape[1], device=sk.device), :]
    # flat layout: [K, V]; var_graph's padding id G indexes the extra entry
    return sk[kg[batch.var_graph.long()],
              torch.arange(sk.shape[1], device=sk.device)]


def _select_labels(batch: Batch, generator: torch.Generator | None,
                   isolation_alpha: float = 0.0) -> torch.Tensor:
    """Per-graph random label draw from the batch's multi-label bank
    (`solutions_k`: [K, V] flat, [K, G, Vg] dense). Without the bank this
    returns `batch.solutions` and draws nothing."""
    if batch.solutions_k is None:
        return batch.solutions
    return pick_labels(batch, draw_label_rows(batch, generator,
                                              isolation_alpha))


def build_plans(batch: Batch, pad: bool = False, edges: bool = False
                ) -> BatchPlans | ANFPlans | None:
    """The kernel plans of a flat batch, host-built: `BatchPlans` of a
    SatBatch (with the edge plans if `edges`), `ANFPlans` of an ANFBatch;
    None for a dense batch. With `pad`, padded to the batch's bucket, so
    that the plans of one bucket share their shapes."""
    if isinstance(batch, SatBatch):
        return build_batch_plans(batch, pad=pad, edges=edges)
    if isinstance(batch, ANFBatch):
        return build_anf_plans(batch, pad=pad)
    return None


def _flat_plans(batch: Batch, plans, dev: torch.device,
                edges: bool = False):
    """A flat batch's plans on `dev`, built here (with the edge plans if
    `edges`) when the caller passed none; None for a dense batch."""
    if isinstance(batch, DenseSatBatch):
        return None
    if plans is None:
        plans = build_plans(batch, edges=edges)
    return plans.to(dev)


def _grad_leaves(params):
    """The params tree with every leaf a fresh leaf that records gradients
    (sharing storage), and the flat list of those leaves."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    return pytree.tree_unflatten(leaves, spec), leaves, spec


def _grads_of(loss, leaves, spec):
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return pytree.tree_unflatten(grads, spec), grads


def _global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _make_step(apply_fn: Callable, cfg, optimizer, plan_kw: str | None,
               device: str | torch.device):
    dev = resolve_device(device)
    with_labels = _accepts_labels(apply_fn)
    iso_alpha = float(getattr(cfg, "label_isolation_alpha", 0.0))
    if plan_kw is None and _takes_plans(apply_fn):
        plan_kw = "plans"
    edges = uses_edge_plans(apply_fn)

    def train_step(state: TrainState, batch, plan=None):
        if plan_kw == "plans":
            plan = _flat_plans(batch, plan, dev, edges)
        batch = batch.to(dev)
        # the label draw happens only when the batch has a bank: a step on
        # a single-label batch must not burn random numbers for it
        multilabel = with_labels and \
            getattr(batch, "solutions_k", None) is not None
        labels = _select_labels(batch, state.generator, iso_alpha) \
            if multilabel else batch.solutions
        kw = {"labels": labels} if with_labels else {}
        if plan_kw is not None:
            kw[plan_kw] = plan
        params, leaves, spec = _grad_leaves(state.params)
        _, loss, steps, _ = apply_fn(params, cfg, batch, state.generator,
                                     training=True, device=dev, **kw)
        grads, grad_list = _grads_of(loss, leaves, spec)
        new_params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params)
        new_state = TrainState(params=new_params, opt_state=opt_state,
                               step=state.step + 1,
                               generator=state.generator)
        return new_state, {"loss": loss.detach(), "steps_taken": steps,
                           "gradnorm": _global_norm(grad_list)}

    return train_step


def make_train_step_for(apply_fn: Callable, cfg, optimizer,
                        device: str | torch.device = "cuda"
                        ) -> Callable[[TrainState, Batch],
                                      tuple[TrainState, dict]]:
    """Train step for any model with the standard apply contract
    (params, cfg, batch, generator, training[, labels][, plans]) ->
    (logits, loss, steps, aux). Supervised models get the batch's solution
    bits as labels, or a fresh per-graph draw from its bank; a model that
    takes `plans` gets a flat batch's, built in the call. Returns (new
    state, {"loss", "steps_taken", "gradnorm"}), all three device
    tensors."""
    return _make_step(apply_fn, cfg, optimizer, None, device)


def stack_batches(items: Sequence) -> Any:
    """Same-shape batches (or (batch, plans) pairs) stacked on a new
    leading axis, on the host: every tensor field gains the stack axis,
    optional fields must be set in all or in none, and every other field
    (a plan's name and source count) must be equal in all. Flat plans
    stack when they are padded to their bucket (`build_plans(batch,
    pad=True)`)."""
    return cuda_graphs.stack_trees(list(items))


def whole_chunks(items: Sequence, n: int) -> list:
    """`items` in their order as chunks of `n`, whole chunks only: the last
    `len(items) % n` are left out."""
    if len(items) < n:
        raise ValueError(f"{len(items)} batches make no chunk of {n} steps")
    return [items[i:i + n] for i in range(0, len(items) - n + 1, n)]


def chunk_batches(planned: Sequence[PlannedBatch], n: int,
                  device: str | torch.device = "cuda") -> list:
    """Batches paired with their padded plans (`plan_batches`), grouped
    into `whole_chunks` of `n` steps, each stacked (`stack_batches`) and
    moved to `device`: the chunks `make_scanned_train_step_for` takes."""
    dev = resolve_device(device)
    return [tuple(t.to(dev) for t in stack_batches(c))
            for c in whole_chunks(planned, n)]


def make_scanned_train_step_for(apply_fn: Callable, cfg, optimizer,
                                device: str | torch.device = "cuda"):
    """N training steps in one dispatch, over a chunk of N same-shape
    batches that `stack_batches` stacked: the counterpart of the TPU
    package's `lax.scan` of the train step.

    Returns mega_step(state, stacked, max_steps=None) -> (state, {"loss":
    the chunk's mean loss, "loss_per_step": [N], "steps_taken": the last
    step's}); `stacked` is a stacked batch, or a (stacked batch, stacked
    padded plans) pair for a model that takes plans. `state.step` advances
    by the steps taken: N, or `max_steps` when that is smaller (the chunk's
    first `max_steps` batches).

    On CUDA the chunk's steps run as one CUDA graph, captured once per
    chunk shape (after one warm-up step), with the chunk, the params and
    the optimizer state in the graph's buffers: each call copies the chunk
    in device to device and replays the graph. The returned state's tensors
    are those buffers, written in place by the next call (pass a state that
    holds them back, and nothing is copied). The graph draws from the
    state's generator exactly as N eager steps would, and leaves it
    advanced as far. A capture or replay that fails raises. On the CPU, or
    with `DSAT_EAGER=1`, the N eager steps run one after another: the plain
    version.
    """
    dev = resolve_device(device)
    step = _make_step(apply_fn, cfg, optimizer, None, dev)
    with_plans = _takes_plans(apply_fn)
    graphs: dict = {}

    def split(stacked):
        batch, plans = stacked if isinstance(stacked, tuple) else \
            (stacked, None)
        if with_plans and plans is None:
            raise ValueError("a flat chunk needs its stacked padded plans: "
                             "pass (stacked batch, stacked plans)")
        return batch, plans

    def run_eager(state, batch, plans, n):
        losses = []
        for i in range(n):
            state, out = step(state, cuda_graphs.index_tree(batch, i),
                              None if plans is None else
                              cuda_graphs.index_tree(plans, i))
            losses.append(out["loss"])
        return state, torch.stack(losses), out["steps_taken"]

    def graph_for(state, batch, plans, n):
        with tracing.span("graph.lookup"):
            sig = (cuda_graphs.tree_signature(
                (state.params, state.opt_state, batch, plans)),
                state.generator is None)
            if sig not in graphs:
                graphs[sig] = capture(state, batch, plans, n)
            return graphs[sig]

    def capture(state, batch, plans, n):
        losses = torch.zeros((n,), device=dev)
        steps_taken = torch.zeros((), dtype=torch.int32, device=dev)

        def chunk(static, gen):
            opt, sbatch, splans = static
            st = TrainState(params=opt[0], opt_state=opt[1], step=0,
                            generator=gen)
            st, per, last = run_eager(st, sbatch, splans, n)
            cuda_graphs.tree_copy_(opt, (st.params, st.opt_state))
            losses.copy_(per)
            steps_taken.copy_(last)

        def one_step(static, gen):
            # the warm-up before the capture: one step of the chunk
            opt, sbatch, splans = static
            run_eager(TrainState(params=opt[0], opt_state=opt[1], step=0,
                                 generator=gen), sbatch, splans, 1)

        static = cuda_graphs.tree_map(
            torch.clone, ((state.params, state.opt_state), batch, plans))
        graph = cuda_graphs.CapturedGraph(
            chunk, static, dev, with_generator=state.generator is not None,
            warmup=one_step)
        return graph, losses, steps_taken

    def mega_step(state: TrainState, stacked, max_steps: int | None = None):
        batch, plans = split(stacked)
        n = cuda_graphs.stack_length(batch)
        if max_steps is not None and max_steps < n:
            if max_steps < 1:
                raise ValueError(f"max_steps {max_steps} < 1")
            n = max_steps
            batch, plans = cuda_graphs.tree_map(lambda t: t[:n],
                                                (batch, plans))
        if not cuda_graphs.graphs_enabled(dev):
            batch, plans = cuda_graphs.tree_map(lambda t: t.to(dev),
                                                (batch, plans))
            state, per, last = run_eager(state, batch, plans, n)
            return state, {"loss": per.mean(), "loss_per_step": per,
                           "steps_taken": last}
        graph, losses, steps_taken = graph_for(state, batch, plans, n)
        opt, sbatch, splans = graph.static
        with tracing.span("graph.copy_in"):
            cuda_graphs.tree_copy_(opt, (state.params, state.opt_state))
            cuda_graphs.tree_copy_((sbatch, splans), (batch, plans))
        with tracing.span("graph.replay") as sp, \
                graph.drawing_from(state.generator):
            graph.replay()
            if sp:
                sp.set(**graph.replay_attrs(1))
        with tracing.span("graph.copy_out"):
            new_state = TrainState(params=opt[0], opt_state=opt[1],
                                   step=state.step + n,
                                   generator=state.generator)
            return new_state, {"loss": losses.mean(),
                               "loss_per_step": losses.clone(),
                               "steps_taken": steps_taken.clone()}

    return mega_step


def make_train_step(cfg, optimizer, device: str | torch.device = "cuda"):
    """Supervised-diffusion train step on flat QuerySAT over (state,
    batch): the batch's plans are built inside every call, so prefer
    `make_planned_train_step` for repeated batches."""
    return make_train_step_for(query_sat_apply, cfg, optimizer, device)


def make_planned_train_step_for(apply_fn: Callable, cfg, optimizer,
                                plan_kw: str = "plans",
                                device: str | torch.device = "cuda"):
    """Train step over (state, batch, plan): like `make_train_step_for`,
    threading a per-batch execution plan into the apply under `plan_kw`."""
    return _make_step(apply_fn, cfg, optimizer, plan_kw, device)


def make_planned_train_step(cfg, optimizer,
                            device: str | torch.device = "cuda"):
    """Flat QuerySAT train step over (state, batch, plans): the
    literal-clause aggregations run on the segsum kernel, forward and
    backward (ops/segsum.BatchPlans)."""
    return make_planned_train_step_for(query_sat_apply, cfg, optimizer,
                                       device=device)


def make_diagnostics_step(cfg, apply_fn: Callable = query_sat_apply,
                          device: str | torch.device = "cuda"):
    """Diagnostics forward and backward: one extra training-mode pass with
    per-round in-model statistics (`aux["round_stats"]`) and a
    parameter-gradient norm per MLP, kept out of the train step so it costs
    nothing except when called. Returns run(params, batch, generator,
    plans=None) -> a flat dict of python numbers and lists, read back from
    the device in one fetch."""
    dev = resolve_device(device)
    diag_cfg = dataclasses.replace(cfg, collect_round_stats=True)
    with_labels = _accepts_labels(apply_fn)
    with_plans = _takes_plans(apply_fn)
    edges = uses_edge_plans(apply_fn)

    def run(params, batch, generator, plans=None) -> dict:
        if with_plans:
            plans = _flat_plans(batch, plans, dev, edges)
        batch = batch.to(dev)
        kw = {"labels": batch.solutions} if with_labels else {}
        if with_plans:
            kw["plans"] = plans
        tree, leaves, spec = _grad_leaves(params)
        _, loss, steps, aux = apply_fn(tree, diag_cfg, batch, generator,
                                       training=True, device=dev, **kw)
        grads, _ = _grads_of(loss, leaves, spec)
        stats = aux["round_stats"]
        norms = {k: _global_norm(pytree.tree_leaves(v))
                 for k, v in grads.items()}
        rounds = next(iter(stats.values())).shape[0]
        # one host fetch for the whole record
        packed = torch.cat(
            [loss.detach().reshape(1), steps.to(torch.float32).reshape(1)] +
            [v.detach().to(torch.float32) for v in stats.values()] +
            [v.reshape(1) for v in norms.values()]).cpu().tolist()
        out = {"diag_loss": packed[0], "diag_steps": int(packed[1])}
        pos = 2
        for k in stats:
            out[f"round/{k}"] = [round(x, 5)
                                 for x in packed[pos:pos + rounds]]
            pos += rounds
        for k in norms:
            out[f"gradnorm/{k}"] = packed[pos]
            pos += 1
        return out

    return run


def make_selfsupervised_train_step(cfg, optimizer,
                                   apply_fn: Callable = query_sat_apply,
                                   device: str | torch.device = "cuda"):
    """Self-conditioning diffusion train step: one pass without
    self-conditioning, a second pass fed the detached sigmoid of the first
    pass's logits; loss = loss1 + 2 * loss2. `apply_fn` selects the layout
    (both take `noisy_num` and `denoised_num`). The step is over (state,
    batch, plans=None): both passes of a flat batch run with its plans."""
    dev = resolve_device(device)
    with_plans = _takes_plans(apply_fn)

    def train_step(state: TrainState, batch, plans=None):
        if with_plans:
            plans = _flat_plans(batch, plans, dev)
        batch = batch.to(dev)
        gen = state.generator
        labels = _select_labels(batch, gen)
        noise_scale = torch.rand((), generator=gen, device=dev)
        noisy = construct_training_input(labels, noise_scale, gen)
        params, leaves, spec = _grad_leaves(state.params)
        common = dict(training=True, labels=labels, noise_scale=noise_scale,
                      noisy_num=noisy, device=dev)
        if with_plans:
            common["plans"] = plans
        logits, loss1, steps, _ = apply_fn(params, cfg, batch, gen, **common)
        denoised = torch.sigmoid(logits).detach()
        _, loss2, _, _ = apply_fn(params, cfg, batch, gen,
                                  denoised_num=denoised, **common)
        loss = loss1 + 2.0 * loss2
        grads, _ = _grads_of(loss, leaves, spec)
        new_params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params)
        new_state = TrainState(params=new_params, opt_state=opt_state,
                               step=state.step + 1, generator=gen)
        return new_state, {"loss": loss.detach(), "loss1": loss1.detach(),
                           "loss2": loss2.detach(), "steps_taken": steps}

    return train_step


def plan_batches(batches: Iterable[Batch],
                 device: str | torch.device = "cuda",
                 edges: bool = False) -> list[PlannedBatch]:
    """Place every batch on `device` once, each flat batch with its kernel
    plans (`BatchPlans` or `ANFPlans`, built on the host before the move and
    padded to the bucket, so that one graphed round serves every batch of a
    bucket; with the edge plans if `edges`); dense batches get None. The
    pairs are what `evaluate_metrics` iterates over."""
    dev = resolve_device(device)
    out: list[PlannedBatch] = []
    for b in batches:
        plans = build_plans(b, pad=True, edges=edges)
        out.append((b.to(dev), None if plans is None else plans.to(dev)))
    return out


def make_predict_step(cfg, apply_fn: Callable = query_sat_apply,
                      prediction_tries: int = 1,
                      noise_scale: float | None = None,
                      graph_sat_fn: Callable | None = None,
                      device: str | torch.device = "cuda"):
    """Predict step. With prediction_tries > 1 the model is re-run with
    fresh randomness and per-graph solutions accumulate across tries: each
    graph keeps the logits of the first try that solved it. `noise_scale`
    pins the conditioning noise level (1.0 = pure solving, no label signal)
    instead of a uniform draw. `graph_sat_fn(logits, batch) -> [G, 1]`
    decides which graphs a try solved; it defaults to the CNF check of the
    batch's layout (pass `losses.anf.is_graph_sat_anf` for ANF batches; a
    check that takes `plans` gets the batch's). `apply_fn` is
    `query_sat_apply` (flat batches), `query_sat_dense_apply` (dense
    batches) or `models.anf_sat.anf_sat_apply` (ANF batches).

    Returns predict_step(params, batch, generator, plans=None, draws=None)
    -> {"prediction", "loss", "steps_taken"}; the prediction is [V] for a
    flat batch and [G, Vg] for a dense one. `draws` is one dict per try of
    keyword arguments for `apply_fn` (`labels`, `noisy_num`, `round_noise`)
    that replace the generator's draws.
    """
    dev = resolve_device(device)
    extra = {} if noise_scale is None else {"noise_scale": noise_scale}
    with_plans = _takes_plans(apply_fn)
    edges = uses_edge_plans(apply_fn)

    @torch.no_grad()
    def predict_step(params, batch: Batch,
                     generator: torch.Generator | None,
                     plans: BatchPlans | None = None,
                     draws: Sequence[dict] | None = None):
        with tracing.span("predict.step"):
            return predict(params, batch, generator, plans, draws)

    def predict(params, batch, generator, plans, draws):
        dense = isinstance(batch, DenseSatBatch)
        kw = dict(extra, device=dev)
        if with_plans and not dense:
            kw["plans"] = _flat_plans(batch, plans, dev, edges)
        batch = batch.to(dev)
        if draws is not None and len(draws) != prediction_tries:
            raise ValueError(f"{len(draws)} sets of draws for "
                             f"{prediction_tries} tries")

        def run(i):
            return apply_fn(params, cfg, batch, generator, training=False,
                            **kw, **({} if draws is None else draws[i]))

        if prediction_tries == 1:
            logits, loss, steps, _ = run(0)
            return {"prediction": logits[..., 0], "loss": loss,
                    "steps_taken": steps}

        sat_fn = graph_sat_fn or (dense_ops.is_graph_sat if dense
                                  else is_graph_sat)
        if "plans" in kw and _takes(sat_fn, "plans"):
            sat_fn = functools.partial(sat_fn, plans=kw["plans"])

        def to_vars(per_graph):                       # [G, 1] -> var rows
            if dense:
                return per_graph[:, None, :]
            return graph_gather_vars(batch, per_graph)

        final = None
        solved = torch.zeros((batch.G, 1), device=dev)
        for i in range(prediction_tries):
            logits, loss, steps, _ = run(i)
            sat_g = sat_fn(logits, batch)                 # [G, 1]
            newly = torch.clamp(sat_g - solved, 0.0, 1.0)
            gained = logits * to_vars(newly)
            final = gained if final is None else final + gained
            solved = solved + newly
        # graphs no try solved keep the last try's logits (instead of
        # all-zero = sigmoid 0.5 per var), so per-variable accuracy stays
        # comparable with tries=1
        final = final + logits * to_vars(torch.clamp(1.0 - solved, 0.0, 1.0))
        return {"prediction": final[..., 0], "loss": loss,
                "steps_taken": steps}

    return predict_step


def evaluate_metrics(params, cfg, data: Iterable[Batch | PlannedBatch],
                     metrics: list[Metric],
                     generator: torch.Generator | None,
                     max_batches: int | None = None,
                     apply_fn: Callable = query_sat_apply,
                     noise_scale: float | None = None,
                     prediction_tries: int = 1,
                     graph_sat_fn: Callable | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """Run predict over a dataset and accumulate the metrics. `data` yields
    batches, or (batch, plans) pairs as `plan_batches` returns them."""
    dev = resolve_device(device)
    predict_step = make_predict_step(cfg, apply_fn,
                                     prediction_tries=prediction_tries,
                                     noise_scale=noise_scale,
                                     graph_sat_fn=graph_sat_fn, device=dev)
    it = iter(data)
    if max_batches is not None:
        it = itertools.islice(it, max_batches)
    for item in it:
        batch, plans = item if isinstance(item, tuple) else (item, None)
        with tracing.span("eval.batch"):
            batch = batch.to(dev)
            out = predict_step(params, batch, generator, plans=plans)
            for m in metrics:
                m.update_state(out, batch)
    values = {}
    for m in metrics:
        values.update(m.get_values(reset_state=True))
    return values


def train(state: TrainState, train_step, data_iter: Iterator,
          steps: int, log_every: int = 100,
          eval_fn: Callable[[TrainState], dict] | None = None,
          eval_every: int = 1000,
          checkpoint_fn: Callable[[TrainState], None] | None = None,
          ckpt_every: int = 1000,
          log_file: str | Path | None = None,
          tb_writer=None,
          target_step: int | None = None) -> TrainState:
    """The training loop. `tb_writer` (train/tb.TBWriter) mirrors the JSONL
    records into TensorBoard.

    `target_step`: stop once `state.step` reaches it. The budget is checked
    before every call, so the loop never runs past it: a step that takes
    `max_steps` (the scanned step) is handed what is left, so a chunk of
    many steps is cut at the budget. Steps per second count the steps
    taken (`state.step`), not the calls. A window cut short by the budget
    is still logged."""
    budgeted = _takes(train_step, "max_steps")
    t0 = time.time()
    window_losses: list[torch.Tensor] = []
    prev_step = state.step

    def log_window():
        nonlocal t0, prev_step, window_losses
        # one host fetch for the window, not one per scalar
        losses = torch.stack(window_losses).cpu().tolist()
        dt = time.time() - t0
        t0 = time.time()
        msg = {"step": state.step, "loss": sum(losses) / len(losses),
               "steps_per_sec": (state.step - prev_step) / dt}
        prev_step = state.step
        window_losses = []
        print(f"[train] {msg}")
        if log_file is not None:
            with Path(log_file).open("a") as f:
                f.write(json.dumps(msg) + "\n")
        if tb_writer is not None:
            tb_writer.scalars(state.step, msg)

    for i in range(steps):
        if target_step is not None and state.step >= target_step:
            break
        batch = next(data_iter)
        if budgeted and target_step is not None:
            state, out = train_step(state, batch,
                                    max_steps=target_step - state.step)
        else:
            state, out = train_step(state, batch)
        # the loss stays on the device until the window is logged
        window_losses.append(out["loss"])
        if (i + 1) % log_every == 0:
            log_window()
        if eval_fn is not None and (i + 1) % eval_every == 0:
            vals = eval_fn(state)
            print(f"[eval @ {state.step}] {vals}")
            if log_file is not None:
                with Path(log_file).open("a") as f:
                    f.write(json.dumps({"step": state.step, **vals}) + "\n")
            if tb_writer is not None:
                tb_writer.scalars(state.step, vals)
                tb_writer.flush()
        if checkpoint_fn is not None and (i + 1) % ckpt_every == 0:
            checkpoint_fn(state)
    if window_losses:
        log_window()
    return state
