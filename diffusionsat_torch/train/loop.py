"""Predict step and metric evaluation.

Counterpart of the evaluation half of the TPU package's `train/loop.py`
(`make_predict_step`, `evaluate_metrics`). The train steps of that module
are not ported yet (ROADMAP Queue 1, item 4).

A flat batch runs with `BatchPlans`, so on the card its literal-clause
aggregations go through the segsum kernel. Plans are host-built: pass a
batch together with its plans (`plan_batches`) to build them once, before
the timed or repeated work; a bare flat batch gets its plans built inside
the step, once per call however many tries it takes.
"""

from __future__ import annotations

import inspect
import itertools
from typing import Callable, Iterable, Sequence

import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.graph.dense_batch import DenseSatBatch
from diffusionsat_torch.losses.sat import is_graph_sat
from diffusionsat_torch.models.query_sat import query_sat_apply
from diffusionsat_torch.ops import dense_ops
from diffusionsat_torch.ops.graph_ops import graph_gather_vars
from diffusionsat_torch.ops.segsum import BatchPlans, build_batch_plans
from diffusionsat_torch.train.metrics import Metric

Batch = SatBatch | DenseSatBatch
PlannedBatch = tuple[Batch, BatchPlans | None]


def _takes_plans(apply_fn: Callable) -> bool:
    try:
        return "plans" in inspect.signature(apply_fn).parameters
    except (TypeError, ValueError):
        return False


def plan_batches(batches: Iterable[Batch],
                 device: str | torch.device = "cuda") -> list[PlannedBatch]:
    """Place every batch on `device` once, each flat batch with its
    `BatchPlans` (built on the host before the move); dense batches get
    None. The pairs are what `evaluate_metrics` iterates over."""
    dev = resolve_device(device)
    out: list[PlannedBatch] = []
    for b in batches:
        plans = build_batch_plans(b).to(dev) if isinstance(b, SatBatch) \
            else None
        out.append((b.to(dev), plans))
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
    batch's layout. `apply_fn` is `query_sat_apply` (flat batches) or
    `query_sat_dense_apply` (dense batches).

    Returns predict_step(params, batch, generator, plans=None, draws=None)
    -> {"prediction", "loss", "steps_taken"}; the prediction is [V] for a
    flat batch and [G, Vg] for a dense one. `draws` is one dict per try of
    keyword arguments for `apply_fn` (`labels`, `noisy_num`, `round_noise`)
    that replace the generator's draws.
    """
    dev = resolve_device(device)
    extra = {} if noise_scale is None else {"noise_scale": noise_scale}
    with_plans = _takes_plans(apply_fn)

    @torch.no_grad()
    def predict_step(params, batch: Batch,
                     generator: torch.Generator | None,
                     plans: BatchPlans | None = None,
                     draws: Sequence[dict] | None = None):
        dense = isinstance(batch, DenseSatBatch)
        kw = dict(extra, device=dev)
        if with_plans and not dense:
            if plans is None:
                plans = build_batch_plans(batch)
            kw["plans"] = plans.to(dev)
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
        batch = batch.to(dev)
        out = predict_step(params, batch, generator, plans=plans)
        for m in metrics:
            m.update_state(out, batch)
    values = {}
    for m in metrics:
        values.update(m.get_values(reset_state=True))
    return values
