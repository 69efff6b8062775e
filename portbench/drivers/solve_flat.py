"""The solving pass of flat QuerySAT, a CUDA graph a round.

What the window drives: `train/loop.evaluate_metrics(params, cfg, [(batch,
plans)], ..., apply_fn=query_sat_apply, noise_scale=1.0)`, as `solve_eval`
runs it, one batch a call: the flat model's rounds replayed as one
captured round (`cuda_graphs.run_rounds`), every literal-clause sum on
the segsum kernel over padded plans (`train/loop.plan_batches`). The
configuration's `test_rounds` with no early exit, so the rate does not
depend on how many formulas the weights solve. The weights are made from
the seed.

The answers are each formula's logits. After the window, `check_batches`
calls drawn from the seed are followed by the reference, which replays
the program's draws of every call before them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness
from portbench.gen import threshold_3sat as gen3

_window = harness.load_module("drivers", "_window")
_mega = harness.load_module("drivers", "_mega")
_dense = harness.load_module("drivers", "train_dense")


class Collect:
    """A metric of the program's evaluation loop that keeps each call's
    prediction."""

    def __init__(self):
        self.preds = []

    def update_state(self, out, batch):
        self.preds.append(out["prediction"])

    def get_values(self, reset_state=True):
        return {}


def batch_sizes(b) -> dict:
    lits = sum(len({x for cl in c for x in cl}) for _, c, _ in b)
    return {"n_vars": sum(n for n, *_ in b), "n_lits": lits,
            "n_clauses": sum(len(c) for _, c, _ in b),
            "n_edges": sum(3 * len(c) for _, c, _ in b),
            "n_graphs": len(b)}


class Cell(_window.WindowedCell):
    def __init__(self, ctx):
        from diffusionsat_torch.graph.batch import BucketSpec, build_batch
        from diffusionsat_torch.models.query_sat import (QuerySATConfig,
                                                         query_sat_apply)
        from diffusionsat_torch.train.loop import (evaluate_metrics,
                                                   plan_batches)

        self.ctx, self.dev, self.rec = ctx, ctx.device, ctx.rec
        cfg, tr, rec, dev = ctx.config, ctx.traffic, self.rec, self.dev
        self.ref = harness.load_module("reference", ctx.config_name)
        self.rng, self.w_seed, self.g_seed = _mega.seeds(ctx.seed)
        with rec.span("traffic"):
            self.limits = gen3.bucket_limits(tr["node_budget"],
                                             tr["max_graphs"])
            self.raw = gen3.pack(gen3.sized_pool(self.rng, tr),
                                 tr["node_budget"], self.limits, sort=False)
        with rec.span("prepare"):
            bucket = BucketSpec(**self.limits)
            self.planned = plan_batches(
                [build_batch([(n, c) for n, c, _ in b], bucket)
                 for b in self.raw], dev)
        self.items = [[dict(batch_sizes(b), rounds=cfg["test_rounds"])]
                      for b in self.raw]
        self.qcfg = QuerySATConfig(
            **{k: cfg[k] for k in _dense.QUERYSAT_KEYS})
        with rec.span("weights"):
            self.params = self.ref.init_params(cfg, self.w_seed, dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.g_seed)
        self.collect = Collect()
        self.calls = []          # the unit of every call, in order

        def call(i):
            evaluate_metrics(self.params, self.qcfg, [self.planned[i]],
                             [self.collect], self.gen,
                             apply_fn=query_sat_apply,
                             noise_scale=tr["noise_scale"], device=dev)
            self.calls.append(i)
        self._run = call
        # one shape for every batch (plans padded to the bucket): the
        # first call captures the round, the second replays it
        times = []
        for i in range(min(2, len(self.raw))):
            t0 = time.perf_counter()
            with rec.span("warmup"):
                call(i)
                self.sync()
            times.append(time.perf_counter() - t0)
        rec.counters["graph_capture_s"] = times[0] - times[-1]
        self.first_window_call = len(self.calls)

    def _call(self, i: int, outs: list):
        with self.rec.span("batch"):
            self._run(i)

    def attempted(self, work: list) -> int:
        return sum(it["n_graphs"] for it in work)

    def failed(self, outs: list) -> int:
        bad = 0
        for c, p in zip(self.calls[self.first_window_call:],
                        self.collect.preds[self.first_window_call:]):
            n = self.items[c][0]["n_vars"]
            if not bool(torch.isfinite(p[:n]).all()):
                bad += 1
        return bad

    def end_to_end(self, win: dict) -> dict:
        return {"solve_graphs_per_s": win["graphs"] / win["seconds"]}

    def release(self):
        self.planned = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference_answers(self, picks, precision: str) -> list:
        """The reference's logits [V] of the calls `picks` (sorted)."""
        cfg, tr, dev, ref = self.ctx.config, self.ctx.traffic, self.dev, \
            self.ref
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.g_seed)
        V_pad = self.limits["max_vars"]
        out, at = [], 0
        with torch.no_grad():
            for c in picks:
                for _ in range(at, c):
                    ref.predict_draws(gen, dev, V_pad, 0,
                                      cfg["test_rounds"])
                b = self.raw[self.calls[c]]
                gr = ref.build_graph([(n, cl) for n, cl, _ in b], dev)
                labels, u, noise = ref.predict_draws(gen, dev, V_pad, gr.V,
                                                     cfg["test_rounds"])
                ns = torch.tensor(tr["noise_scale"], device=dev)
                _, logits, _, _ = ref.forward(
                    self.params, cfg, gr, labels, ns, u, noise,
                    cfg["test_rounds"], False, precision)
                out.append(logits[:, 0])
                at = c + 1
        return out

    def picks(self) -> list:
        """`check_batches` of the window's calls, drawn from the seed."""
        n = self.ctx.traffic["check_batches"]
        calls = np.arange(self.first_window_call, len(self.calls))
        return sorted(int(c) for c in self.rng.choice(
            calls, size=min(n, len(calls)), replace=False))

    def compare(self, picks, answers, reference) -> dict:
        """The widest gap of a formula's logit from the reference's, over
        the largest reference logit of its batch."""
        gap = 0.0
        for c, a, r in zip(picks, answers, reference):
            g = float((a[:r.shape[0]] - r).abs().max() /
                      r.abs().max().clamp(min=1e-30))
            gap = max(gap, float("inf") if g != g else g)
        return {"logit_gap": gap}

    def check(self) -> dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        picks = self.picks()
        answers = [self.collect.preds[c] for c in picks]
        numbers = self.compare(picks, answers,
                               self.reference_answers(picks, "f32"))
        limits = self.ctx.traffic["limits"][self.ctx.config_name]
        return {k: {"value": v, "limit": limits[k]}
                for k, v in numbers.items()}
