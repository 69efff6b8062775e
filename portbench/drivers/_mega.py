"""What the training cells share: chunks of N steps as one CUDA graph
replay (`train/loop.make_scanned_train_step_for`), the steps that the
reference follows, the warm-up of every chunk shape, the window and the
check.

Set-up drives the program from the seed with the window's own call and
feed, in states that start from the same weights and generator seed:

- the window's state takes the first chunk whole through the graph that
  the window replays, and is then handed on to the window;
- for each other chunk shape, a state of its own takes the first chunk
  of that shape through its graph; the check follows its first
  `SHAPE_STEPS` steps;
- a state of its own takes the first chunk's first step (`max_steps=1`),
  then its next two as a chunk of two. The first gradient is read as the
  optimizer gets it, before its clip (a copy at the optimizer's entry,
  captured into that one-step graph alone), and the parameters' change
  after step `CHECK_STEPS`.

The reference follows each state from the seed (`follow`: per state, the
chunk and row of each step). Then every chunk is replayed once in the
window's state: `graph_capture_s` is each shape's first call less that
replay, summed. The window is `_window.py`'s, a unit a chunk.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, harness

_window = harness.load_module("drivers", "_window")
CHECK_STEPS = 3     # the parameters' change is read after these
SHAPE_STEPS = 2     # steps followed of each chunk shape but the first


def seeds(seed: int) -> tuple[np.random.Generator, int, int]:
    """The traffic's generator, the weights' seed and the training
    generator's seed, all from the run's seed."""
    ss = np.random.SeedSequence(seed)
    a, b = (int(x) for x in ss.generate_state(2, np.uint64) >> np.uint64(1))
    return np.random.default_rng(ss.spawn(1)[0]), a, b


def recording_adabelief(**kw):
    """The program's AdaBelief, copying the gradients it gets into `keep`
    (a tree like the params) while `keep` is set."""
    from torch.utils import _pytree as pytree

    from diffusionsat_torch.train.adabelief import AdaBelief

    class Recording(AdaBelief):
        keep = None

        def update(self, grads, state, params):
            if self.keep is not None:
                torch._foreach_copy_(pytree.tree_leaves(self.keep),
                                     pytree.tree_leaves(grads))
            return super().update(grads, state, params)

    return Recording(**kw)


class MegaStepCell(_window.WindowedCell):
    """A subclass sets `self.chunks` (stacked feeds on the card), `self.items`
    (per chunk, one dict of real sizes per step) and `self.mega` in
    `prepare`, and gives the reference a step's inputs in
    `reference_step(gen, chunk, row)`."""

    def __init__(self, ctx):
        from diffusionsat_torch.cuda_graphs import tree_map, tree_signature

        self.ctx, self.dev, self.rec = ctx, ctx.device, ctx.rec
        rec = self.rec
        self.ref = harness.load_module("reference", ctx.config_name)
        self.rng, self.w_seed, self.g_seed = seeds(ctx.seed)
        self.opt = recording_adabelief(
            learning_rate=ctx.traffic["learning_rate"], eps=1e-8,
            clip_gradients=True)
        self.prepare()
        with rec.span("weights"):
            p0 = self.ref.init_params(ctx.config, self.w_seed, self.dev)

        flat = self.ref.flatten
        first = {}              # chunk -> seconds of its shape's first call
        with rec.span("check_steps"):
            losses, self.follow, seen = [], [], set()
            for i, c in enumerate(self.chunks):
                if tree_signature(c) in seen:
                    continue
                seen.add(tree_signature(c))
                t0 = time.perf_counter()
                st, out = self.mega(self.fresh(p0), c)
                self.sync()
                first[i] = time.perf_counter() - t0
                n = len(self.items[i]) if i == 0 else \
                    min(SHAPE_STEPS, len(self.items[i]))
                losses += [float(x) for x in out["loss_per_step"][:n]]
                self.follow.append([(i, r) for r in range(n)])
                if i == 0:
                    state = st
            c0 = self.chunks[0]
            self.opt.keep = tree_map(torch.empty_like, p0)
            s1, _ = self.mega(self.fresh(p0), c0, max_steps=1)
            grad1 = {k: v.detach().clone() for k, v in flat(self.opt.keep)}
            self.opt.keep = None
            s1, _ = self.mega(s1, tree_map(lambda t: t[1:CHECK_STEPS], c0))
            self.prog = {"losses": losses, "grad1": grad1,
                         "at": [k for rows in self.follow
                                for k in range(len(rows))],
                         "p0": {k: v.clone() for k, v in flat(p0)},
                         "p_end": {k: v.detach().clone()
                                   for k, v in flat(s1.params)}}
            del s1
        del p0
        if getattr(ctx, "check_only", False):
            return

        capture = 0.0
        for i, c in enumerate(self.chunks):
            t0 = time.perf_counter()
            with rec.span("warmup"):
                state, _ = self.mega(state, c)
                self.sync()
            if i in first:
                capture += first[i] - (time.perf_counter() - t0)
        rec.counters["graph_capture_s"] = capture
        self.state = state

    def fresh(self, p0):
        """A training state at the weights `p0`, its generator seeded from
        the run's seed."""
        from diffusionsat_torch.cuda_graphs import tree_map
        from diffusionsat_torch.train.loop import TrainState

        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.g_seed)
        return TrainState(params=tree_map(torch.clone, p0),
                          opt_state=self.opt.init(p0), step=0,
                          generator=gen)

    def _call(self, i: int, losses: list):
        with self.rec.span("chunk"):
            self.state, out = self.mega(self.state, self.chunks[i])
        losses.append(out["loss_per_step"])

    def attempted(self, work: list) -> int:
        return len(work)

    def failed(self, losses: list) -> int:
        return int((~torch.isfinite(torch.cat(losses))).sum())

    def end_to_end(self, win: dict) -> dict:
        return {"train_graphs_per_s": win["graphs"] / win["seconds"]}

    def release(self):
        self.state = self.chunks = self.mega = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference_run(self, precision: str) -> dict:
        """The reference over the followed states, each from the seed's
        weights and generator: the losses of every followed step; the
        first state's first gradient (before and after the clip) and its
        parameters after `CHECK_STEPS` steps."""
        cfg, dev, ref = self.ctx.config, self.dev, self.ref
        out = {"losses": []}
        for n, rows in enumerate(self.follow):
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.g_seed)
            steps = [self.reference_step(gen, c, r) for c, r in rows]
            p0 = ref.init_params(cfg, self.w_seed, dev)
            opt = ref.AdaBelief(learning_rate=self.ctx.traffic[
                "learning_rate"])
            losses, grad1, taken1, p_end = ref.train_steps(
                p0, cfg, steps, opt, precision, keep_after=CHECK_STEPS)
            out["losses"] += losses
            if n == 0:
                out.update(grad1=grad1, taken1=taken1, p_end=p_end,
                           p0=dict(ref.flatten(p0)))
        return out

    def check(self) -> dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        numbers = compare.training(self.prog, self.reference_run("f32"))
        limits = self.ctx.traffic["limits"][self.ctx.config_name]
        return compare.as_checks(numbers, limits)
