"""Flat CNF training on padded kernel plans, N steps a CUDA graph replay.

What the window drives: `train/loop.make_scanned_train_step_for(apply,
...)` over the chunks that `train/loop.chunk_batches` groups from
`plan_batches`' padded batches, as `main --model <name> --mega_steps N`
trains: every literal-clause sum on the segsum kernel, forward and
backward. The model is the one the configuration's `registry` key names
in the program's registry (`registry.MODEL_REGISTRY`), with the keys of
its config class that the configuration holds. The traffic
(`gen/threshold_3sat.py`) packs threshold 3-SAT formulas of every size
in an order drawn from the seed, so every batch mixes sizes and every
batch has one padded shape; only whole chunks (`train/loop.whole_chunks`)
are kept. The rest is `_mega.py`'s.
"""

from __future__ import annotations

import dataclasses

from portbench import harness
from portbench.gen import threshold_3sat as gen3

_mega = harness.load_module("drivers", "_mega")
_solve = harness.load_module("drivers", "solve_flat")


class Cell(_mega.MegaStepCell):
    def prepare(self):
        from diffusionsat_torch.graph.batch import BucketSpec, build_batch
        from diffusionsat_torch.registry import MODEL_REGISTRY
        from diffusionsat_torch.train.loop import (
            chunk_batches, make_scanned_train_step_for, plan_batches,
            whole_chunks)

        cfg, tr, rec = self.ctx.config, self.ctx.traffic, self.rec
        n = tr["mega_steps"]
        with rec.span("traffic"):
            limits = gen3.bucket_limits(tr["node_budget"], tr["max_graphs"])
            batches = gen3.pack(gen3.sized_pool(self.rng, tr),
                                tr["node_budget"], limits, sort=False)
            self.raw = whole_chunks(batches, n)
        with rec.span("prepare"):
            bucket = BucketSpec(**limits)
            planned = plan_batches(
                [build_batch([(v, c) for v, c, _ in b], bucket)
                 for b in batches], "cpu")
            self.chunks = chunk_batches(planned, n, self.dev)
        self.items = [[_solve.batch_sizes(b) for b in c] for c in self.raw]
        cfg_cls, _, apply = MODEL_REGISTRY.resolve(cfg["registry"])
        mcfg = cfg_cls(**{f.name: cfg[f.name]
                          for f in dataclasses.fields(cfg_cls)
                          if f.name in cfg})
        self.mega = make_scanned_train_step_for(apply, mcfg, self.opt,
                                                self.dev)

    def reference_step(self, gen, c: int, r: int):
        """The reference's inputs of chunk c's row r: the formulas' graph
        (the model draws nothing)."""
        return self.ref.build_graph([(v, cl) for v, cl, _ in
                                     self.raw[c][r]], self.dev)
