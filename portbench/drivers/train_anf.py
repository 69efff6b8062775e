"""ANFSAT training on padded kernel plans, N steps a CUDA graph replay.

What the window drives: `train/loop.make_scanned_train_step_for(
anf_sat_apply, ...)` over chunks of N batches with their padded plans, as
`anf_training --mega_steps N` runs it: the membership sums and the AND
scatter, forward and backward, on the segsum kernel. The traffic is a
fixed pool of SHA-1 systems (`gen/sha1_anf.py`; how many variables a
system has depends on which message bits are free, so a pool drawn per
seed would change the work a step), packed by the program
(`data/anf_datasets.pack_anf_instances`) with the batch order drawn from
the run's seed; batches and plans by `graph/anf_batch.build_anf_batch`
and `train/loop.build_plans(pad=True)`. The rest is `_mega.py`'s.
"""

from __future__ import annotations

import torch

from portbench import harness
from portbench.gen.sha1_anf import sha1_anf

_mega = harness.load_module("drivers", "_mega")

ANFSAT_KEYS = ("feature_maps", "query_maps", "msg_layers", "vote_layers",
               "train_rounds", "test_rounds", "supervised",
               "use_message_passing", "use_query", "free_input_upweight",
               "update_scale", "output_scale", "clauses_scale",
               "query_scale")


def free_bits(tr: dict) -> list[int]:
    """Each system's free bits, spread evenly from the least to the most."""
    lo, hi, n = tr["min_free_bits"], tr["max_free_bits"], tr["systems"]
    return [lo + round(i * (hi - lo) / max(n - 1, 1)) for i in range(n)]


def pool(tr: dict) -> list:
    return [sha1_anf(rounds=tr["rounds"], free_bits=fb,
                     seed=tr["first_system_seed"] + i)
            for i, fb in enumerate(free_bits(tr))]


def sizes(systems) -> dict:
    eqs = [e for _, es, _ in systems for e in es]
    ands = sum(len({(min(t), max(t)) for e in es for t in e if len(t) == 2})
               for _, es, _ in systems)
    return {"n_vars": sum(n for n, _, _ in systems), "n_ands": ands,
            "n_clauses": len(eqs), "n_edges": sum(len(e) for e in eqs),
            "n_graphs": len(systems)}


class Cell(_mega.MegaStepCell):
    def prepare(self):
        from diffusionsat_torch.data.anf_datasets import pack_anf_instances
        from diffusionsat_torch.graph.anf_batch import (ANFBucket,
                                                         build_anf_batch)
        from diffusionsat_torch.models.anf_sat import (ANFSATConfig,
                                                       anf_sat_apply)
        from diffusionsat_torch.train.loop import (
            build_plans, make_scanned_train_step_for, stack_batches)

        cfg, tr, rec = self.ctx.config, self.ctx.traffic, self.rec
        with rec.span("traffic"):
            systems = pool(tr)
        n = tr["mega_steps"]
        bucket = ANFBucket(**tr["bucket"])
        with rec.span("prepare"):
            packed = pack_anf_instances(
                systems, bucket, seed=int(self.rng.integers(2 ** 31)))
            pairs = []
            for b in packed:
                batch = build_anf_batch([(v, e) for v, e, _ in b], bucket,
                                        solutions=[w for *_, w in b])
                pairs.append((batch, build_plans(batch, pad=True)))
            self.chunks = [
                tuple(t.to(self.dev) for t in stack_batches(pairs[i:i + n]))
                for i in range(0, len(pairs), n)]
        self.raw = [packed[i:i + n] for i in range(0, len(packed), n)]
        self.items = [[sizes(b) for b in c] for c in self.raw]
        acfg = ANFSATConfig(**{k: cfg[k] for k in ANFSAT_KEYS})
        self.mega = make_scanned_train_step_for(anf_sat_apply, acfg,
                                                self.opt, self.dev)

    def reference_step(self, gen, c: int, r: int):
        """The reference's inputs of chunk c's row r, with the draws that
        the program's step takes from `gen`."""
        cfg, dev, ref = self.ctx.config, self.dev, self.ref
        b = self.raw[c][r]
        gr = ref.build_graph([(v, e) for v, e, _ in b], dev)
        labels = torch.as_tensor([x for *_, w in b for x in w], device=dev)
        noise = ref.train_draws(gen, dev,
                                self.ctx.traffic["bucket"]["max_vars"],
                                gr.V, cfg["train_rounds"])
        return gr, labels, noise
