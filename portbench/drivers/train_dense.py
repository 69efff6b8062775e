"""Training on dense per-graph blocks, N steps a CUDA graph replay.

What the window drives: `train/loop.make_scanned_train_step_for(
query_sat_dense_apply, ...)`, as `diffusion_training --mega_steps N` runs
it, over chunks of N same-shape dense batches. The traffic
(`gen/threshold_3sat.py`) packs size-sorted threshold 3-SAT formulas to the
node budget; N consecutive batches form a chunk, densified by the program
(`graph/batch.build_batch`, `graph/dense_batch.dense_from_flat`) at the
largest quantized block shape among them, so that every step of a chunk
trains on other rows. The rest is `_mega.py`'s.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import harness
from portbench.gen import threshold_3sat as gen3

_mega = harness.load_module("drivers", "_mega")

# quantized block levels (Vg, Cg) of `graph/dense_batch.py` (commit
# ca3446b, the fine table): step-2 variable counts with the clause dim at
# the threshold ratio rounded up to 8
LEVELS = tuple(
    (v, int(-(-(4.258 * v + 58.26 * v ** (-2.0 / 3.0)) // 8) * 8))
    for v in range(6, 33, 2)) + ((48, 224), (64, 288), (96, 448),
                                 (128, 576))

QUERYSAT_KEYS = (
    "feature_maps", "query_maps", "logit_maps", "msg_layers",
    "update_layers", "output_layers", "query_layers", "clauses_layers",
    "update_scale", "output_scale", "clauses_scale", "query_scale",
    "train_rounds", "test_rounds", "supervised", "use_message_passing",
    "noise_skew")

# the program's incidence modes (`ops/dense_ops.PRECISIONS`) by the
# precision a configuration states for the incidence products
INCIDENCE_MODES = {"bf16": "default", "tf32": "high", "f32": "highest"}


def block_shape(batches, quantum: int) -> tuple[int, int, int]:
    """(G, Vg, Cg) holding every formula of the chunk's batches."""
    maxv = max(n for b in batches for n, *_ in b)
    maxc = max(len(c) for b in batches for _, c, *_ in b)
    vg, cg = next((v, c) for v, c in LEVELS if maxv <= v and maxc <= c)
    g = max(len(b) for b in batches)
    return -(-g // quantum) * quantum, vg, cg


class Cell(_mega.MegaStepCell):
    def prepare(self):
        from diffusionsat_torch.graph.batch import BucketSpec, build_batch
        from diffusionsat_torch.graph.dense_batch import dense_from_flat
        from diffusionsat_torch.models.query_sat import QuerySATConfig
        from diffusionsat_torch.models.query_sat_dense import \
            query_sat_dense_apply
        from diffusionsat_torch.ops import dense_ops
        from diffusionsat_torch.train.loop import (
            make_scanned_train_step_for, stack_batches)

        cfg, tr, rec = self.ctx.config, self.ctx.traffic, self.rec
        with rec.span("traffic"):
            limits = gen3.bucket_limits(tr["node_budget"], tr["max_graphs"])
            batches = gen3.pack(gen3.sized_pool(self.rng, tr),
                                tr["node_budget"], limits)
            n = tr["mega_steps"]
            self.chunks_raw = [batches[i:i + n]
                               for i in range(0, len(batches), n)]
        bucket = BucketSpec(**limits)
        self.chunks, self.items, self.shapes = [], [], []
        with rec.span("prepare"):
            for raw in self.chunks_raw:
                G, Vg, Cg = block_shape(raw, tr["graph_quantum"])
                self.shapes.append((G, Vg, Cg))
                dense = [dense_from_flat(
                    build_batch([(n, c) for n, c, _ in b], bucket,
                                solutions=[s for *_, s in b]), G, Vg, Cg)
                    for b in raw]
                self.chunks.append(stack_batches(dense).to(self.dev))
                self.items.append([{
                    "n_vars": sum(n for n, *_ in b),
                    "n_clauses": sum(len(c) for _, c, _ in b),
                    "n_edges": sum(3 * len(c) for _, c, _ in b),
                    "n_graphs": len(b)} for b in raw])
        qcfg = QuerySATConfig(**{k: cfg[k] for k in QUERYSAT_KEYS},
                              block_bf16=tr["precision"] == "block_bf16")
        self._scope = contextlib.ExitStack()
        self._scope.enter_context(
            dense_ops.incidence_precision(INCIDENCE_MODES[
                cfg["precision"][tr["precision"]]["incidence"]]))
        self.mega = make_scanned_train_step_for(query_sat_dense_apply, qcfg,
                                                self.opt, self.dev)

    def release(self):
        self._scope.close()
        super().release()

    def reference_step(self, gen, c: int, r: int):
        """The reference's inputs of chunk c's row r, with the draws that
        the program's step takes from `gen`."""
        cfg, dev, ref = self.ctx.config, self.dev, self.ref
        b = self.chunks_raw[c][r]
        G, Vg, _ = self.shapes[c]
        gr = ref.build_graph([(n, cl) for n, cl, _ in b], dev)
        si = torch.as_tensor(gr.var_slot, device=dev)
        labels = torch.as_tensor(np.concatenate([s for *_, s in b]),
                                 device=dev)
        draws = ref.train_draws(gen, dev, (G, Vg), (gr.var_graph, si),
                                cfg["train_rounds"])
        return gr, labels, draws
