"""Many steps per dispatch on the card: CUDA graphs of a chunk of train
steps and of an inference round.

The TPU package compiles its loops: `lax.scan` of N train steps over a
stack of batches (`train/loop.make_scanned_train_step_for`) and the
`lax.scan` / `while_loop` of the recurrent rounds. Eager PyTorch launches
every kernel from the host instead, about 200 a round at 12-32 us of host
time each, so the card idles most of the time. The counterpart of one XLA
dispatch here is one CUDA graph replay:

- `CapturedGraph`: a function of static input buffers captured once (after
  one warm-up call on a side stream) and replayed; each graph has its own
  memory pool. A graph that draws random numbers draws them from its own
  generator, registered with the graph; `drawing_from(generator)` lends it
  the caller's generator state for the replays and hands the advanced state
  back, so replays draw exactly the numbers eager calls would.
- `run_rounds`: the round loop of the three models in inference: one graph
  per round body and shape, replayed `rounds` times, with the early-exit
  flag read between replays as the TPU package's `while_loop` tests it.
- Counters (`tracing.py`'s families, `ops/segsum.LAUNCHES` among them):
  what a graph's capture counted is credited once per replay; the warm-up
  and the capture count nothing. The `graph` family counts the captures
  and the host time inside their recording blocks.
- Spans (`tracing.py`, while a profiler records): `graph.lookup`,
  `graph.copy_in`, `graph.replay` and `graph.copy_out` of each call.

On CUDA the graphs are on unless `DSAT_EAGER=1` (`graphs_enabled`). On the
CPU nothing is captured: a "replay" calls the function on the static
buffers, which keeps the buffer plumbing testable there.

Capture and replay never fall back: a failure raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Iterator

import torch

from diffusionsat_torch import tracing
from diffusionsat_torch.ops import segsum

EAGER_ENV = "DSAT_EAGER"
# graphs recorded, and ns of host time inside their recording blocks
GRAPHS = tracing.family("graph", ("captures", "record_ns"))


def graphs_enabled(device: torch.device) -> bool:
    """True on CUDA unless `DSAT_EAGER=1` asks for the eager loops."""
    return device.type == "cuda" and os.environ.get(EAGER_ENV, "0") != "1"


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """Run the body with `DSAT_EAGER=1` (the eager loops on the card)."""
    old = os.environ.get(EAGER_ENV)
    os.environ[EAGER_ENV] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[EAGER_ENV]
        else:
            os.environ[EAGER_ENV] = old


# ---------------------------------------------------------------------------
# Trees of tensors: dicts, lists, tuples, named tuples and dataclasses (the
# batches, plans, params and optimizer states of the port)


def _children(obj) -> tuple[str, list] | None:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return "dc", [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        return "dict", list(obj.values())
    if isinstance(obj, (list, tuple)):
        return "seq", list(obj)
    return None


def _rebuild(obj, kids: list):
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: k for f, k in zip(dataclasses.fields(obj), kids)})
    if isinstance(obj, dict):
        return dict(zip(obj.keys(), kids))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*kids)
    return type(obj)(kids)


def tree_map(fn: Callable[..., Any], obj, *rest):
    """`fn` applied to every tensor of `obj` (and the matching tensors of
    the trees in `rest`, which share its structure); other leaves are kept
    from `obj`."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    kids = _children(obj)
    if kids is None:
        return obj
    others = [_children(r)[1] for r in rest]
    return _rebuild(obj, [tree_map(fn, k, *(o[i] for o in others))
                          for i, k in enumerate(kids[1])])


def tree_leaves(obj) -> list[torch.Tensor]:
    """The tensors of `obj`, depth first."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    kids = _children(obj)
    if kids is None:
        return []
    return [t for k in kids[1] for t in tree_leaves(k)]


def tree_signature(obj):
    """A hashable description of `obj`: its structure, the shape, type and
    device of every tensor and the value of every other leaf."""
    if isinstance(obj, torch.Tensor):
        return ("T", tuple(obj.shape), obj.dtype, str(obj.device))
    kids = _children(obj)
    if kids is None:
        return obj
    keys = tuple(obj.keys()) if isinstance(obj, dict) else None
    return (type(obj).__name__, keys,
            tuple(tree_signature(k) for k in kids[1]))


def tree_copy_(dst, src) -> None:
    """Copy every tensor of `src` into the matching tensor of `dst`,
    skipping the ones that are `dst`'s own."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if d is not s:
            d.copy_(s)


def stack_trees(objs: list):
    """Trees of one structure stacked on a new leading axis: tensors with
    `torch.stack`; every other leaf (None included) must be equal in all."""
    first = objs[0]
    if isinstance(first, torch.Tensor):
        if not all(isinstance(o, torch.Tensor) for o in objs):
            raise ValueError("cannot stack a tensor with a non-tensor")
        return torch.stack(objs)
    kids = _children(first)
    if kids is None:
        if any(o != first for o in objs[1:]):
            raise ValueError(f"cannot stack unequal leaves {objs!r}")
        return first
    per = [_children(o)[1] for o in objs]
    return _rebuild(first, [stack_trees([p[i] for p in per])
                            for i in range(len(kids[1]))])


def index_tree(obj, i: int):
    """Entry `i` of a stacked tree (views)."""
    return tree_map(lambda t: t[i], obj)


def stack_length(obj) -> int:
    """The leading length of a stacked tree."""
    return tree_leaves(obj)[0].shape[0]


# ---------------------------------------------------------------------------
# One captured function


class CapturedGraph:
    """`fn(static, generator)` captured once as a CUDA graph.

    `static` is a tree of tensors that the caller owns and refills between
    replays; `fn` reads them and writes its results into tensors that
    outlive the capture (static buffers). With `with_generator`, `fn` is
    handed the graph's own
    generator, registered with the graph; otherwise it is handed None (the
    default generator, which every graph registers). The warm-up call
    (`warmup`, by default `fn` itself, with the same arguments) does not
    move the default generator; a cheaper one that runs the same kinds of
    kernels will do.
    """

    def __init__(self, fn: Callable[[Any, torch.Generator | None], Any],
                 static, device: torch.device, with_generator: bool,
                 warmup: Callable | None = None):
        self.static = static
        self.generator = (torch.Generator(device=device) if with_generator
                          else None)
        self._fn = fn
        # what the capture counted, by counter family: credited per replay
        self.counts: dict[str, dict[str, int]] = {}
        if device.type != "cuda":
            # no graph on the CPU: each replay calls fn on the buffers
            self.graph = None
            return
        before = tracing.counters()
        rng = torch.cuda.get_rng_state(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            (warmup or fn)(static, self.generator)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.set_rng_state(rng, device)
        warm = tracing.counters()
        self.graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            self.graph.register_generator_state(self.generator)
        t0 = time.perf_counter_ns()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            fn(static, self.generator)
        recorded = time.perf_counter_ns() - t0
        self.counts = tracing.changes_since(warm)
        tracing.restore(before)
        GRAPHS["captures"] += 1
        GRAPHS["record_ns"] += recorded

    @property
    def segsum_launches(self) -> int:
        """Segsum kernel launches a replay runs."""
        return sum(self.counts.get(segsum.LAUNCH_FAMILY, {}).values())

    @contextlib.contextmanager
    def drawing_from(self, generator: torch.Generator | None
                     ) -> Iterator[None]:
        """Replays inside the block draw from `generator`'s state, which
        leaves the block advanced as far as eager calls would leave it."""
        if self.generator is None:
            yield
            return
        self.generator.set_state(generator.get_state())
        try:
            yield
        finally:
            generator.set_state(self.generator.get_state())

    def replay(self) -> None:
        if self.graph is None:
            self._fn(self.static, self.generator)
            return
        self.graph.replay()
        tracing.credit(self.counts)


# ---------------------------------------------------------------------------
# Graphed round loops

# round graphs by body, shapes and settings, least recently used first
_ROUND_GRAPHS: collections.OrderedDict = collections.OrderedDict()
MAX_ROUND_GRAPHS = 8


def clear_round_graphs() -> None:
    """Drop every cached round graph (and its memory pool)."""
    _ROUND_GRAPHS.clear()


def run_rounds(make_round: Callable, key, ctx, carry, rounds: int,
               generator: torch.Generator | None,
               round_noise: torch.Tensor | None = None,
               early_exit: bool = False):
    """`rounds` rounds of `make_round(ctx)(carry, generator, noise)` as
    replays of one captured round, from a copy of `carry`; returns the last
    carry (fresh tensors).

    `ctx` is every tensor the round reads besides its carry (params, batch,
    plans, per-call inputs): it is copied into the graph's buffers once a
    call, so one graph serves every call of the same shapes. `key` holds
    the Python settings the round's code depends on. `round_noise` [rounds,
    ...] is copied in before each replay; otherwise the round draws its own
    noise from `generator`. With `early_exit`, the loop stops after the
    first round that sets the carry's last entry (the done flag).
    """
    noise0 = None if round_noise is None else round_noise[0]
    with tracing.span("graph.lookup"):
        sig = (make_round.__code__, key,
               tree_signature((ctx, carry, noise0)), generator is None)
        graph = _ROUND_GRAPHS.pop(sig, None)
        if graph is None:
            def one_round(static, gen):
                sctx, scarry, snoise = static
                out = make_round(sctx)(scarry, gen, snoise)
                for s, o in zip(tree_leaves(scarry), tree_leaves(out),
                                strict=True):
                    s.copy_(o)

            static = tree_map(torch.clone, (ctx, carry, noise0))
            graph = CapturedGraph(one_round, static, noise0.device
                                  if noise0 is not None else
                                  tree_leaves(carry)[0].device,
                                  with_generator=generator is not None)
            while len(_ROUND_GRAPHS) >= MAX_ROUND_GRAPHS:
                _ROUND_GRAPHS.popitem(last=False)
        _ROUND_GRAPHS[sig] = graph
    sctx, scarry, snoise = graph.static
    with tracing.span("graph.copy_in"):
        tree_copy_(sctx, ctx)
        tree_copy_(scarry, carry)
    with tracing.span("graph.replay") as sp, graph.drawing_from(generator):
        replays = 0
        for t in range(rounds):
            if snoise is not None:
                snoise.copy_(round_noise[t])
            graph.replay()
            replays += 1
            if early_exit and bool(scarry[-1]):
                break
        if sp:
            sp.set(replays=replays,
                   segsum_launches=replays * graph.segsum_launches)
    with tracing.span("graph.copy_out"):
        return tree_map(torch.clone, scarry)
