"""AdaBelief optimizer over an explicit params tree.

Counterpart of the TPU package's `train/adabelief.py`, with that package's
two non-standard features and their order:

- adaptive per-tensor gradient clipping by
  sqrt(sum(v) / (1 - beta2^t)) * clip_multiplier + clip_epsilon,
  applied before the moment updates;
- epsilon added into the belief accumulator every step, not just in the
  denominator;

plus RAdam-style rectification behind an SMA threshold gate. With
beta2 = 0.999 the gate opens at update 6 (the SMA reads about 4.996 at
t = 5); below it the rectification term is NaN and stays masked.

The update is functional: `update` returns new params and a new state and
leaves its arguments untouched. Step count, bias corrections and the
learning rate stay on the device in f32, so a step never waits for the
host; the per-tensor work runs through `torch._foreach_*` lists.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

Schedule = Callable[[torch.Tensor], torch.Tensor]


class AdaBeliefState(NamedTuple):
    count: torch.Tensor  # 0-d int32 step counter
    m: Any               # first moment, a tree like the params
    v: Any               # belief accumulator, a tree like the params


def cosine_decay_schedule(initial_lr: float = 1e-3,
                          decay_steps: int = 167_000,
                          alpha: float = 0.5) -> Schedule:
    """Keras CosineDecay semantics: the count is held at `decay_steps`."""
    def schedule(count):
        count = torch.as_tensor(count)
        step = torch.clamp(count, max=decay_steps).to(torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * step / decay_steps))
        decayed = (1 - alpha) * cosine + alpha
        return initial_lr * decayed
    return schedule


class AdaBelief:
    """`init(params)` -> state; `update(grads, state, params)` ->
    (new params, new state)."""

    def __init__(self, learning_rate: float | Schedule = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, rectify: bool = True,
                 sma_threshold: float = 5.0, clip_gradients: bool = True,
                 clip_multiplier: float = 3.0, clip_epsilon: float = 1e-2):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.rectify = rectify
        self.sma_threshold = sma_threshold
        self.clip_gradients = clip_gradients
        self.clip_multiplier = clip_multiplier
        self.clip_epsilon = clip_epsilon

    def init(self, params: Any) -> AdaBeliefState:
        leaves = pytree.tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        return AdaBeliefState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            m=pytree.tree_map(torch.zeros_like, params),
            v=pytree.tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdaBeliefState, params: Any
               ) -> tuple[Any, AdaBeliefState]:
        b1, b2, eps = self.b1, self.b2, self.eps
        p, spec = pytree.tree_flatten(params)
        g = pytree.tree_leaves(grads)
        m = pytree.tree_leaves(state.m)
        v = pytree.tree_leaves(state.v)

        count = state.count + 1
        t = count.to(torch.float32)
        # device constants by fill, not by a host copy: a step may be
        # captured in a CUDA graph
        b1p = torch.pow(torch.full((), b1, device=t.device), t)
        b2p = torch.pow(torch.full((), b2, device=t.device), t)

        if self.clip_gradients:
            # v >= 0, so its 1-norm is its sum
            v_sum = torch.stack(torch._foreach_norm(v, 1))
            norm = torch.stack(torch._foreach_norm(g, 2))
            clip_val = torch.sqrt(v_sum / (1.0 - b2p)) * \
                self.clip_multiplier + self.clip_epsilon
            scale = torch.where(norm > clip_val,
                                clip_val / torch.clamp(norm, min=1e-30), 1.0)
            g = torch._foreach_mul(g, list(scale.unbind(0)))

        new_m = torch._foreach_mul(m, b1)
        torch._foreach_add_(new_m, torch._foreach_mul(g, 1 - b1))
        # belief: deviation of the gradient from its running mean, with eps
        # folded into the accumulator each step
        dev2 = torch._foreach_sub(g, new_m)
        torch._foreach_mul_(dev2, dev2)
        torch._foreach_mul_(dev2, 1 - b2)
        new_v = torch._foreach_mul(v, b2)
        torch._foreach_add_(new_v, dev2)
        torch._foreach_add_(new_v, eps)

        m_corr = torch._foreach_div(new_m, 1 - b1p)
        v_corr = torch._foreach_div(new_v, 1 - b2p)
        torch._foreach_sqrt_(v_corr)
        torch._foreach_add_(v_corr, eps)

        if self.rectify:
            sma_inf = 2.0 / (1.0 - b2) - 1.0
            sma_t = sma_inf - 2.0 * t * b2p / (1.0 - b2p)
            r_t = torch.sqrt((sma_t - 4.0) / (sma_inf - 4.0) *
                             (sma_t - 2.0) / (sma_inf - 2.0) * sma_inf / sma_t)
            gate = sma_t >= self.sma_threshold
            # r_t is NaN below the gate: `where` keeps it out of the update
            r_open = torch.where(gate, r_t, torch.zeros_like(r_t))
            shut = (~gate).to(torch.float32)
            step = torch._foreach_mul(m_corr, r_open)
            torch._foreach_div_(step, v_corr)
            torch._foreach_add_(step, torch._foreach_mul(m_corr, shut))
        else:
            step = torch._foreach_div(m_corr, v_corr)
        if self.weight_decay > 0:
            torch._foreach_add_(step, torch._foreach_mul(p, self.weight_decay))

        lr = self.learning_rate(count) if callable(self.learning_rate) \
            else self.learning_rate
        new_p = torch._foreach_add(p, torch._foreach_mul(step, -lr))
        unflat = lambda leaves: pytree.tree_unflatten(leaves, spec)  # noqa: E731
        return unflat(list(new_p)), AdaBeliefState(
            count=count, m=unflat(list(new_m)), v=unflat(list(new_v)))


adabelief = AdaBelief  # the TPU package's constructor name


class GradientAccumulator:
    """Average gradients over `every` calls and apply the inner update on
    the boundary; between boundaries the params come back unchanged. The
    mini-step counter is deterministic, so it lives on the host."""

    def __init__(self, inner: AdaBelief, every: int):
        self.inner, self.every = inner, int(every)

    def init(self, params: Any):
        return (0, pytree.tree_map(torch.zeros_like, params),
                self.inner.init(params))

    @torch.no_grad()
    def update(self, grads: Any, state, params: Any):
        mini, acc, inner_state = state
        acc_l, spec = pytree.tree_flatten(acc)
        g = pytree.tree_leaves(grads)
        # running mean: acc + (g - acc) / (mini + 1)
        delta = torch._foreach_sub(g, acc_l)
        acc_l = torch._foreach_add(acc_l, torch._foreach_div(delta, mini + 1))
        acc = pytree.tree_unflatten(list(acc_l), spec)
        if mini + 1 < self.every:
            return params, (mini + 1, acc, inner_state)
        params, inner_state = self.inner.update(acc, inner_state, params)
        return params, (0, pytree.tree_map(torch.zeros_like, acc),
                        inner_state)


gradient_accumulator = GradientAccumulator
