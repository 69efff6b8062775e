"""Data-parallel training and sampling over the mesh's "data" groups.

Counterpart of the TPU package's `parallel/dp.py`. Each rank steps one
packed batch per step (a packed batch already holds hundreds of graphs, so
it is the natural unit). Parameters and optimizer state are replicated;
the gradients are averaged over the data group with one all-reduce of one
flattened bucket (the loss and the round count ride in it), and the
optimizer then runs identically on every rank, so the parameters stay
replicated without a broadcast.

- `stacked_stream`: the host grouping of same-shape batches into stacks of
  `n_devices`, the same groups, dropped remainders, message and shuffled
  order as the TPU package's;
- `make_dp_train_step`: the DP step of any model with the standard apply
  contract: the flat QuerySAT apply with the rank's kernel plans, the dense
  apply, or `anf_sat_apply` with `ANFPlans`. Each rank draws from a
  generator of its own, seeded from (the state's seed, rank, step): the
  counterpart of `fold_in(fold_in(key, device), step)`;
- `dp_chain`: the reverse-diffusion chain on each rank's batch with its own
  generator, the bits and solved flags gathered to the group's rank 0.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Callable, Iterator

import numpy as np
import torch
from torch.utils import _pytree as pytree

from diffusionsat_torch import cuda_graphs
from diffusionsat_torch.models.query_sat import query_sat_apply
from diffusionsat_torch.parallel.comm import (
    gather_to_root,
    group_size,
    sum_bucket,
)
from diffusionsat_torch.parallel.mesh import Mesh
from diffusionsat_torch.train.loop import (
    TrainState,
    _accepts_labels,
    _global_norm,
    _grad_leaves,
    _grads_of,
    _select_labels,
    _takes_plans,
    build_plans,
    stack_batches,
)


def stacked_stream(batches: list, n_devices: int, seed: int = 0,
                   take: Callable | None = None) -> Iterator:
    """Infinite stream of device-stacked groups of `n_devices` same-shape
    batches: stacked on the host in order of each shape's first
    appearance, a shape's remainder below `n_devices` dropped (and the
    count printed), each pass in a fresh `random.Random(seed)` order.
    `take`, if given, is applied to every group once, up front (a rank's
    row placed on its device, say), and the stream yields what it
    returned."""
    by_shape = defaultdict(list)
    for b in batches:
        shape = tuple(tuple(t.shape) for t in cuda_graphs.tree_leaves(b))
        by_shape[shape].append(b)
    groups = []
    dropped = 0
    for same in by_shape.values():
        for i in range(0, len(same) - n_devices + 1, n_devices):
            groups.append(stack_batches(same[i:i + n_devices]))
        dropped += len(same) % n_devices
    if not groups:
        raise ValueError(
            f"no shape group has >= {n_devices} batches to stack")
    if dropped:
        print(f"stacked_stream: {dropped}/{len(batches)} batches dropped "
              f"(shape-group remainders below n_devices={n_devices})")
    if take is not None:
        groups = [take(g) for g in groups]
    rng = random.Random(seed)
    while True:
        order = list(range(len(groups)))
        rng.shuffle(order)
        for i in order:
            yield groups[i]


def shard_stacked_batch(stacked, mesh: Mesh):
    """This rank's row of a stacked batch (or (batch, plans) pair), on its
    device: the data group's rank r takes row r."""
    return cuda_graphs.tree_map(lambda t: t.to(mesh.device),
                                cuda_graphs.index_tree(stacked,
                                                       mesh.data_index))


def rank_generator(seed: int, rank: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The generator a DP rank draws from at `step`, seeded from (seed,
    rank, step)."""
    mixed = np.random.SeedSequence([seed, rank, step]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(mixed) & (2 ** 63 - 1))
    return g


def make_dp_train_step(cfg, optimizer, mesh: Mesh,
                       apply_fn: Callable = query_sat_apply):
    """The DP train step over (state, batch, plans=None, **draws): `batch`
    is this rank's own (and `plans` its kernel plans, built here when the
    apply takes them and none are passed). `draws` (`labels`,
    `noise_scale`, `noisy_num`, `round_noise`) go to the apply in place of
    the rank's own draws. Returns (state, {"loss", "steps_taken",
    "gradnorm"}): the loss and the round count averaged over the data
    group, the norm of the averaged gradients.

    `state.generator` only seeds the ranks' generators (`rank_generator`
    of its initial seed, the rank and `state.step`); it is not advanced."""
    dev = mesh.device
    group = mesh.data_group
    n = group_size(group)
    with_labels = _accepts_labels(apply_fn)
    with_plans = _takes_plans(apply_fn)
    iso_alpha = float(getattr(cfg, "label_isolation_alpha", 0.0))

    def train_step(state: TrainState, batch, plans=None, **draws):
        if with_plans and plans is None:
            plans = build_plans(batch)
        batch = batch.to(dev)
        gen = rank_generator(state.generator.initial_seed(),
                             mesh.data_index, state.step, dev)
        kw = dict(draws)
        if with_labels and "labels" not in kw:
            # an ANF batch has no label bank
            kw["labels"] = _select_labels(batch, gen, iso_alpha) \
                if getattr(batch, "solutions_k", None) is not None \
                else batch.solutions
        if with_plans and plans is not None:
            kw["plans"] = plans.to(dev)
        params, leaves, spec = _grad_leaves(state.params)
        _, loss, steps, _ = apply_fn(params, cfg, batch, gen, training=True,
                                     device=dev, **kw)
        _, grad_list = _grads_of(loss, leaves, spec)
        *grad_list, loss, steps = sum_bucket(
            grad_list + [loss.detach(), steps.to(torch.float32)], group,
            scale=1.0 / n)
        grads = pytree.tree_unflatten(grad_list, spec)
        new_params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params)
        new_state = TrainState(params=new_params, opt_state=opt_state,
                               step=state.step + 1,
                               generator=state.generator)
        return new_state, {"loss": loss, "steps_taken": steps,
                           "gradnorm": _global_norm(grad_list)}

    return train_step


def dp_chain(chain: Callable, params, batch, generator: torch.Generator,
             mesh: Mesh, plans=None):
    """Run `chain` (diffusion/sampler.make_diffusion_chain's) on this
    rank's batch with its own generator; there is no exchange between the
    ranks until the end, where the bits [V] and solved flags [G] of every
    rank of the data group are gathered to its rank 0. Returns (bits [n, V],
    solved [n, G]) there and None on the other ranks."""
    bits, solved, _ = chain(params, batch, generator, plans=plans)
    all_bits = gather_to_root(bits, mesh.data_group)
    all_solved = gather_to_root(solved, mesh.data_group)
    if all_bits is None:
        return None
    return torch.stack(all_bits), torch.stack(all_solved)
