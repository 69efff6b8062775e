"""Differentiable collectives over a `torch.distributed` process group.

The TPU package's sharded code calls XLA collectives inside `shard_map`
(`psum`, `pmin`, `all_to_all`), and differentiates them. Here each one
is a `torch.autograd.Function` whose backward is its true transpose:

- `all_reduce_sum`: y = sum over the group of x, on every rank; its
  transpose sums the cotangents the same way (`psum` there);
- `all_to_all`: block t of x goes to rank t, which holds it as block
  `me`; the transpose sends every cotangent block back where its value
  came from, which is again `all_to_all` (`lax.all_to_all` there);
- `all_reduce_min`: the group's elementwise minimum, without a gradient
  (`pmin` there, on a rounded SAT indicator);
- `gather_to_root`: every rank's tensor on the group's first rank, without
  a gradient;
- `sum_bucket`: a list of tensors summed over the group with one
  all-reduce of one flattened bucket (the gradients of a step);
- `balance_copies`: the identity on a tensor every rank holds a copy of,
  whose backward gives every copy the mean of the copies' cotangents.

Why `balance_copies`. A sharded step differentiates the replicated loss
on every rank, so a replicated tensor's cotangent is split among its
copies, each rank's share holding what its own clauses sent back. The
split is exact, the gradient reads only the copies' sum, but through a
recurrent model's rounds the copies' shares can grow apart by orders of
magnitude while their sum stays of order one, and the f32 rounding of
the large shares then swamps the sum (a 32-round QuerySAT step read
gradients 1e11 times too large). Averaging the cotangents of the
recurrent state over the copies each round keeps the sum and keeps the
shares equal.

NCCL runs the collectives on CUDA tensors. gloo runs them on host
tensors: a gloo group that holds CUDA tensors (ranks sharing one card)
has no CUDA `all_to_all`, so every collective here copies its CUDA input
to the host, exchanges there and copies the result back, explicitly.
`transport` names the route a group's collectives take: "nccl",
"gloo-host" or "gloo" (host tensors). A collective that fails raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def transport(group, device: torch.device) -> str:
    """The route the collectives take for tensors on `device`."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"unsupported backend {backend}")
    return "gloo-host" if torch.device(device).type == "cuda" else "gloo"


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    """The reduced copy of `x` (x itself is left as it was)."""
    if _staged(x, group):
        host = x.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(host, op=op, group=group)
        return host.to(x.device)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    if x.shape[0] != group_size(group):
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not the "
                         f"group size {group_size(group)}")
    if _staged(x, group):
        host = x.detach().to("cpu", copy=True).contiguous()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        return out.to(x.device)
    src = x.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, dist.ReduceOp.SUM), None


class _BalanceCopies(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, dist.ReduceOp.SUM) / \
            group_size(ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, on every rank; differentiable (the
    backward sums the cotangents over the group)."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def balance_copies(x: torch.Tensor, group) -> torch.Tensor:
    """`x` (a tensor every rank of the group holds the same copy of); the
    backward hands every copy the mean of the copies' cotangents, which
    leaves their sum as it was."""
    if group_size(group) == 1:
        return x
    return _BalanceCopies.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] with n the group size: block t goes to rank t, and block s
    of the result came from rank s. Differentiable (the backward is the
    same exchange of the cotangents)."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise minimum of `x` (no gradient)."""
    if group_size(group) == 1:
        return x
    return _all_reduce(x, group, dist.ReduceOp.MIN)


def gather_to_root(x: torch.Tensor, group) -> list[torch.Tensor] | None:
    """Every rank's `x` (all of one shape), in group-rank order, on the
    group's rank 0 (on x's device); None on the other ranks."""
    root = dist.get_global_rank(group, 0)
    me = dist.get_rank(group)
    src = x.detach().contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    bufs = [torch.empty_like(src) for _ in range(group_size(group))] \
        if me == 0 else None
    dist.gather(src, bufs, dst=root, group=group)
    if bufs is None:
        return None
    return [b.to(x.device) for b in bufs] if staged else bufs


def sum_bucket(tensors: list[torch.Tensor], group,
               scale: float = 1.0) -> list[torch.Tensor]:
    """Each tensor summed over the group and times `scale`, through one
    all-reduce of the tensors flattened into one bucket (no gradient).
    The tensors share one type and device."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if group_size(group) > 1:
        flat = _all_reduce(flat, group, dist.ReduceOp.SUM)
    if scale != 1.0:
        flat = flat * scale
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out
