"""The device mesh over a `torch.distributed` world, and the rank launcher.

Counterpart of the TPU package's `parallel/mesh.py`. There a `Mesh` names
two axes of devices; here the world's ranks are laid out `[n_data,
n_graph]` (rank = d * n_graph + g) and each axis is a process group:

- "data": the ranks of one column (the same g), over which data
  parallelism averages gradients (`parallel/dp.py`);
- "graph": the ranks of one row (the same d), over which one formula's
  clauses are partitioned (`parallel/graph_partition.py`, `halo.py`).

Each rank drives one device: `cuda:<local rank>` under NCCL (one card a
rank), or the device the caller names under gloo (the CPU, or one card
that several ranks share).

`launch(fn, world, backend, devices, *args)` starts `world` ranks on this
host (spawned processes, a TCP rendezvous on a free port of 127.0.0.1),
runs `fn(mesh_ctx, *args)` in each and returns what each returned, in
rank order. The ranks import torch and this package only.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import socket
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException


@dataclasses.dataclass
class Mesh:
    """One rank's view of the `[n_data, n_graph]` layout of the world."""
    n_data: int
    n_graph: int
    rank: int
    data_group: Any    # this rank's column: the ranks with its graph index
    graph_group: Any   # this rank's row: the ranks with its data index
    device: torch.device

    @property
    def data_index(self) -> int:
        return self.rank // self.n_graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.n_graph


def rank_device(backend: str, device: str | torch.device | None = None,
                local_rank: int | None = None) -> torch.device:
    """The device of this rank: `cuda:<local rank>` under NCCL (which
    `device`, if given, must not contradict); the named device (the CPU
    by default) under gloo. A rank that is to run on a card and finds none
    raises."""
    if local_rank is None:
        local_rank = dist.get_rank() if dist.is_initialized() else 0
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL ranks need CUDA, which is not "
                               "available")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {local_rank} has no card of its own: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local_rank)
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"an NCCL rank runs on {dev}, not {device}")
        return dev
    if backend != "gloo":
        raise ValueError(f"unsupported backend {backend}")
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the ranks on the CPU")
    return dev


def make_mesh(n_data: int | None = None, n_graph: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """The mesh of the initialized world, `n_data` x `n_graph` ranks
    (`n_data` defaults to all the world's ranks over `n_graph`). Every rank
    must call it, with the same sizes: it creates one process group per
    row and per column."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_graph
    if n_data * n_graph != world:
        raise ValueError(f"mesh {n_data}x{n_graph} does not cover the "
                         f"{world} ranks")
    backend = dist.get_backend()
    rows = [dist.new_group([d * n_graph + g for g in range(n_graph)])
            for d in range(n_data)]
    cols = [dist.new_group([d * n_graph + g for d in range(n_data)])
            for g in range(n_graph)]
    return Mesh(n_data=n_data, n_graph=n_graph, rank=rank,
                data_group=cols[rank % n_graph],
                graph_group=rows[rank // n_graph],
                device=rank_device(backend, device, rank))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class RankContext:
    """What `launch` hands each rank's function."""
    rank: int
    world: int
    backend: str
    device: torch.device

    def mesh(self, n_data: int | None = None, n_graph: int = 1) -> Mesh:
        return make_mesh(n_data, n_graph, self.device)


def _rank_main(rank: int, payload: bytes, world: int, backend: str,
               devices: Sequence | None, port: int, results) -> None:
    fn, args = pickle.loads(payload)
    # a rank's host threads: the host's cores are shared by the world
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        name = None if devices is None else devices[rank]
        dev = rank_device(backend, name, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        ctx = RankContext(rank=rank, world=world, backend=backend,
                          device=dev)
        try:
            results.put((rank, True, pickle.dumps(fn(ctx, *args))))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
            raise
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, backend: str = "gloo",
           devices: Sequence | None = None, *args) -> list:
    """Run `fn(RankContext, *args)` on `world` spawned ranks of one host
    and return the ranks' results in rank order. `fn` and `args` are
    pickled by value (`fn` by import path; tensors with their bytes, not
    through shared memory), and so is each result: return host data.
    `devices` names each rank's device under gloo (default: the CPU);
    NCCL ranks take `cuda:<rank>`. A rank that raises makes the
    whole launch raise with its traceback; the other ranks are ended."""
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise SystemExit(f"{world} NCCL ranks need {world} cards, "
                         f"{torch.cuda.device_count()} visible")
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    mpctx = mp.get_context("spawn")
    results = mpctx.Queue()
    procs = mp.start_processes(
        _rank_main, args=(pickle.dumps((fn, args)), world, backend, devices,
                          free_port(), results),
        nprocs=world, join=False, start_method="spawn")
    got: dict[int, Any] = {}
    failures: list[str] = []
    try:
        done = False
        while not done:
            # drain before joining: a rank blocks on exit until what it
            # put is read
            try:
                while True:
                    rank, ok, value = results.get(timeout=0.05)
                    if ok:
                        got[rank] = pickle.loads(value)
                    else:
                        failures.append(f"rank {rank}:\n{value}")
            except queue.Empty:
                pass
            try:
                done = procs.join(timeout=0.05)
            except ProcessException as e:
                failures.append(str(e))
                break
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join(timeout=30)
    while not failures and len(got) < world:
        try:
            rank, ok, value = results.get(timeout=1.0)
        except queue.Empty:
            break
        if ok:
            got[rank] = pickle.loads(value)
        else:
            failures.append(f"rank {rank}:\n{value}")
    if failures:
        raise RuntimeError("a rank failed:\n" + "\n".join(failures))
    if len(got) != world:
        raise RuntimeError(f"{world - len(got)} ranks returned nothing")
    return [got[r] for r in range(world)]
