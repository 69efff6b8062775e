"""Planned literal-clause SpMM pair on a hand-written CUDA kernel.

Counterpart of the TPU package's `ops/pallas_segsum.py`. The TPU kernel
(`_segsum_kernel`, a one-hot matmul per tile with overlapping output
windows) is replaced by `csrc/segsum.cu`: a fused gather and sorted
segmented sum over a CSR plan, each output row written once by the lanes
that own it, its rows added in plan order, no atomics.

- `build_segsum_plan` / `build_batch_plans`: host-side (numpy) CSR plans,
  one per direction, with masked edges dropped. They have no tile or
  window limit, so there is no degenerate plan and no fallback. With
  `pad=True` every plan's `gather` is padded to the bucket's edge capacity
  (`row_ptr` already has the bucket's length, and its last entry stays the
  real edge count, so the kernel never reads the padding): the plans of
  all batches of a bucket then have one shape, and one CUDA graph serves
  them all.
- `gather_segsum`: the kernel's wrapper. It launches the kernel for CUDA
  tensors, runs `segsum_plain` for CPU tensors, and raises on anything
  else. `LAUNCHES` counts kernel launches per direction: the
  `segsum.launches` family of `tracing.py`'s counters.
- `plan_lit_to_clause` / `plan_clause_to_lit`: the differentiable pair the
  model and the losses call; each one's backward is the other direction,
  launched through the same kernel (and counted in `LAUNCHES` under the
  direction it launches). Given a `TiledIncidence` (ops/tiled_ops.py)
  instead of `BatchPlans`, they run the tiled pair, so one `plans=`
  argument serves both layouts. The backward goes through the same
  autograd Function, so the pair is twice differentiable on the card too.
- `aggregations`: the pair a model calls, planned or plain as it was
  handed plans or not.
- `plan_edge_to_lit`: the sum of per-edge rows (clause-ordered, one row
  per incidence edge) into their literals, as graph attention weights
  them; its backward, `lit_to_edge`, hands each edge its literal's row.
  `BatchPlans` carries both plans beside the pair when they were asked
  for (`build_batch_plans(..., edges=True)`), counted under their own
  names.
- `build_anf_plans` and `plan_node_to_clause` / `plan_clause_to_node` /
  `plan_and_to_var`: the same kernel over an ANF batch's membership edges
  (clauses x the 1 + V + A value nodes) and over the scatter of the AND
  nodes' values to their two operand variables. Their launches are counted
  under their own names, apart from the CNF directions.

The kernel is compiled from the package's sources with nvcc at first use,
into `_build/` beside this package, and bound with ctypes
(`build_library`, which also builds another version of the source to
time beside it).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from diffusionsat_torch import tracing
from diffusionsat_torch.ops.graph_ops import (
    clause_to_lit,
    gather_rows,
    lit_to_clause,
)
from diffusionsat_torch.ops.tiled_ops import (
    TiledIncidence,
    tiled_clause_to_lit,
    tiled_lit_to_clause,
)

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "segsum.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# plan directions: the CNF literal-clause pair, and the ANF membership pair
# with the AND -> operand-variable scatter and its transpose
CNF_DIRECTIONS = ("lit_to_clause", "clause_to_lit")
EDGE_DIRECTIONS = ("edge_to_lit", "lit_to_edge")
ANF_DIRECTIONS = ("node_to_clause", "clause_to_node", "and_to_var",
                  "var_to_and")

# kernel launches per plan direction; callers reset and read these to show
# that a run went through the kernel. The CNF directions are always listed;
# any other direction is listed from its first launch after a reset
LAUNCH_FAMILY = "segsum.launches"
LAUNCHES: dict[str, int] = tracing.family(LAUNCH_FAMILY, CNF_DIRECTIONS)


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    LAUNCHES.update(dict.fromkeys(CNF_DIRECTIONS, 0))


# ---------------------------------------------------------------------------
# Build and bind


@dataclasses.dataclass
class _Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build of the source was reused
    build_log: str


_library: _Library | None = None
_library_lock = threading.Lock()


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the segsum kernel")
    return nvcc


def build_library(source: Path | None = None) -> _Library:
    """Compile `csrc/segsum.cu` (once per process, and once per source
    version on disk) and bind its C interface. `source` names another
    file with the same interface (an earlier version of the kernel, to
    time beside it): built and bound on each call, never used by the
    wrappers below."""
    global _library
    if source is not None:
        return _build(Path(source))
    with _library_lock:
        if _library is None:
            _library = _build(SOURCE)
        return _library


def _build(source: Path) -> _Library:
    src = source.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libsegsum_{tag[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)  # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(so))
    fn = lib.dsat_gather_segsum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dsat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dsat_cuda_error_string.restype = ctypes.c_char_p
    return _Library(lib=lib, path=so, build_seconds=seconds, build_log=log)


# ---------------------------------------------------------------------------
# Plans


@dataclasses.dataclass
class SegsumPlan:
    """CSR plan of one SpMM direction: segment s sums source rows
    `gather[row_ptr[s]:row_ptr[s+1]]`, in that order."""
    name: str
    row_ptr: torch.Tensor  # [M+1] int32, row_ptr[0] = 0, non-decreasing
    gather: torch.Tensor   # [nnz] int32 source row per edge, in [0, N)
    num_sources: int       # N: rows of the input

    @property
    def num_segments(self) -> int:
        return self.row_ptr.shape[0] - 1

    def to(self, device: str | torch.device) -> "SegsumPlan":
        return dataclasses.replace(self, row_ptr=self.row_ptr.to(device),
                                   gather=self.gather.to(device))

    def padded(self, capacity: int) -> "SegsumPlan":
        """The plan with `gather` padded with source row 0 to `capacity`
        entries; the padding lies past `row_ptr[-1]`, so no sum reads it."""
        n = self.gather.shape[0]
        if n > capacity:
            raise ValueError(f"{self.name}: {n} edges exceed the capacity "
                             f"{capacity}")
        return dataclasses.replace(self, gather=torch.cat(
            [self.gather, self.gather.new_zeros(capacity - n)]))


def build_segsum_plan(name: str, seg_ids: np.ndarray, src_ids: np.ndarray,
                      mask: np.ndarray, num_segments: int,
                      num_sources: int) -> SegsumPlan:
    """CSR plan from per-edge segment ids (sorted ascending), source rows
    and validity mask. Edges with mask 0 are dropped; the order of the
    valid edges inside a segment is kept."""
    seg_ids = np.asarray(seg_ids, dtype=np.int64)
    src_ids = np.asarray(src_ids, dtype=np.int64)
    valid = np.asarray(mask) > 0
    seg, src = seg_ids[valid], src_ids[valid]
    if np.any(np.diff(seg) < 0):
        raise ValueError(f"{name}: segment ids must be sorted ascending")
    if seg.size and (seg[0] < 0 or seg[-1] >= num_segments):
        raise ValueError(f"{name}: segment id out of [0, {num_segments})")
    if src.size and (src.min() < 0 or src.max() >= num_sources):
        raise ValueError(f"{name}: source row out of [0, {num_sources})")
    if seg.size >= 2 ** 31:
        raise ValueError(f"{name}: {seg.size} edges overflow int32")
    counts = np.bincount(seg, minlength=num_segments)
    row_ptr = np.zeros(num_segments + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return SegsumPlan(name=name, row_ptr=torch.from_numpy(row_ptr),
                      gather=torch.from_numpy(src.astype(np.int32)),
                      num_sources=int(num_sources))


@dataclasses.dataclass
class BatchPlans:
    """The two directions of one batch's literal-clause incidence, and the
    sum of per-edge rows into literals with its transpose."""
    lit_to_clause: SegsumPlan   # segments: C clauses, sources: 2V literals
    clause_to_lit: SegsumPlan   # segments: 2V literals, sources: C clauses
    # segments: 2V literals, sources: E edges; and its transpose. Set by
    # `build_batch_plans(..., edges=True)`, else left out
    edge_to_lit: SegsumPlan | None = None
    lit_to_edge: SegsumPlan | None = None

    def to(self, device: str | torch.device) -> "BatchPlans":
        return BatchPlans(*(None if p is None else p.to(device) for p in (
            getattr(self, f.name) for f in dataclasses.fields(self))))


def build_batch_plans(batch, pad: bool = False,
                      edges: bool = False) -> BatchPlans:
    """Build the CSR plans of a SatBatch on the host (CPU tensors); with
    `pad`, each padded to the batch's edge capacity; with `edges`, the edge
    plans too (only graph attention reads them).

    The edge plans read edge rows in the clause-sorted order: `edge_to_lit`
    walks each literal's edges in the literal-sorted order (`edge_perm_l`
    maps them to their clause-sorted rows), and `lit_to_edge` gives every
    real edge a segment of its own holding its literal."""
    a = lambda t: t.detach().cpu().numpy()  # noqa: E731
    V2, C, E = 2 * batch.V, batch.C, batch.E
    plans = [build_segsum_plan("lit_to_clause", a(batch.edge_clause_c),
                               a(batch.edge_lit_c), a(batch.edge_mask_c),
                               num_segments=C, num_sources=V2),
             build_segsum_plan("clause_to_lit", a(batch.edge_lit_l),
                               a(batch.edge_clause_l), a(batch.edge_mask_l),
                               num_segments=V2, num_sources=C)]
    if edges:
        plans += [build_segsum_plan("edge_to_lit", a(batch.edge_lit_l),
                                    a(batch.edge_perm_l),
                                    a(batch.edge_mask_l), num_segments=V2,
                                    num_sources=E),
                  build_segsum_plan("lit_to_edge", np.arange(E),
                                    a(batch.edge_lit_c),
                                    a(batch.edge_mask_c), num_segments=E,
                                    num_sources=V2)]
    if pad:
        plans = [p.padded(E) for p in plans]
    return BatchPlans(*plans)


@dataclasses.dataclass
class ANFPlans:
    """The kernel's plans over one ANFBatch.

    The constant-one node (node 0) is a member of every equation with a
    constant term, thousands in a 17-round SHA-1 batch: in the membership
    incidence it is a dense column. A warp summing that one segment walks
    its edges one after another (about 200 us at F = 64 on an H100, 40x
    the whole direction's bound), and a sum of thousands of f32 terms has
    no order that two routes share to 1e-5. So the plans hold the sparse
    part, without node 0's edges, and `const_count` holds the column: the
    node -> clause sum adds `const_count * x[0]` (a rank-1 update) and the
    clause -> node sum gets its row 0 as `const_count @ y` (a reduction),
    both dense library products outside the kernel.
    """
    node_to_clause: SegsumPlan  # segments: C clauses, sources: 1+V+A nodes
    clause_to_node: SegsumPlan  # segments: 1+V+A nodes, sources: C clauses
    and_to_var: SegsumPlan      # segments: V vars, sources: A AND nodes
    var_to_and: SegsumPlan      # segments: A AND nodes, sources: V vars
    const_count: torch.Tensor   # [C] f32: node 0's edges into each clause

    def to(self, device: str | torch.device) -> "ANFPlans":
        return ANFPlans(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))


def build_anf_plans(batch, pad: bool = False) -> ANFPlans:
    """Build the kernel's plans of an ANFBatch on the host (CPU tensors):
    both membership directions over the masked edges of the nodes other
    than the constant one (whose edges are counted per clause instead),
    and the scatter of each real AND node's value to its two operand
    variables (`and1 - 1`, `and2 - 1`, clamped at 0 as the model clamps
    them) with its transpose, which gathers and adds the two operands'
    rows. With `pad`, the membership plans are padded to the batch's edge
    capacity and the scatter plans to two edges per AND slot."""
    a = lambda t: t.detach().cpu().numpy()  # noqa: E731
    n_nodes, C, V, A = batch.n_value_nodes, batch.C, batch.V, batch.A
    node_c, clause_c = a(batch.edge_node_c), a(batch.edge_clause_c)
    node_n, clause_n = a(batch.edge_node_n), a(batch.edge_clause_n)
    mask_c = (a(batch.edge_mask_c) > 0) & (node_c != 0)
    mask_n = (a(batch.edge_mask_n) > 0) & (node_n != 0)
    const = (a(batch.edge_mask_c) > 0) & (node_c == 0)
    const_count = np.bincount(clause_c[const], minlength=C).astype(
        np.float32)
    n2c = build_segsum_plan("node_to_clause", clause_c, node_c, mask_c,
                            num_segments=C, num_sources=n_nodes)
    c2n = build_segsum_plan("clause_to_node", node_n, clause_n, mask_n,
                            num_segments=n_nodes, num_sources=C)
    valid = np.flatnonzero(a(batch.and_mask) > 0)
    ops = np.concatenate([np.maximum(a(batch.and1)[valid] - 1, 0),
                          np.maximum(a(batch.and2)[valid] - 1, 0)])
    ands = np.concatenate([valid, valid])
    ones = np.ones_like(ops)
    by_var = np.argsort(ops, kind="stable")
    by_and = np.argsort(ands, kind="stable")
    a2v = build_segsum_plan("and_to_var", ops[by_var], ands[by_var], ones,
                            num_segments=V, num_sources=A)
    v2a = build_segsum_plan("var_to_and", ands[by_and], ops[by_and], ones,
                            num_segments=A, num_sources=V)
    if pad:
        n2c, c2n = n2c.padded(batch.E), c2n.padded(batch.E)
        a2v, v2a = a2v.padded(2 * A), v2a.padded(2 * A)
    return ANFPlans(node_to_clause=n2c, clause_to_node=c2n, and_to_var=a2v,
                    var_to_and=v2a,
                    const_count=torch.from_numpy(const_count))


# ---------------------------------------------------------------------------
# Kernel wrapper and its plain version


def segsum_plain(x: torch.Tensor, plan: SegsumPlan) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `index_select` of the source
    rows, then a sum of each segment's rows in plan order over the CSR
    offsets (`torch.segment_reduce`): one fixed order on the CPU and on the
    card, so two runs agree bit for bit. Padding past `row_ptr[-1]` is
    gathered and not summed."""
    return torch.segment_reduce(gather_rows(x, plan.gather), "sum",
                                offsets=plan.row_ptr, axis=0, unsafe=True)


def _check(x: torch.Tensor, plan: SegsumPlan) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"gather_segsum takes float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != plan.num_sources:
        raise ValueError(f"{plan.name}: x must be [{plan.num_sources}, F], "
                         f"got {tuple(x.shape)}")
    if x.shape[1] > 0 and x.stride(1) != 1:
        raise ValueError(f"{plan.name}: x needs unit column stride")
    for t, what in ((plan.row_ptr, "row_ptr"), (plan.gather, "gather")):
        if t.device != x.device:
            raise ValueError(f"{plan.name}: {what} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{plan.name}: {what} must be contiguous 1-D "
                             "int32")


def gather_segsum(x: torch.Tensor, plan: SegsumPlan) -> torch.Tensor:
    """out[s] = sum over e in segment s of x[gather[e]]: [N, F] -> [M, F].

    CUDA tensors go through the hand-written kernel, CPU tensors through
    `segsum_plain`; any other device raises."""
    _check(x, plan)
    if x.device.type == "cpu":
        return segsum_plain(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"gather_segsum: unsupported device {x.device}")
    M, F = plan.num_segments, x.shape[1]
    out = torch.empty((M, F), dtype=torch.float32, device=x.device)
    if M == 0 or F == 0:
        return out
    lib = build_library().lib
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.dsat_gather_segsum(x.data_ptr(), x.stride(0),
                                plan.row_ptr.data_ptr(),
                                plan.gather.data_ptr(), out.data_ptr(),
                                M, F, stream)
    if rc != 0:
        msg = lib.dsat_cuda_error_string(rc).decode()
        raise RuntimeError(f"segsum kernel launch failed ({rc}): {msg}")
    LAUNCHES[plan.name] = LAUNCHES.get(plan.name, 0) + 1
    return out


class _PlannedSpMM(torch.autograd.Function):
    """One planned direction; the backward is the other direction, applied
    through this Function again, so that a gradient of the gradient (a
    backward with `create_graph=True`) runs the kernel too and carries its
    autograd history."""

    @staticmethod
    def forward(ctx, x, fwd: SegsumPlan, bwd: SegsumPlan):
        ctx.fwd, ctx.bwd = fwd, bwd
        return gather_segsum(x, fwd)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        # autograd hands over expanded or sliced cotangents; the kernel
        # reads rows of any stride but needs unit column stride
        if grad.shape[1] > 0 and grad.stride(1) != 1:
            grad = grad.contiguous()
        return _PlannedSpMM.apply(grad, ctx.bwd, ctx.fwd), None, None


def plan_lit_to_clause(x: torch.Tensor,
                       plans: BatchPlans | TiledIncidence) -> torch.Tensor:
    """lit->clause SpMM [2V, F] -> [C, F] through the kernel, or through
    the tile products when `plans` is a TiledIncidence."""
    if isinstance(plans, TiledIncidence):
        return tiled_lit_to_clause(x, plans)
    return _PlannedSpMM.apply(x, plans.lit_to_clause, plans.clause_to_lit)


def plan_clause_to_lit(x: torch.Tensor,
                       plans: BatchPlans | TiledIncidence) -> torch.Tensor:
    """clause->lit SpMM [C, F] -> [2V, F] through the kernel, or through
    the tile products when `plans` is a TiledIncidence."""
    if isinstance(plans, TiledIncidence):
        return tiled_clause_to_lit(x, plans)
    return _PlannedSpMM.apply(x, plans.clause_to_lit, plans.lit_to_clause)


def aggregations(batch, plans: BatchPlans | TiledIncidence | None):
    """(lit->clause, clause->lit) sums of `batch`: the planned pair with
    `plans`, else the plain gather and segment sums of `ops/graph_ops.py`."""
    if plans is not None:
        return (lambda x: plan_lit_to_clause(x, plans),
                lambda x: plan_clause_to_lit(x, plans))
    return (lambda x: lit_to_clause(batch, x),
            lambda x: clause_to_lit(batch, x))


def plan_edge_to_lit(x: torch.Tensor, plans: BatchPlans) -> torch.Tensor:
    """Per-edge rows [E, F], in the clause-sorted edge order, summed into
    their literals: [E, F] -> [2V, F] through the kernel (masked edges
    add nothing). Its backward gives each edge its literal's row."""
    if not isinstance(plans, BatchPlans) or plans.edge_to_lit is None:
        raise TypeError("plan_edge_to_lit needs the edge plans of "
                        "`build_batch_plans(..., edges=True)`")
    return _PlannedSpMM.apply(x, plans.edge_to_lit, plans.lit_to_edge)


def plan_node_to_clause(x: torch.Tensor, plans: ANFPlans) -> torch.Tensor:
    """ANF node->clause membership sum [1+V+A, F] -> [C, F]: the kernel over
    the sparse members, plus the constant node's row times its count."""
    out = _PlannedSpMM.apply(x, plans.node_to_clause, plans.clause_to_node)
    # in place: the autograd pair keeps no reference to its output
    return out.addmm_(plans.const_count[:, None], x[:1])


def plan_clause_to_node(x: torch.Tensor, plans: ANFPlans) -> torch.Tensor:
    """ANF clause->node membership sum [C, F] -> [1+V+A, F]: the kernel for
    every node but the constant one, whose row (empty in the plan) is the
    count-weighted sum of the clause rows."""
    out = _PlannedSpMM.apply(x, plans.clause_to_node, plans.node_to_clause)
    out[:1] = torch.mm(plans.const_count[None, :], x)
    return out


def plan_and_to_var(x: torch.Tensor, plans: ANFPlans) -> torch.Tensor:
    """Each AND node's row [A, F] added to both of its operand variables:
    [A, F] -> [V, F] through the kernel (padding AND nodes add nothing)."""
    return _PlannedSpMM.apply(x, plans.and_to_var, plans.var_to_and)
