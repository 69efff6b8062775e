"""Products of an f32 operand with a bf16 one on bf16 tensor cores, exact
in each product and summed in f32: the backward of `ops/lowp.py`.

Replaces no TPU kernel. The TPU package's transpose rule multiplies the
f32 cotangent of a bf16 product with the bf16 operand in f32 and leaves
the product to its compiler. A card has no f32 tensor-core product (TF32
keeps 10 mantissa bits, and the port keeps it off), and the library's f32
GEMM runs on the SIMT cores at 67 TFLOP/s; before this kernel the port
also wrote an f32 copy of the bf16 operand for it.

`split_mm(a, b, out_dtype)`: `a @ b`, one operand f32 and the other
bf16, 2-d or batched 3-d, through `csrc/split_mm.cu` (compiled with nvcc
at first use into `_build/` and bound with ctypes, as `ops/segsum.py`
binds its kernel). The kernel reads both operands as they lie in device
memory (any strides, so a transpose is a view). In registers it cuts each
f32 value `g` into three bf16 parts: `hi = g` with the low 16 bits of its
pattern cleared, `mid` the same of `g - hi`, `lo = g - hi - mid`. Both
subtractions are exact, and `lo` has at most 8 significant bits, so
`hi + mid + lo == g` for every finite f32 outside the subnormal range
(truncation never rounds up past the largest bf16, so the largest f32
values split too). Each part times a bf16 value is exact in f32, so three
tensor-core products into one f32 accumulator give the f32 product, its
terms summed in another order. The epilogue writes `out_dtype` (bf16 for
an operand's gradient, which drops the separate cast).

The bound on the card: the operands read once and the output written
once at 3.35 TB/s, or three times the bf16 multiply-adds at 989 TFLOP/s,
whichever is larger; the source says what the design does about it.

The kernel takes the f32 operand first, its rows along the output
(`a @ b` with `b` the f32 one runs as `(b^T a^T)^T`, written through a
transposed view of the output), so that each thread splits the f32 values
of its own fragment in registers. Block sizes come from the shape, never
from a timed search (`plan`): 64 rows, 32, 64 or 128 columns. Where the
output blocks fill fewer than two waves of the 132 SMs (a weight's
gradient: a few hundred by a few hundred, reduced over thousands of
rows), the reduction is cut into slices of 256 rows and more, up to 64:
each block writes its slice's f32 partial, and a second kernel sums the
slices in slice order and writes `out_dtype`. No atomics: one sum order
for one shape, so two launches on the same inputs agree bit for bit.

`split_mm_plain` is the plain version: the same three parts
(`split3`), three f32 products, summed in f32. CPU tensors take it;
CUDA tensors take the kernel, or raise on what it does not take.
`LAUNCHES` counts the kernel's launches (`product`, and `sum` for the
second pass of a cut reduction).
"""

import ctypes
import functools
import threading
from pathlib import Path

import torch

from diffusionsat_torch import tracing

LAUNCHES = tracing.family("split_mm.launches", ("product", "sum"))

# the card's SMs: a product whose output blocks fill fewer than two waves
# of them cuts its reduction into slices (`plan`)
SMS = 132
MIN_SLICE = 256   # reduction length a slice keeps at the least
MAX_SLICES = 64
BM, BK = 64, 32   # the kernel's block rows and reduction step

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "split_mm.cu"
_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """f32 `x` as three bf16 parts with `hi + mid + lo == x` exactly
    (finite values outside the subnormal range): each part the f32 value
    left so far with the low 16 bits of its pattern cleared."""
    if x.dtype != torch.float32:
        raise TypeError(f"split3 takes f32, got {x.dtype}")
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    rest = x - hi
    mid = (rest.view(torch.int32) & -65536).view(torch.float32)
    lo = rest - mid
    return (hi.to(torch.bfloat16), mid.to(torch.bfloat16),
            lo.to(torch.bfloat16))


def _operands(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype):
    """Checks what the kernel takes; returns which operand is f32 (0 or
    1)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"split_mm writes f32 or bf16, not {out_dtype}")
    pair = (a.dtype, b.dtype)
    if pair == (torch.float32, torch.bfloat16):
        wide = 0
    elif pair == (torch.bfloat16, torch.float32):
        wide = 1
    else:
        raise TypeError("split_mm takes one f32 and one bf16 operand, got "
                        f"{a.dtype} and {b.dtype}")
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError("split_mm takes two 2-d or two 3-d operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"split_mm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    if a.device != b.device:
        raise ValueError(f"split_mm: operands on {a.device} and {b.device}")
    return wide


def split_mm_plain(a: torch.Tensor, b: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: the f32 operand's three parts,
    each product in f32, summed hi + mid + lo in f32."""
    wide = _operands(a, b, out_dtype)
    if wide == 0:
        hi, mid, lo = (p.float() for p in split3(a))
        other = b.float()
        out = hi @ other + mid @ other + lo @ other
    else:
        hi, mid, lo = (p.float() for p in split3(b))
        other = a.float()
        out = other @ hi + other @ mid + other @ lo
    return out.to(out_dtype)


def _columns(n: int) -> int:
    """A block's columns for an output n wide: 32 or 64 where that holds
    it, past that 64 or 128, whichever pads less (128 on a tie)."""
    if n <= 64:
        return 32 if n <= 32 else 64
    return 64 if -n % 64 < -n % 128 else 128


@functools.lru_cache(maxsize=None)
def plan(batch: int, m: int, n: int, k: int) -> dict:
    """The kernel's blocks and reduction slices for [batch, m, k] @
    [batch, k, n], the f32 operand first: chosen from the shape alone.
    Where the blocks fill under two waves of the SMs, the reduction is cut
    into slices of 256 and more, up to two waves."""
    bn = _columns(n)
    blocks = batch * -(-m // BM) * -(-n // bn)
    slices = 1
    if blocks < 2 * SMS:
        slices = max(1, min(MAX_SLICES, -(-2 * SMS // blocks),
                            k // MIN_SLICE))
    # each slice a whole number of BK steps
    k_slice = -(-k // slices)
    k_slice = -(-k_slice // BK) * BK
    slices = -(-k // k_slice) if k else 1
    return dict(BM=BM, BN=bn, BK=BK, slices=slices, k_slice=k_slice)


def _library() -> ctypes.CDLL:
    """`csrc/split_mm.cu`, compiled at first use and bound."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            # imported here: ops/segsum.py imports this module's users
            from diffusionsat_torch.ops.segsum import compile_cuda
            so, _, _ = compile_cuda(SOURCE, "split_mm")
            lib = ctypes.CDLL(str(so))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.dsat_split_mm.argtypes = [p, p, p] + [i] * 13 + \
                [i64] * 4 + [i, p]
            lib.dsat_split_mm.restype = i
            lib.dsat_sum_slices.argtypes = [p, p, i64, i, i, p]
            lib.dsat_sum_slices.restype = i
            lib.dsat_split_mm_error_string.argtypes = [i]
            lib.dsat_split_mm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dsat_split_mm_error_string(rc).decode()
        raise RuntimeError(f"split_mm: {what} launch failed ({rc}): {msg}")


def split_mm(a: torch.Tensor, b: torch.Tensor,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`a @ b` of one f32 and one bf16 operand ([m, k] @ [k, n], or
    [batch, m, k] @ [batch, k, n]) in `out_dtype` (f32 or bf16): the f32
    product, its terms summed in another order. The kernel for CUDA
    tensors, the plain version for CPU tensors; anything else raises."""
    wide = _operands(a, b, out_dtype)
    if a.device.type == "cpu":
        return split_mm_plain(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"split_mm runs on CUDA or the CPU, not {a.device}")
    # [batch, rows, depth] shapes and strides of the kernel's operands, the
    # f32 one first (a batch of one matrix has batch stride 0)
    flat = a.dim() == 2
    sa, sb = a.stride(), b.stride()
    if flat:
        batch, (m, k), n = 1, a.shape, b.shape[1]
        sa, sb = (0,) + sa, (0,) + sb
    else:
        (batch, m, k), n = a.shape, b.shape[2]
        if batch == 1:
            sa, sb = (0,) + sa[1:], (0,) + sb[1:]
    for shape, st in ((a.shape, sa), (b.shape, sb)):
        reach = sum((size - 1) * abs(x) for size, x in
                    zip(shape[-2:], st[-2:])) + (batch - 1) * abs(st[0])
        if reach >= 2 ** 31:
            raise ValueError("split_mm indexes its operands with 32 bits: "
                             f"an operand reaching {reach} elements is too "
                             "large")
    if batch * m * n * MAX_SLICES >= 2 ** 31:
        raise ValueError("split_mm indexes with 32 bits: the output "
                         f"[{batch}, {m}, {n}] is too large")
    shape = (m, n) if flat else (batch, m, n)
    out = torch.empty(shape, dtype=out_dtype, device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    # the output's strides, contiguous
    sc = (m * n if batch > 1 else 0, n, 1)
    if wide == 0:
        pa, pb = a, b
    else:
        # the kernel takes the f32 operand first: out^T = b^T a^T, written
        # through the transposed view of out
        pa, pb = b, a
        sa, sb = (sb[0], sb[2], sb[1]), (sa[0], sa[2], sa[1])
        sc = (sc[0], 1, n)
        m, n = n, m
    p = plan(batch, m, n, k)
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    slices = p["slices"]
    bf16_out = out_dtype == torch.bfloat16
    dest = out if slices == 1 else torch.empty(
        (slices,) + shape, dtype=torch.float32, device=a.device)
    _check(lib, lib.dsat_split_mm(
        pa.data_ptr(), pb.data_ptr(), dest.data_ptr(), batch, m, n, k,
        p["k_slice"], slices, p["BN"], *sa, *sb, out.numel(), *sc,
        int(bf16_out and slices == 1), stream), "product")
    LAUNCHES["product"] += 1
    if slices > 1:
        _check(lib, lib.dsat_sum_slices(dest.data_ptr(), out.data_ptr(),
                                        out.numel(), slices, int(bf16_out),
                                        stream), "slice sum")
        LAUNCHES["sum"] += 1
    return out
