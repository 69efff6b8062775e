// Products of an f32 operand with a bf16 one on bf16 tensor cores (sm_90a),
// exact in each product and summed in f32:
//
//     c[b, m, n] = sum_k a[b, m, k] * b[b, k, n]     a f32, b bf16
//
// the backward of `ops/lowp.py`'s f32-accumulating products (the f32
// cotangent with a bf16 operand). Replaces no TPU kernel: the TPU package's
// transpose rule multiplies the f32 cotangent of a bf16 product with the
// bf16 operand in f32 and leaves the product to its compiler. The card has
// no f32 tensor-core product (TF32 keeps 10 mantissa bits, and the port
// keeps it off), and the library's f32 GEMM runs on the SIMT cores at 67
// TFLOP/s.
//
// The split. In registers each f32 value g is cut into three bf16 parts:
// hi = g with the low 16 bits of its pattern cleared, mid the same of
// g - hi, lo = g - hi - mid rounded to bf16. Both subtractions are exact,
// and lo has at most 8 significant bits, so hi + mid + lo == g for every
// finite f32 outside the subnormal range. Each part times a bf16 value is
// exact in f32, so three tensor-core products into one f32 accumulator give
// the f32 product, its terms summed in another order.
//
// Bound: the operands read once and the output written once at 3.35 TB/s,
// or three times the bf16 multiply-adds at 989 TFLOP/s, whichever is
// larger. At the dense train step's shapes the bytes bound every product
// but the widest layers' (chip_smoke phase 14 times each against it).
//
// Design:
//
// - A block of 128 threads (4 warps) owns 64 rows by BN columns of the
//   output (BN 32, 64 or 128, from the shape); a warp 16 rows by all BN
//   columns as m16n8k16 `mma.sync` tiles, so each f32 value is split once
//   a block. The reduction goes in steps of 32.
// - Any strides: each operand is loaded along whichever of its dimensions
//   has unit stride (coalesced), so a transposed view costs no copy; a
//   pair of adjacent depths is one load where the rows are aligned. The
//   next step's tiles are loaded into registers while the tensor cores
//   work on this step's tiles in shared memory (two buffers, one barrier a
//   step). The f32 tile is kept as f32 in shared memory; each thread reads
//   its fragment, splits it and feeds the three parts from registers.
//   (Three stages of `cp.async` for the f32 tile, two warps along the
//   columns, 128-row blocks, and `ldmatrix` for the bf16 fragments each
//   measured slower at these shapes.)
// - For each 16-deep step all of a warp's hi products are issued, then the
//   mid, then the lo ones, so no product waits on the one before it.
// - Where the output blocks would fill under two waves of the 132 SMs (a
//   weight's gradient: a few hundred by a few hundred, reduced over
//   thousands of rows), the reduction is cut into slices (`slices`,
//   `k_slice` from the host's plan): each block writes its slice's f32
//   partial, and `dsat_sum_slices` adds the slices in slice order and
//   writes the output type. No atomics: one sum order for one shape, so two
//   launches on the same inputs agree bit for bit.
// - The epilogue writes f32 or bf16 (round to nearest) through the output's
//   strides, so an operand's gradient is written in its type directly.

#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kBM = 64;
constexpr int kThreads = 128;  // a warp to 16 rows
constexpr int kBK = 32;
constexpr int kAStride = kBK + 8;  // floats a row of the f32 tile
constexpr int kBStride = kBK + 8;  // bf16 a column of the bf16 tile

struct Args {
  const float* a;
  const uint16_t* b;  // bf16 patterns
  void* c;
  int M, N, K, k_slice;
  // strides in elements; the operands' offsets fit 32 bits (the wrapper
  // checks), the output's need not
  int s_ab, s_am, s_ak, s_bb, s_bk, s_bn;
  int64_t s_cs, s_cb, s_cm, s_cn;
  bool out_bf16;
  bool a_pair, b_pair;  // a pair of depths is one aligned load
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent f32 values as three packed pairs of bf16 parts (the lower
// column in the low half), hi + mid + lo == x exactly
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  const float r0 = x0 - __uint_as_float(u0 & 0xffff0000u);
  const float r1 = x1 - __uint_as_float(u1 & 0xffff0000u);
  const uint32_t v0 = __float_as_uint(r0), v1 = __float_as_uint(r1);
  const float l0 = r0 - __uint_as_float(v0 & 0xffff0000u);
  const float l1 = r1 - __uint_as_float(v1 & 0xffff0000u);
  hi = (u0 >> 16) | (u1 & 0xffff0000u);
  mid = (v0 >> 16) | (v1 & 0xffff0000u);
  const __nv_bfloat162 l = __floats2bfloat162_rn(l0, l1);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Where depth k of a tile's row r lies in shared memory. Rows 40 floats
// (or 40 bf16) apart put the fragment reads of a half-warp on distinct
// banks; a store along the rows (an operand whose unit stride is not along
// k) would put every fourth (every eighth) row on one bank, so the depth is
// XORed with an even number taken from the row: pairs of depths stay
// adjacent, and a fragment read, whose rows share that number, keeps its
// banks.
__device__ __forceinline__ int a_col(int r, int k) {
  return k ^ (((r >> 2) & 3) << 1);
}
__device__ __forceinline__ int b_col(int n, int k) {
  return k ^ (((n >> 3) & 3) << 1);
}

// One operand's share of a tile: ROWS rows (the output's rows or columns)
// by kBK depths, in pairs of adjacent depths, `kPer` pairs a thread. The
// lanes run along the operand's unit stride: the depth (`KU`) or the rows.
// Thread t's pair i lies at row `row(t, i)`, depths `depth(t, i)` and one
// more.
template <int ROWS, int THREADS, bool KU>
struct Share {
  static constexpr int kPairs = kBK / 2;
  static constexpr int kPer = ROWS * kPairs / THREADS;
  static __device__ __forceinline__ int row(int t, int i) {
    return KU ? t / kPairs + i * (THREADS / kPairs) : t % ROWS;
  }
  static __device__ __forceinline__ int depth(int t, int i) {
    return 2 * (KU ? t % kPairs : t / ROWS + i * (THREADS / ROWS));
  }
};

// Loads a share into registers. Rows past `rows` read the last row (their
// outputs are never written); depths at or past `k_end` read 0 (TAIL).
// `pair` when a pair is one aligned load (unit stride along the depth,
// aligned rows).
template <class S, bool TAIL>
__device__ __forceinline__ void load_a(const float* base, int row0, int rows,
                                       int s_row, int k0, int k_end, int s_k,
                                       bool pair, float2 (&r)[S::kPer]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    const int row = min(row0 + S::row(t, i), rows - 1);
    const int k = k0 + S::depth(t, i);
    const float* at = base + row * s_row + k * s_k;
    if (TAIL) {
      r[i].x = k < k_end ? __ldg(at) : 0.0f;
      r[i].y = k + 1 < k_end ? __ldg(at + s_k) : 0.0f;
    } else if (pair) {
      r[i] = __ldg(reinterpret_cast<const float2*>(at));
    } else {
      r[i] = make_float2(__ldg(at), __ldg(at + s_k));
    }
  }
}

// the same for the bf16 operand: a pair packed in 32 bits, the lower depth
// in the low half
template <class S, bool TAIL>
__device__ __forceinline__ void load_b(const uint16_t* base, int row0,
                                       int rows, int s_row, int k0, int k_end,
                                       int s_k, bool pair,
                                       uint32_t (&r)[S::kPer]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    const int row = min(row0 + S::row(t, i), rows - 1);
    const int k = k0 + S::depth(t, i);
    const uint16_t* at = base + row * s_row + k * s_k;
    if (TAIL) {
      const uint32_t lo = k < k_end ? __ldg(at) : 0u;
      const uint32_t hi = k + 1 < k_end ? __ldg(at + s_k) : 0u;
      r[i] = lo | (hi << 16);
    } else if (pair) {
      r[i] = __ldg(reinterpret_cast<const unsigned int*>(at));
    } else {
      r[i] = uint32_t(__ldg(at)) | (uint32_t(__ldg(at + s_k)) << 16);
    }
  }
}

template <int BN, bool AKU, bool BKU>
__global__ void __launch_bounds__(kThreads)
    split_mm_kernel(const Args p) {
  constexpr int kNT = BN / 8;  // a warp's n8 tiles
  using SA = Share<kBM, kThreads, AKU>;
  using SB = Share<BN, kThreads, BKU>;
  __shared__ __align__(16) float As[2][kBM][kAStride];
  __shared__ __align__(16) uint16_t Bs[2][BN][kBStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp * 16;

  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + kBM - 1) / kBM) * tiles_n;
  const int bat = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * BN;
  const int k_lo = blockIdx.y * p.k_slice;
  const int k_hi = min(k_lo + p.k_slice, p.K);
  const float* a = p.a + bat * p.s_ab;
  const uint16_t* b = p.b + bat * p.s_bb;

  float2 ra[SA::kPer];
  uint32_t rb[SB::kPer];
  auto load = [&](int k0) {
    if (k0 + kBK <= k_hi) {
      load_a<SA, false>(a, m0, p.M, p.s_am, k0, k_hi, p.s_ak, p.a_pair, ra);
      load_b<SB, false>(b, n0, p.N, p.s_bn, k0, k_hi, p.s_bk, p.b_pair, rb);
    } else {
      load_a<SA, true>(a, m0, p.M, p.s_am, k0, k_hi, p.s_ak, p.a_pair, ra);
      load_b<SB, true>(b, n0, p.N, p.s_bn, k0, k_hi, p.s_bk, p.b_pair, rb);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < SA::kPer; ++i) {
      const int r = SA::row(tid, i);
      *reinterpret_cast<float2*>(&As[buf][r][a_col(r, SA::depth(tid, i))]) =
          ra[i];
    }
#pragma unroll
    for (int i = 0; i < SB::kPer; ++i) {
      const int n = SB::row(tid, i);
      *reinterpret_cast<uint32_t*>(&Bs[buf][n][b_col(n, SB::depth(tid, i))]) =
          rb[i];
    }
  };

  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;

  const int steps = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  if (steps > 0) {
    load(k_lo);
    store(0);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load(k_lo + (s + 1) * kBK);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t bf[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = nt * 8 + g;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(
            &Bs[cur][n][b_col(n, ks + 2 * q)]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(
            &Bs[cur][n][b_col(n, ks + 2 * q + 8)]);
      }
      uint32_t parts[3][4];  // [hi, mid, lo][fragment]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // fragment j: rows wm + g (j even) or + 8, depths 2q (j < 2) or
        // 2q + 8
        const int r = wm + g + (j & 1) * 8;
        const float2 x = *reinterpret_cast<const float2*>(
            &As[cur][r][a_col(r, ks + 2 * q + (j >> 1) * 8)]);
        split_pair(x.x, x.y, parts[0][j], parts[1][j], parts[2][j]);
      }
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_bf16(acc[nt], parts[part], bf[nt][0], bf[nt][1]);
    }
    if (s + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

  // c0, c1: row g, columns 2q, 2q + 1; c2, c3: row g + 8
  const int64_t base = blockIdx.y * p.s_cs + bat * p.s_cb;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wm + g + (j >> 1) * 8;
      const int n = n0 + nt * 8 + 2 * q + (j & 1);
      if (m >= p.M || n >= p.N) continue;
      const int64_t at = base + m * p.s_cm + n * p.s_cn;
      if (p.out_bf16)
        static_cast<__nv_bfloat16*>(p.c)[at] = __float2bfloat16_rn(acc[nt][j]);
      else
        static_cast<float*>(p.c)[at] = acc[nt][j];
    }
}

template <int BN>
void launch_bn(const Args& p, dim3 grid, cudaStream_t s, bool a_ku,
               bool b_ku) {
  if (a_ku && b_ku)
    split_mm_kernel<BN, true, true><<<grid, kThreads, 0, s>>>(p);
  else if (a_ku)
    split_mm_kernel<BN, true, false><<<grid, kThreads, 0, s>>>(p);
  else if (b_ku)
    split_mm_kernel<BN, false, true><<<grid, kThreads, 0, s>>>(p);
  else
    split_mm_kernel<BN, false, false><<<grid, kThreads, 0, s>>>(p);
}

// out[i] = sum over s of partials[s * n + i], in slice order
__global__ void sum_slices_kernel(const float* __restrict__ partials,
                                  void* out, int64_t n, int slices,
                                  bool out_bf16) {
  const int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  float sum = partials[i];
  for (int s = 1; s < slices; ++s) sum += partials[s * n + i];
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(sum);
  else
    static_cast<float*>(out)[i] = sum;
}

}  // namespace

extern "C" {

// Launches the product on `stream` and returns cudaGetLastError() as an
// int (0 on success). `a` is f32 [batch, M, K], `b` bf16 [batch, K, N], `c`
// [slices, batch, M, N] through its strides (the slice stride `s_cs` unused
// when slices is 1), f32 when slices > 1, else f32 or bf16 (`out_bf16`);
// strides in elements, the operands' offsets within 32 bits. `bn` is 32, 64
// or 128. The caller validates shapes and the plan; nothing is allocated
// here and nothing is synchronised.
int dsat_split_mm(const void* a, const void* b, void* c, int batch, int M,
                  int N, int K, int k_slice, int slices, int bn, int s_ab,
                  int s_am, int s_ak, int s_bb, int s_bk, int s_bn,
                  int64_t s_cs, int64_t s_cb, int64_t s_cm, int64_t s_cn,
                  int out_bf16, void* stream) {
  Args p{static_cast<const float*>(a), static_cast<const uint16_t*>(b),
         c, M, N, K, k_slice, s_ab, s_am, s_ak, s_bb, s_bk, s_bn, s_cs,
         s_cb, s_cm, s_cn, out_bf16 != 0, false, false};
  // each operand loaded along its unit stride: the depth's, or else the
  // rows' (any other layout loads correctly, uncoalesced); along the
  // depth a pair is one load where every row starts aligned (k_slice is
  // a multiple of kBK, so every pair starts at an even depth)
  const bool a_ku = s_ak == 1;
  const bool b_ku = !(s_bn == 1 && s_bk != 1);
  p.a_pair = a_ku && reinterpret_cast<uintptr_t>(a) % 8 == 0 &&
             s_am % 2 == 0 && s_ab % 2 == 0;
  p.b_pair = s_bk == 1 && reinterpret_cast<uintptr_t>(b) % 4 == 0 &&
             s_bn % 2 == 0 && s_bb % 2 == 0;
  const dim3 grid(batch * ((M + kBM - 1) / kBM) * ((N + bn - 1) / bn),
                  slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32:
      launch_bn<32>(p, grid, s, a_ku, b_ku);
      break;
    case 64:
      launch_bn<64>(p, grid, s, a_ku, b_ku);
      break;
    case 128:
      launch_bn<128>(p, grid, s, a_ku, b_ku);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Adds `slices` f32 partials of `n` elements each (contiguous, one after
// another) in slice order into `out` (n contiguous elements, f32 or bf16).
int dsat_sum_slices(const void* partials, void* out, int64_t n, int slices,
                    int out_bf16, void* stream) {
  constexpr int kSumThreads = 256;
  const int64_t blocks = (n + kSumThreads - 1) / kSumThreads;
  sum_slices_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), out, n, slices, out_bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}

const char* dsat_split_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
