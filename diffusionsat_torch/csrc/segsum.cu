// Fused gather + sorted segmented sum on Hopper (sm_90a):
//
//     out[s, :] = sum_{e in [row_ptr[s], row_ptr[s+1])} x[gather[e], :]
//
// with f32 in and f32 out. One kernel serves both directions of the
// literal-clause SpMM pair: lit->clause (segments are clauses, sources are
// literal rows) and clause->lit (segments are literals, sources are clause
// rows), and the other plans of `ops/segsum.py` (edge -> literal, the ANF
// membership pair, the AND -> variable scatter, the per-shard and halo
// plans). Each direction is the other's transpose, so the backward of one
// is a forward launch of the other.
//
// Replaces the TPU kernel `_segsum_kernel` launched by `segsum_pallas`
// (reference package, ops/pallas_segsum.py:97-154), together with the gather
// that `gather_segsum` and `_run_direction` do before it (:157-163,
// :246-252), which is fused into this kernel's loads.
//
// Why a CSR plan. The TPU kernel packs edges into tiles whose [W, F] output
// windows overlap; it is exact only because the TPU grid runs in order and
// the owning tile writes last. CUDA blocks run concurrently and in no
// order, so that design would race. Here the host builds a CSR plan per
// direction (masked edges dropped, edges of a segment contiguous and in a
// fixed order), and every output row is written exactly once by the lanes
// that own its segment: no atomics, no window, no tile limit. Each column
// of a segment is summed left to right in plan order from 0, as
// `torch.segment_reduce` sums it, so the kernel equals its plain version
// (`segsum_plain`) bit for bit. An empty segment is written as 0.
//
// Bound. The work is E * F additions, far below the card's f32 rate, so it
// is bound by memory: the rows of x the plan reads, the output, and the
// indices, each once (x mostly stays in L2: E/N ~ 2 to 5). At the main
// path's sizes (E up to 48 640, F <= 128) that is 1-9 us, near the cost of
// a launch itself (about 1.2 us for a one-element kernel replayed in a
// graph), so what sets the time is how many loads are in flight: warps
// resident times the rows each has asked for before it waits.
//
// Design (the second; the first gave a warp to a segment, a lane a float4,
// and walked a long segment's edges about two dependent loads at a time):
//
// - Lanes per segment set by F. L = F/4 lanes (rounded up to a power of
//   two, at most 32) own one segment, each lane VEC = 4 adjacent columns
//   (one float4) per pass of 4L columns; 32/L segments share a warp, so at
//   F = 64 (ANF) and F = 16 (hyperopt) no lane idles. Rows of a width that
//   is not a multiple of 4, or misaligned, take the scalar path (VEC = 1,
//   L = F rounded up to a power of two, at most 32).
// - Several source rows in flight. A batch's index loads, then its row
//   loads (through the read-only path), are all issued before the first
//   add; the rows are then added in plan order, so the order of the sum
//   does not change. Each lane loads the indices itself (one broadcast
//   load per edge): one coalesced load of the group's indices handed out
//   by `__shfl_sync` measured slower, a shuffle on every edge's path.
// - Registers decide it where segments are short. Rows in flight cost
//   registers, and registers cost resident warps: at a warp a segment
//   (F = 128) the rows with one to three edges a segment (lit -> clause,
//   lit -> edge, var -> and) are already near their bound and lose with
//   every warp fewer. So there batches are of 3 rows and the kernel is held
//   to 32 registers (64 warps an SM, as the first design had); the last one
//   or two rows go as a batch of their own. Where several segments share a
//   warp, batches are of 4, the last batch's indices clamped.
// - The bounds of the segments of a warp come with one coalesced load
//   when several share it.
//
// Tried and not kept: staging the rows in a shared-memory ring with
// `cp.async` (registers stay free, but the copies wait as long as the
// loads and the ring costs resident blocks: no faster); more rows in
// flight at a warp a segment (faster on long segments, slower on the
// short ones by the warps it costs). Not done: splitting a long (hub)
// segment across warps, which would change the order of the sum (the ANF
// constant node is a dense column outside the kernel, ops/segsum.ANFPlans).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarpsPerBlock = kThreads / kWarp;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }

template <typename T>
__device__ __forceinline__ T row(const float* xc, int64_t x_stride,
                                 int src) {
  return __ldg(reinterpret_cast<const T*>(
      xc + static_cast<int64_t>(src) * x_stride));
}

// `n` rows of the segment from edge e on, their index loads and then their
// row loads all issued before the first add; summed in plan order
template <typename T, int n>
__device__ __forceinline__ void add_rows(T& acc, const float* xc,
                                         int64_t x_stride,
                                         const int32_t* gather, int e) {
  T v[n];
#pragma unroll
  for (int u = 0; u < n; ++u) {
    v[u] = row<T>(xc, x_stride, __ldg(gather + e + u));
  }
#pragma unroll
  for (int u = 0; u < n; ++u) add(acc, v[u]);
}

// L lanes own one segment, 32 / L segments share a warp. A lane owns VEC
// adjacent columns in each pass of L * VEC columns.
//
// A warp to a segment (L = 32): batches of 3 rows in flight, then the last
// one or two; 32 registers, so that 64 warps stay resident on an SM (the
// launch bound asks for 8 blocks of 256 threads). Several segments a warp
// (L < 32): batches of 4 rows, the last batch's indices clamped to the
// segment's last edge (a clamped row is read again from L1 and not added).
template <int VEC, int L>
__global__ void __launch_bounds__(kThreads, L == kWarp ? 8 : 1)
gather_segsum_kernel(const float* __restrict__ x, int64_t x_stride,
                     const int32_t* __restrict__ row_ptr,
                     const int32_t* __restrict__ gather,
                     float* __restrict__ out, int num_segments, int F) {
  using T = typename Vec<VEC>::T;
  constexpr int kGroups = kWarp / L;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;
  const int group = lane / L;
  const int seg0 =
      (blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) * kGroups;
  if (seg0 >= num_segments) return;  // the whole warp
  const int seg = seg0 + group;
  const bool live = seg < num_segments;

  int beg, end;
  if constexpr (kGroups == 1) {
    beg = __ldg(row_ptr + seg);
    end = __ldg(row_ptr + seg + 1);
  } else {
    // the offsets of the warp's segments, one coalesced load, handed to
    // each group by shuffles
    int bound = 0;
    if (lane <= kGroups && seg0 + lane <= num_segments) {
      bound = __ldg(row_ptr + seg0 + lane);
    }
    beg = __shfl_sync(0xffffffffu, bound, group);
    end = __shfl_sync(0xffffffffu, bound, (group + 1) % kWarp);
    if constexpr (kGroups == kWarp) {
      // one lane a segment: the last segment's end lies past the offsets
      if (group == kWarp - 1 && live) end = __ldg(row_ptr + seg + 1);
    }
    if (!live) end = beg;
  }

  for (int c = sub * VEC; c < F; c += L * VEC) {
    const float* xc = x + c;
    T acc;
    zero(acc);
    int e = beg;
    if constexpr (kGroups == 1) {
      for (; e + 3 <= end; e += 3) {
        add_rows<T, 3>(acc, xc, x_stride, gather, e);
      }
      if (e + 2 <= end) {
        add_rows<T, 2>(acc, xc, x_stride, gather, e);
        e += 2;
      }
      if (e < end) add_rows<T, 1>(acc, xc, x_stride, gather, e);
    } else {
      constexpr int kU = 4;
      for (; e < end; e += kU) {
        T v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          v[u] = row<T>(xc, x_stride, __ldg(gather + min(e + u, end - 1)));
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (e + u < end) add(acc, v[u]);
        }
      }
    }
    if (live) {
      *reinterpret_cast<T*>(out + static_cast<int64_t>(seg) * F + c) = acc;
    }
  }
}

template <int VEC, int L>
void launch(const float* x, int64_t x_stride, const int32_t* row_ptr,
            const int32_t* gather, float* out, int num_segments, int F,
            cudaStream_t s) {
  constexpr int kSegmentsPerBlock = kWarpsPerBlock * (kWarp / L);
  const dim3 grid((num_segments + kSegmentsPerBlock - 1) /
                  kSegmentsPerBlock);
  gather_segsum_kernel<VEC, L><<<grid, kThreads, 0, s>>>(
      x, x_stride, row_ptr, gather, out, num_segments, F);
}

template <int VEC>
void dispatch(int lanes, const float* x, int64_t x_stride,
              const int32_t* row_ptr, const int32_t* gather, float* out,
              int num_segments, int F, cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch<VEC, 1>(x, x_stride, row_ptr, gather, out, num_segments,
                            F, s);
    case 2:
      return launch<VEC, 2>(x, x_stride, row_ptr, gather, out, num_segments,
                            F, s);
    case 4:
      return launch<VEC, 4>(x, x_stride, row_ptr, gather, out, num_segments,
                            F, s);
    case 8:
      return launch<VEC, 8>(x, x_stride, row_ptr, gather, out, num_segments,
                            F, s);
    case 16:
      return launch<VEC, 16>(x, x_stride, row_ptr, gather, out,
                             num_segments, F, s);
    default:
      return launch<VEC, 32>(x, x_stride, row_ptr, gather, out,
                             num_segments, F, s);
  }
}

// lanes per segment: `units` (float4s or floats of a row) rounded up to a
// power of two, at most a warp
int lanes_for(int units) {
  int lanes = 1;
  while (lanes < units && lanes < kWarp) lanes *= 2;
  return lanes;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success). `x` is [num_sources, >= F] with row stride `x_stride`
// floats and unit column stride; `out` is [num_segments, F] contiguous. The
// caller validates shapes and index ranges; nothing is allocated here and
// nothing is synchronised.
int dsat_gather_segsum(const void* x, int64_t x_stride, const void* row_ptr,
                       const void* gather, void* out, int num_segments, int F,
                       void* stream) {
  if (num_segments <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* ga = static_cast<const int32_t*>(gather);
  auto* of = static_cast<float*>(out);
  const bool vec4 = F % 4 == 0 && x_stride % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    dispatch<4>(lanes_for(F / 4), xf, x_stride, rp, ga, of, num_segments, F,
                s);
  } else {
    dispatch<1>(lanes_for(F), xf, x_stride, rp, ga, of, num_segments, F, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dsat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
