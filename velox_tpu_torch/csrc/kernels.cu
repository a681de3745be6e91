// Hand-written Hopper (sm_90a) kernel of the query engine: the selective sum.
// Plain C interface, loaded with ctypes (ops/cuda_build.py); no PyTorch
// headers.  The two grouped sums live beside it:
//
//   velox_selective_sum       fused band filter + exact sum     (ops/selective_sum.py)   this file
//   velox_grouped_piece_sums  grouped sums of affine products   (ops/group_piece.py)     grouped_piece_sums.cu
//   velox_grouped_int64_sums  grouped wrapping int64 sums       (ops/group_sum.py)       grouped_int64_sums.cu
//
// selective_sum replaces the TPU kernel `selective_sum` of the JAX package
// (velox_tpu/ops/pallas_kernels.py).  It is one pass over its input columns,
// bounded by the bytes it reads.  A block walks a grid-stride range of rows,
// reduces what it sees in registers and shuffles, and publishes once with
// global atomics into an output the caller zeroed.  Integer addition wraps
// and is associative, so the result does not depend on the order of the
// atomics: the kernel is bit-identical to its plain PyTorch version.
//
// The entry point launches on the stream it is given, allocates nothing, does
// not synchronise, and returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFilters = 3;   // band filters of selective_sum

typedef unsigned long long u64;
typedef long long i64;

__device__ __forceinline__ i64 warp_sum(i64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

int grid_for(i64 n, int max_blocks) {
  i64 blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  return static_cast<int>(blocks);
}

// ---------------------------------------------------------------------------
// selective_sum

struct SelectiveArgs {
  const int64_t* values;
  const int64_t* filters[kMaxFilters];
  i64 lo[kMaxFilters];
  i64 hi[kMaxFilters];
  int n_filters;
  i64 n;
  u64* out;  // [3]: sum(v >> 32), sum(v & 0xFFFFFFFF), count
};

__global__ void __launch_bounds__(kThreads)
selective_sum_kernel(SelectiveArgs a) {
  i64 hi = 0, lo = 0, cnt = 0;
  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    bool pass = true;
#pragma unroll
    for (int k = 0; k < kMaxFilters; ++k) {
      if (k < a.n_filters) {
        const i64 f = a.filters[k][i];
        pass = pass && (f >= a.lo[k]) && (f <= a.hi[k]);
      }
    }
    if (pass) {
      const i64 v = a.values[i];
      hi += v >> 32;
      lo += v & 0xFFFFFFFFLL;
      cnt += 1;
    }
  }
  __shared__ i64 part[3][kThreads / 32];
  hi = warp_sum(hi);
  lo = warp_sum(lo);
  cnt = warp_sum(cnt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = hi;
    part[1][warp] = lo;
    part[2][warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    i64 total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += part[threadIdx.x][w];
    if (total != 0) atomicAdd(a.out + threadIdx.x, static_cast<u64>(total));
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point.  Pointer arguments named *_host are host arrays read during
// the call; every other pointer is device memory.

extern "C" int velox_selective_sum(
    const void* values, const void* const* filters_host, const long long* lo_host,
    const long long* hi_host, int n_filters, long long n, void* out,
    int max_blocks, void* stream) {
  if (n_filters < 0 || n_filters > kMaxFilters) return cudaErrorInvalidValue;
  SelectiveArgs a;
  a.values = static_cast<const int64_t*>(values);
  for (int k = 0; k < kMaxFilters; ++k) {
    a.filters[k] = k < n_filters ? static_cast<const int64_t*>(filters_host[k]) : nullptr;
    a.lo[k] = k < n_filters ? lo_host[k] : 0;
    a.hi[k] = k < n_filters ? hi_host[k] : 0;
  }
  a.n_filters = n_filters;
  a.n = n;
  a.out = static_cast<u64*>(out);
  selective_sum_kernel<<<grid_for(n, max_blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
