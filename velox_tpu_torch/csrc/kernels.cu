// Hand-written Hopper (sm_90a) kernels of the query engine: the three grouped /
// selective integer sums.  Plain C interface, loaded with ctypes
// (ops/cuda_build.py); no PyTorch headers.
//
//   velox_selective_sum       fused band filter + exact sum     (ops/selective_sum.py)
//   velox_grouped_piece_sums  grouped sums of affine products   (ops/group_piece.py)
//   velox_grouped_int64_sums  grouped wrapping int64 sums       (ops/group_sum.py)
//
// Common shape: every kernel is one pass over its input columns, bounded by
// the bytes it reads.  A block walks a grid-stride range of rows, reduces what
// it sees (registers + shuffles for the ungrouped sum, a shared-memory table of
// 64-bit accumulators for the grouped ones) and publishes once with global
// atomics into an output the caller zeroed.  Integer addition wraps and is
// associative, so the result does not depend on the order of the atomics:
// every kernel is bit-identical to its plain PyTorch version.
//
// Each entry point launches on the stream it is given, allocates nothing, does
// not synchronise, and returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;     // column operands of one launch
constexpr int kMaxFilters = 3;   // band filters of selective_sum
constexpr int kMaxSpecs = 16;    // sum specs of grouped_piece_sums
constexpr int kMaxFactors = 48;  // affine factors over all specs

typedef unsigned long long u64;
typedef long long i64;

// One integer column operand at its stored width (1, 2, 4 or 8 bytes, signed).
__device__ __forceinline__ i64 load_int(const void* p, int width, i64 i) {
  switch (width) {
    case 1:
      return static_cast<const int8_t*>(p)[i];
    case 2:
      return static_cast<const int16_t*>(p)[i];
    case 4:
      return static_cast<const int32_t*>(p)[i];
    default:
      return static_cast<const int64_t*>(p)[i];
  }
}

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

// ---------------------------------------------------------------------------
// grouped_piece_sums

struct PieceFactor {
  int32_t col;
  int32_t pad_;
  i64 scale;
  i64 offset;
};

struct PieceArgs {
  const void* cols[kMaxCols];
  int32_t widths[kMaxCols];
  const void* gid;  // int8 or int32 per row; < 0 marks a dead row
  int32_t gid_width;
  i64 n;
  int32_t n_specs;
  int32_t num_groups;
  int32_t spec_start[kMaxSpecs + 1];  // factors of spec s: [start[s], start[s+1])
  PieceFactor factors[kMaxFactors];
  u64* out;  // [num_groups][n_specs], zeroed by the caller
};

__global__ void __launch_bounds__(kThreads)
grouped_piece_sums_kernel(PieceArgs a) {
  extern __shared__ u64 table[];  // [num_groups][n_specs]
  const int cells = a.num_groups * a.n_specs;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0;
  __syncthreads();
  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    const int g = static_cast<int>(load_int(a.gid, a.gid_width, i));
    if (g < 0 || g >= a.num_groups) continue;
    u64* row = table + g * a.n_specs;
    for (int s = 0; s < a.n_specs; ++s) {
      i64 prod = 1;  // the empty spec counts live rows
      for (int k = a.spec_start[s]; k < a.spec_start[s + 1]; ++k) {
        const int c = a.factors[k].col;
        const i64 x = load_int(a.cols[c], a.widths[c], i);
        prod *= a.factors[k].scale * x + a.factors[k].offset;
      }
      atomicAdd(row + s, static_cast<u64>(prod));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const u64 v = table[c];
    if (v != 0) atomicAdd(a.out + c, v);
  }
}

// ---------------------------------------------------------------------------
// grouped_int64_sums

struct GroupSumArgs {
  const int64_t* cols[kMaxCols];
  int32_t ncols;
  const int32_t* gids;
  const uint8_t* mask;  // torch.bool storage: one byte per row, 0 or 1
  i64 n;
  int32_t num_groups;
  u64* out;  // [num_groups][ncols], zeroed by the caller
};

__global__ void __launch_bounds__(kThreads)
grouped_int64_sums_kernel(GroupSumArgs a) {
  extern __shared__ u64 table[];  // [num_groups][ncols]
  const int cells = a.num_groups * a.ncols;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0;
  __syncthreads();
  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    if (!a.mask[i]) continue;
    const int g = a.gids[i];
    if (g < 0 || g >= a.num_groups) continue;
    u64* row = table + g * a.ncols;
    for (int c = 0; c < a.ncols; ++c) {
      atomicAdd(row + c, static_cast<u64>(a.cols[c][i]));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const u64 v = table[c];
    if (v != 0) atomicAdd(a.out + c, v);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points.  Pointer arguments named *_host are host arrays read during
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

extern "C" int velox_grouped_piece_sums(
    const void* const* cols_host, const int* widths_host, int ncols,
    const void* gid, int gid_width, long long n, const int* spec_start_host,
    int n_specs, const int* factor_col_host, const long long* factor_scale_host,
    const long long* factor_offset_host, int num_groups, void* out,
    int max_blocks, void* stream) {
  if (ncols < 0 || ncols > kMaxCols || n_specs < 1 || n_specs > kMaxSpecs ||
      num_groups < 1 || (gid_width != 1 && gid_width != 4)) {
    return cudaErrorInvalidValue;
  }
  const int n_factors = spec_start_host[n_specs];
  if (n_factors < 0 || n_factors > kMaxFactors) return cudaErrorInvalidValue;
  PieceArgs a;
  for (int c = 0; c < kMaxCols; ++c) {
    a.cols[c] = c < ncols ? cols_host[c] : nullptr;
    a.widths[c] = c < ncols ? widths_host[c] : 0;
  }
  a.gid = gid;
  a.gid_width = gid_width;
  a.n = n;
  a.n_specs = n_specs;
  a.num_groups = num_groups;
  for (int s = 0; s <= kMaxSpecs; ++s) {
    a.spec_start[s] = s <= n_specs ? spec_start_host[s] : n_factors;
  }
  for (int k = 0; k < kMaxFactors; ++k) {
    a.factors[k].col = k < n_factors ? factor_col_host[k] : 0;
    a.factors[k].pad_ = 0;
    a.factors[k].scale = k < n_factors ? factor_scale_host[k] : 0;
    a.factors[k].offset = k < n_factors ? factor_offset_host[k] : 0;
    if (k < n_factors && (a.factors[k].col < 0 || a.factors[k].col >= ncols)) {
      return cudaErrorInvalidValue;
    }
  }
  a.out = static_cast<u64*>(out);
  const size_t smem = sizeof(u64) * static_cast<size_t>(num_groups) * n_specs;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  grouped_piece_sums_kernel<<<grid_for(n, max_blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int velox_grouped_int64_sums(
    const void* const* cols_host, int ncols, const void* gids, const void* mask,
    long long n, int num_groups, void* out, int max_blocks, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || num_groups < 1) return cudaErrorInvalidValue;
  GroupSumArgs a;
  for (int c = 0; c < kMaxCols; ++c) {
    a.cols[c] = c < ncols ? static_cast<const int64_t*>(cols_host[c]) : nullptr;
  }
  a.ncols = ncols;
  a.gids = static_cast<const int32_t*>(gids);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n = n;
  a.num_groups = num_groups;
  a.out = static_cast<u64*>(out);
  const size_t smem = sizeof(u64) * static_cast<size_t>(num_groups) * ncols;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  grouped_int64_sums_kernel<<<grid_for(n, max_blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
