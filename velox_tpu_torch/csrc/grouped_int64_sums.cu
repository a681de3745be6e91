// velox_grouped_int64_sums: grouped wrapping int64 sums of several columns
// under a mask (ops/group_sum.py).
//
// Replaces the TPU kernel `grouped_int64_sums` of the JAX package
// (velox_tpu/ops/pallas_group_sum.py, kernel body `_kernel`).
//
// What it computes: per group g and column c, the sum over rows with the mask
// set and gids == g of col_c, wrapping mod 2^64; gids outside [0, groups) are
// dead rows.
//
// What bounds it on the H100: bytes.  A row is 8 bytes a column plus 4 of
// group id plus 1 of mask, against one add a column.
//
// What the design does about it (shared parts in grouped_common.cuh):
//  * the aligned body streams through a ring of shared-memory stages filled by
//    bulk asynchronous copies, several chunks in flight for every block, so
//    the memory system always has requests queued; every input byte is read
//    from device memory once; rows outside the body take a scalar path in the
//    same launch;
//  * the table is privatised (copy index fastest, one copy per lane): no two
//    lanes of a warp add to one address, and the adds are native 32-bit shared
//    atomics with a carry;
//  * one publish per block, output laid out [columns][groups].
//
// The entry point launches on the stream it is given, allocates nothing, does
// not synchronise, and returns a cudaError_t as an int (0 = launched).

#include "grouped_common.cuh"

namespace {

using namespace velox;

struct GroupSumArgs {
  Geometry geom;
  StagedArrays arrays;  // the int64 columns, then the int32 group ids, then the mask bytes
  int32_t ncols;
  int32_t num_groups;
  u64* out;  // [ncols][num_groups], zeroed by the caller
};

// ROWS rows of every thread, kThreads * ROWS rows of the chunk from `base`.
// Only the ROWS == 1 step may reach past the chunk's last row.
template <int ROWS>
__device__ __forceinline__ void sum_subtile(const GroupSumArgs& a, const BlockMemory& m,
                                            const unsigned char* stage, int rows, int base) {
  const int cells = a.ncols, groups = a.num_groups;
  const int32_t* gids = reinterpret_cast<const int32_t*>(stage + a.arrays.stage_off[cells]);
  const uint8_t* mask = stage + a.arrays.stage_off[cells + 1];
  const int col_stride = a.geom.lane_copies * 4;  // table bytes between two columns
  const int row_stride = cells * col_stride;                  // and between two groups
  int idx[ROWS];        // the row inside the chunk
  uint32_t slot[ROWS];  // shared-memory address of the first word of the row's group
  bool alive[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = base + j * kThreads + static_cast<int>(threadIdx.x);
    const bool inside = ROWS > 1 || r < rows;
    idx[j] = inside ? r : rows - 1;  // every read stays inside the stage
    const int grp = gids[idx[j]];
    alive[j] = inside && mask[idx[j]] != 0 && grp >= 0 && grp < groups;
    slot[j] = m.my_table + grp * row_stride;
  }
  for (int c = 0; c < cells; ++c) {
    const u64* col = reinterpret_cast<const u64*>(stage + a.arrays.stage_off[c]);
    u64 v[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) v[j] = col[idx[j]];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (alive[j]) table_add(slot[j] + c * col_stride, m.hi_offset, v[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
grouped_int64_sums_kernel(const __grid_constant__ GroupSumArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry& g = a.geom;
  const int cells = a.ncols, groups = a.num_groups;
  const BlockMemory m = carve(smem, g, groups * cells);
  block_begin(m, g, groups * cells);
  const int col_stride = g.lane_copies * 4;
  const int row_stride = cells * col_stride;

  for_each_chunk(m, g, a.arrays, [&](const unsigned char* stage, int rows) {
    int base = 0;
    for (; base + kThreads * 8 <= rows; base += kThreads * 8) {
      sum_subtile<8>(a, m, stage, rows, base);
    }
    if (base + kThreads * 4 <= rows) {
      sum_subtile<4>(a, m, stage, rows, base);
      base += kThreads * 4;
    }
    if (base + kThreads * 2 <= rows) {
      sum_subtile<2>(a, m, stage, rows, base);
      base += kThreads * 2;
    }
    for (; base < rows; base += kThreads) sum_subtile<1>(a, m, stage, rows, base);
  });

  for_each_edge_row(g, [&](i64 i) {
    if (a.arrays.ptr[cells + 1][i] == 0) return;
    const int grp = reinterpret_cast<const int32_t*>(a.arrays.ptr[cells])[i];
    if (grp < 0 || grp >= groups) return;
    const uint32_t row = m.my_table + grp * row_stride;
    for (int c = 0; c < cells; ++c) {
      table_add(row + c * col_stride, m.hi_offset,
                      reinterpret_cast<const u64*>(a.arrays.ptr[c])[i]);
    }
  });

  publish(m, g, groups, cells, a.out);
}

}  // namespace

// Pointer arguments named *_host are host arrays read during the call; every
// other pointer is device memory.  `arrays_host` / `stage_off_host` list the
// int64 columns first, then the int32 group ids, then the mask bytes.
extern "C" int velox_grouped_int64_sums(
    const void* const* arrays_host, const int* stage_off_host, int ncols,
    const long long* geometry_host, int num_groups, void* out, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || num_groups < 1) return cudaErrorInvalidValue;
  GroupSumArgs a;
  a.geom = geometry_from_host(geometry_host);
  a.arrays.count = ncols + 2;
  for (int k = 0; k < kMaxArrays; ++k) {
    const bool used = k < a.arrays.count;
    a.arrays.ptr[k] = used ? static_cast<const unsigned char*>(arrays_host[k]) : nullptr;
    a.arrays.width[k] = !used ? 0 : k < ncols ? 8 : k == ncols ? 4 : 1;
    a.arrays.stage_off[k] = used ? stage_off_host[k] : 0;
  }
  a.ncols = ncols;
  a.num_groups = num_groups;
  a.out = static_cast<u64*>(out);
  if (check_geometry(a.geom, a.arrays, num_groups * ncols) != 0) return cudaErrorInvalidValue;
  return launch(grouped_int64_sums_kernel, a, a.geom, stream);
}

// The limits grouped_common.cuh was compiled with, in the order
// ops/launch_geometry.py COMPILED_LIMITS names them; the loader holds the two
// copies against each other.
extern "C" int velox_grouped_limits(long long* limits_host) {
  limits_host[0] = kThreads;
  limits_host[1] = kMaxArrays;
  limits_host[2] = kMaxStages;
  limits_host[3] = kMaxSharedBytes;
  limits_host[4] = kBarrierBytes;
  return 0;
}
