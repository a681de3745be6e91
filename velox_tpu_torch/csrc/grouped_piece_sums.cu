// velox_grouped_piece_sums: grouped exact int64 sums of affine products over
// narrow columns (ops/group_piece.py).
//
// Replaces the TPU kernel `grouped_piece_sums` of the JAX package
// (velox_tpu/ops/pallas_group_piece.py, kernel body `_make_kernel`).
//
// What it computes: per group g and spec s,
//   sum over rows with gid == g of prod_f (scale_f * col_f + offset_f)
// as a wrapping int64; the empty spec counts live rows; gid outside
// [0, groups) marks a dead row.
//
// What bounds it on the H100: by bytes it is tiny (TPC-H Q1 moves 9 bytes a
// row), so once the loads are bulk copies three things of about equal size are
// left: the stream of bulk copies itself, the multiply chains, and the
// shared-memory atomics of the table adds (about 2.4 clocks of a
// multiprocessor for each warp-wide atomic).
//
// What the design does about it (shared parts in grouped_common.cuh):
//  * every input byte of the aligned body comes from device memory once, by a
//    bulk asynchronous copy into a ring of shared-memory stages, the next
//    chunk in flight while this one is summed; rows outside the body (an
//    unaligned head, a tail of fewer than 16 rows, or everything when the
//    pointers admit no common aligned start) take a scalar path in the same
//    launch;
//  * a thread holds 8 rows at a time (4, 2, 1 for what is left of a chunk)
//    and walks spec by spec, factor by factor, with the rows innermost: the
//    factor's column, width, scale and offset are uniform and hoisted, the
//    products stay in registers, a column is re-read only from shared memory,
//    and a term over a narrow column is one 32 x 32 -> 64 multiply and an add;
//  * a spec whose factors begin with all the factors of the spec before it
//    (TPC-H Q1: price, price x (1 - discount), price x (1 - discount) x
//    (1 + tax)) goes on from that spec's product instead of starting again;
//  * the table is privatised (copy index fastest, one copy per lane), so no
//    two lanes of a warp add to one address, and the adds are native 32-bit
//    shared atomics with a carry, not the 64-bit compare-and-swap loop;
//  * 64 registers a thread and about 54 KB of shared memory a block keep four
//    blocks (32 warps) resident on a multiprocessor: fewer measured slower;
//  * one publish per block: copies summed by a shuffle tree, one global
//    atomic per non-zero cell, output laid out [specs][groups].
//
// The entry point launches on the stream it is given, allocates nothing, does
// not synchronise, and returns a cudaError_t as an int (0 = launched).

#include "grouped_common.cuh"

namespace {

using namespace velox;

constexpr int kMaxSpecs = 16;    // sum specs of one launch
constexpr int kMaxFactors = 48;  // affine factors over all specs

struct PieceFactor {
  int32_t col;
  int32_t narrow_scale;  // 1 when the scale fits in 32 bits
  i64 scale;
  i64 offset;
};

struct PieceArgs {
  Geometry geom;
  StagedArrays arrays;  // the columns, then the group ids (int8 or int32) last
  int32_t n_specs;
  int32_t num_groups;
  int32_t spec_start[kMaxSpecs + 1];  // factors of spec s: [start[s], start[s+1])
  int32_t spec_reuse[kMaxSpecs];      // leading factors of spec s that are all of spec s - 1
  PieceFactor factors[kMaxFactors];
  u64* out;  // [n_specs][num_groups], zeroed by the caller
};

// prod[j] = (or *=) scale * col[idx[j]] + offset for the thread's rows.
// NARROW: the column is at most 4 bytes wide and the scale fits in 32 bits, so
// the term is one 32 x 32 + 64 -> 64 multiply-add.
template <typename T, bool FIRST, bool NARROW, int ROWS>
__device__ __forceinline__ void factor_step(i64 (&prod)[ROWS], const void* col,
                                            const int (&idx)[ROWS], i64 scale, i64 offset) {
  const T* c = static_cast<const T*>(col);
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    i64 term;
    if (NARROW) {
      asm("mad.wide.s32 %0, %1, %2, %3;"
          : "=l"(term)
          : "r"(static_cast<int32_t>(c[idx[j]])), "r"(static_cast<int32_t>(scale)), "l"(offset));
    } else {
      term = scale * static_cast<i64>(c[idx[j]]) + offset;
    }
    prod[j] = FIRST ? term : prod[j] * term;
  }
}

template <bool FIRST, int ROWS>
__device__ __forceinline__ void factor_step_any(i64 (&prod)[ROWS], const unsigned char* stage,
                                                const StagedArrays& arrays,
                                                const PieceFactor& f, const int (&idx)[ROWS]) {
  const void* col = stage + arrays.stage_off[f.col];
  const int width = arrays.width[f.col];
  if (f.narrow_scale && width != 8) {
    switch (width) {
      case 1:
        factor_step<int8_t, FIRST, true, ROWS>(prod, col, idx, f.scale, f.offset);
        break;
      case 2:
        factor_step<int16_t, FIRST, true, ROWS>(prod, col, idx, f.scale, f.offset);
        break;
      default:
        factor_step<int32_t, FIRST, true, ROWS>(prod, col, idx, f.scale, f.offset);
        break;
    }
    return;
  }
  switch (width) {
    case 1:
      factor_step<int8_t, FIRST, false, ROWS>(prod, col, idx, f.scale, f.offset);
      break;
    case 2:
      factor_step<int16_t, FIRST, false, ROWS>(prod, col, idx, f.scale, f.offset);
      break;
    case 4:
      factor_step<int32_t, FIRST, false, ROWS>(prod, col, idx, f.scale, f.offset);
      break;
    default:
      factor_step<int64_t, FIRST, false, ROWS>(prod, col, idx, f.scale, f.offset);
      break;
  }
}

// ROWS rows of every thread, kThreads * ROWS rows of the chunk from `base`.
// Only the ROWS == 1 step may reach past the chunk's last row.
template <int ROWS>
__device__ __forceinline__ void piece_subtile(const PieceArgs& a, const BlockMemory& m,
                                              const unsigned char* stage, int rows, int base) {
  const int cells = a.n_specs, groups = a.num_groups;
  const int gid_arr = a.arrays.count - 1;
  const void* gid = stage + a.arrays.stage_off[gid_arr];
  const bool gid8 = a.arrays.width[gid_arr] == 1;
  const int spec_stride = a.geom.lane_copies * 4;  // table bytes between two specs
  const int row_stride = cells * spec_stride;                  // and between two groups
  int idx[ROWS];        // the row inside the chunk
  uint32_t slot[ROWS];  // shared-memory address of the first word of the row's group
  bool alive[ROWS];
  bool any = false;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = base + j * kThreads + static_cast<int>(threadIdx.x);
    const bool inside = ROWS > 1 || r < rows;
    idx[j] = inside ? r : rows - 1;  // every read stays inside the stage
    const int grp = gid8 ? static_cast<const int8_t*>(gid)[idx[j]]
                         : static_cast<const int32_t*>(gid)[idx[j]];
    alive[j] = inside && grp >= 0 && grp < groups;
    slot[j] = m.my_table + grp * row_stride;
    any = any || alive[j];
  }
  if (!any) return;
  i64 prod[ROWS];  // lives across specs: a spec that extends the one before it goes on from it
  for (int s = 0; s < cells; ++s) {
    const int k0 = a.spec_start[s], k1 = a.spec_start[s + 1];
    if (k0 == k1) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) prod[j] = 1;  // the empty spec counts live rows
    } else {
      int k = k0 + a.spec_reuse[s];
      if (k == k0) factor_step_any<true, ROWS>(prod, stage, a.arrays, a.factors[k++], idx);
      for (; k < k1; ++k) {
        factor_step_any<false, ROWS>(prod, stage, a.arrays, a.factors[k], idx);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (alive[j]) {
        table_add(slot[j] + s * spec_stride, m.hi_offset, static_cast<u64>(prod[j]));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
grouped_piece_sums_kernel(const __grid_constant__ PieceArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry& g = a.geom;
  const int cells = a.n_specs, groups = a.num_groups;
  const BlockMemory m = carve(smem, g, groups * cells);
  block_begin(m, g, groups * cells);

  for_each_chunk(m, g, a.arrays, [&](const unsigned char* stage, int rows) {
    int base = 0;
    for (; base + kThreads * 8 <= rows; base += kThreads * 8) {
      piece_subtile<8>(a, m, stage, rows, base);
    }
    if (base + kThreads * 4 <= rows) {
      piece_subtile<4>(a, m, stage, rows, base);
      base += kThreads * 4;
    }
    if (base + kThreads * 2 <= rows) {
      piece_subtile<2>(a, m, stage, rows, base);
      base += kThreads * 2;
    }
    for (; base < rows; base += kThreads) piece_subtile<1>(a, m, stage, rows, base);
  });

  const int gid_arr = a.arrays.count - 1;
  const int gid_width = a.arrays.width[gid_arr];
  const int spec_stride = g.lane_copies * 4;
  const int row_stride = cells * spec_stride;
  for_each_edge_row(g, [&](i64 i) {
    const int grp = static_cast<int>(load_int(a.arrays.ptr[gid_arr], gid_width, i));
    if (grp < 0 || grp >= groups) return;
    const uint32_t row = m.my_table + grp * row_stride;
    for (int s = 0; s < cells; ++s) {
      i64 prod = 1;
      for (int k = a.spec_start[s]; k < a.spec_start[s + 1]; ++k) {
        const int c = a.factors[k].col;
        prod *= a.factors[k].scale * load_int(a.arrays.ptr[c], a.arrays.width[c], i) +
                a.factors[k].offset;
      }
      table_add(row + s * spec_stride, m.hi_offset, static_cast<u64>(prod));
    }
  });

  publish(m, g, groups, cells, a.out);
}

}  // namespace

// Pointer arguments named *_host are host arrays read during the call; every
// other pointer is device memory.  `arrays_host` / `widths_host` /
// `stage_off_host` list the columns first and the group ids last.
extern "C" int velox_grouped_piece_sums(
    const void* const* arrays_host, const int* widths_host, const int* stage_off_host,
    int n_arrays, const long long* geometry_host, const int* spec_start_host, int n_specs,
    const int* factor_col_host, const long long* factor_scale_host,
    const long long* factor_offset_host, int num_groups, void* out, void* stream) {
  const int ncols = n_arrays - 1;
  if (ncols < 0 || ncols > kMaxCols || n_specs < 1 || n_specs > kMaxSpecs || num_groups < 1) {
    return cudaErrorInvalidValue;
  }
  const int gid_width = widths_host[ncols];
  if (gid_width != 1 && gid_width != 4) return cudaErrorInvalidValue;
  const int n_factors = spec_start_host[n_specs];
  if (n_factors < 0 || n_factors > kMaxFactors) return cudaErrorInvalidValue;
  PieceArgs a;
  a.geom = geometry_from_host(geometry_host);
  a.arrays.count = n_arrays;
  for (int k = 0; k < kMaxArrays; ++k) {
    a.arrays.ptr[k] = k < n_arrays ? static_cast<const unsigned char*>(arrays_host[k]) : nullptr;
    a.arrays.width[k] = k < n_arrays ? widths_host[k] : 0;
    a.arrays.stage_off[k] = k < n_arrays ? stage_off_host[k] : 0;
  }
  a.n_specs = n_specs;
  a.num_groups = num_groups;
  for (int s = 0; s <= kMaxSpecs; ++s) {
    a.spec_start[s] = s <= n_specs ? spec_start_host[s] : n_factors;
  }
  for (int k = 0; k < kMaxFactors; ++k) {
    a.factors[k].col = k < n_factors ? factor_col_host[k] : 0;
    a.factors[k].scale = k < n_factors ? factor_scale_host[k] : 0;
    a.factors[k].narrow_scale = a.factors[k].scale == static_cast<int32_t>(a.factors[k].scale);
    a.factors[k].offset = k < n_factors ? factor_offset_host[k] : 0;
    if (k < n_factors && (a.factors[k].col < 0 || a.factors[k].col >= ncols)) {
      return cudaErrorInvalidValue;
    }
  }
  for (int s = 0; s < kMaxSpecs; ++s) {
    a.spec_reuse[s] = 0;
    if (s == 0 || s >= n_specs) continue;
    const int p0 = a.spec_start[s - 1], len = a.spec_start[s] - p0, k0 = a.spec_start[s];
    if (len == 0 || a.spec_start[s + 1] - k0 < len) continue;
    bool same = true;
    for (int k = 0; k < len && same; ++k) {
      const PieceFactor &x = a.factors[p0 + k], &y = a.factors[k0 + k];
      same = x.col == y.col && x.scale == y.scale && x.offset == y.offset;
    }
    if (same) a.spec_reuse[s] = len;
  }
  a.out = static_cast<u64*>(out);
  if (check_geometry(a.geom, a.arrays, num_groups * n_specs) != 0) return cudaErrorInvalidValue;
  return launch(grouped_piece_sums_kernel, a, a.geom, stream);
}
