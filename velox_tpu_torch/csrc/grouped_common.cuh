// Device code shared by the two grouped-sum kernels (grouped_piece_sums.cu,
// grouped_int64_sums.cu): the staging ring that brings the input columns into
// shared memory with bulk asynchronous copies, the privatised accumulator
// table, and the publish step.
//
// The launch geometry (head / body / tail split, chunk rows, stages, table
// copies, shared-memory bytes, blocks) is chosen on the host by
// ops/launch_geometry.py and arrives here as numbers; nothing in this file
// decides it.
//
// Staging ring.  The aligned body of the rows is cut into chunks of
// `chunk_rows`.  A persistent block walks the chunks blockIdx.x, blockIdx.x +
// gridDim.x, ...  For each chunk one thread issues one
// `cp.async.bulk.shared::cluster.global` copy per input array into a stage of
// the ring and the hardware reports the bytes to the stage's mbarrier; the
// copies of the next `stages - 1` chunks are in flight while the block sums
// the current one out of shared memory.  So every input byte of the body is
// read from device memory once, by a bulk copy, whatever the column's width.
// A stage is handed back by the __syncthreads() that ends a chunk.
//
// Accumulator table.  One logical table has `q_cells = groups * cells`
// 64-bit accumulators.  It is kept in `lane_copies` (R, a power of two <= 32)
// copies with the copy index fastest: word (g * cells + c) * R + (lane % R).
// With R = 32 no two lanes of a warp ever add to one address.  The low and the
// high halves of the words lie in two planes of 32-bit words (all low halves,
// then all high halves), so that the 32 lanes of a warp, each on its own copy
// of one cell, touch 32 consecutive 4-byte words: 32 banks, no bank conflict.
//
// The warps of a block share the R copies, so the add is atomic.  A 64-bit
// shared atomicAdd compiles to a compare-and-swap loop on this card
// (ATOMS.CAST.SPIN.64 in the SASS) and measured 1.75x slower in the whole
// kernel, so the add is made of native 32-bit atomics: ATOMS.ADD on the low
// word, which returns the old value, the carry worked out from it, and a
// second 32-bit add of high word plus carry when that is not zero.  Every wrap
// of the low word adds exactly one carry, so the pair is exact mod 2^64 in any
// order.  (A table per warp with plain load / add / store, no atomics at all,
// also measured slower: its 8 x 32 copies leave room for one resident block a
// multiprocessor, and the kernels want four.)
//
// Publish.  After its last chunk the block sums the copies of every cell (a
// warp per cell, lanes over copies, shuffle tree) and adds each non-zero cell
// to the output with one global atomic.  The output is [cells][groups], zeroed
// by the caller.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace velox {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16;            // column operands of one launch
constexpr int kMaxArrays = kMaxCols + 2;  // + group ids (+ mask)
constexpr int kMaxStages = 8;
constexpr int kMaxSharedBytes = 232448; // 227 KB, the most one block may ask for
constexpr int kBarrierBytes = 128;      // the mbarriers, padded so stages stay aligned

typedef unsigned long long u64;
typedef long long i64;

// What the host decided for this launch (ops/launch_geometry.py Geometry).
struct Geometry {
  i64 n;           // all rows
  i64 head;        // rows [0, head) take the scalar path
  i64 body_rows;   // rows [head, head + body_rows) are staged; multiple of 16
  int32_t chunk_rows;   // rows of one stage; multiple of 16
  int32_t stages;       // 2..kMaxStages
  int32_t stage_bytes;  // bytes of one stage; multiple of 128
  int32_t lane_copies;  // R
  int32_t smem_bytes;   // dynamic shared memory of the launch
  int32_t blocks;
};

// The arrays of one launch as the ring sees them.
struct StagedArrays {
  const unsigned char* ptr[kMaxArrays];  // element 0 of each array
  int32_t width[kMaxArrays];             // bytes per element: 1, 2, 4 or 8
  int32_t stage_off[kMaxArrays];         // byte offset of the array's slice in a stage
  int32_t count;
};

// One integer element at its stored width (1, 2, 4 or 8 bytes, signed).
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier and bulk copy (PTX; sm_90)

__device__ __forceinline__ void mbar_init(u64* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u64* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Blocks until the barrier has left the phase of the given parity.
__device__ __forceinline__ void mbar_wait(u64* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (multiple of 16) from 16-byte aligned device memory to 16-byte
// aligned shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// The block's shared memory: [mbarriers | stages | table]

struct BlockMemory {
  u64* bars;
  unsigned char* stages;
  uint32_t* table;     // [q_cells][lane_copies] low halves, then as many high halves
  uint32_t my_table;   // shared-memory byte address of the low half of this thread's copy of word 0
  uint32_t hi_offset;  // bytes from a word's low half to its high half
};

__device__ __forceinline__ BlockMemory carve(unsigned char* smem, const Geometry& g,
                                             int q_cells) {
  BlockMemory m;
  m.bars = reinterpret_cast<u64*>(smem);
  m.stages = smem + kBarrierBytes;
  m.table = reinterpret_cast<uint32_t*>(m.stages + static_cast<size_t>(g.stages) * g.stage_bytes);
  m.hi_offset = 4 * q_cells * g.lane_copies;
  m.my_table = smem_addr(m.table + (threadIdx.x & (g.lane_copies - 1)));
  return m;
}

// Barriers initialised, table zeroed; ends in a __syncthreads().
__device__ __forceinline__ void block_begin(const BlockMemory& m, const Geometry& g,
                                            int q_cells) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) mbar_init(m.bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int halves = 2 * q_cells * g.lane_copies;
  for (int i = threadIdx.x; i < halves; i += kThreads) m.table[i] = 0;
  __syncthreads();
}

__device__ __forceinline__ i64 chunk_count(const Geometry& g) {
  return (g.body_rows + g.chunk_rows - 1) / g.chunk_rows;
}

__device__ __forceinline__ int rows_of_chunk(const Geometry& g, i64 chunk) {
  const i64 left = g.body_rows - chunk * g.chunk_rows;
  return static_cast<int>(left < g.chunk_rows ? left : g.chunk_rows);
}

// One thread starts the copies of `chunk` into stage `stage`.
__device__ __forceinline__ void issue_chunk(const BlockMemory& m, const Geometry& g,
                                            const StagedArrays& a, i64 chunk, int stage) {
  const int rows = rows_of_chunk(g, chunk);
  const i64 first = g.head + chunk * g.chunk_rows;
  unsigned char* dst = m.stages + static_cast<size_t>(stage) * g.stage_bytes;
  uint32_t total = 0;
  for (int k = 0; k < a.count; ++k) total += static_cast<uint32_t>(rows) * a.width[k];
  mbar_expect_tx(m.bars + stage, total);
  for (int k = 0; k < a.count; ++k) {
    bulk_copy(dst + a.stage_off[k], a.ptr[k] + first * a.width[k],
              static_cast<uint32_t>(rows) * a.width[k], m.bars + stage);
  }
}

// Walks this block's chunks through the ring and calls
// consume(stage base pointer, rows in the chunk) on each, all threads together.
template <class Consume>
__device__ __forceinline__ void for_each_chunk(const BlockMemory& m, const Geometry& g,
                                               const StagedArrays& a, Consume consume) {
  const i64 chunks = chunk_count(g);
  const i64 first = blockIdx.x, step = gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages - 1; ++s) {
      const i64 c = first + s * step;
      if (c < chunks) issue_chunk(m, g, a, c, s);
    }
  }
  int stage = 0;
  uint32_t parity = 0;
  for (i64 c = first; c < chunks; c += step) {
    if (threadIdx.x == 0) {
      // the stage consumed one iteration ago is free since the __syncthreads below
      const i64 ahead = c + static_cast<i64>(g.stages - 1) * step;
      const int into = stage == 0 ? g.stages - 1 : stage - 1;
      if (ahead < chunks) issue_chunk(m, g, a, ahead, into);
    }
    mbar_wait(m.bars + stage, parity);
    consume(m.stages + static_cast<size_t>(stage) * g.stage_bytes, rows_of_chunk(g, c));
    __syncthreads();
    if (++stage == g.stages) {
      stage = 0;
      parity ^= 1u;
    }
  }
}

// Calls row(i) for every row outside the staged body, spread over the grid.
template <class Row>
__device__ __forceinline__ void for_each_edge_row(const Geometry& g, Row row) {
  const i64 body_end = g.head + g.body_rows;
  const i64 edge = g.head + (g.n - body_end);
  const i64 stride = static_cast<i64>(gridDim.x) * kThreads;
  for (i64 e = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x; e < edge; e += stride) {
    row(e < g.head ? e : body_end + (e - g.head));
  }
}

// ---------------------------------------------------------------------------
// The 64-bit table word whose low half is at shared-memory byte address `cell`
// and whose high half is `hi_offset` bytes after it += v
//
// Written in PTX on 32-bit shared addresses: one address register per row, the
// carry taken straight from the returned old low word (add.cc / addc), the high
// word added only when it is not zero.  (Issuing the low-word atomics of a
// thread's 8 rows first and the high words after them measured 11-13 % slower,
// twice.)

__device__ __forceinline__ void table_add(uint32_t cell, uint32_t hi_offset, u64 v) {
  asm volatile(
      "{\n"
      ".reg .u32 lo, hi, old, sum;\n"
      ".reg .pred p;\n"
      "mov.b64 {lo, hi}, %2;\n"
      "atom.shared.add.u32 old, [%0], lo;\n"
      "add.cc.u32 sum, old, lo;\n"
      "addc.u32 hi, hi, 0;\n"
      "setp.ne.u32 p, hi, 0;\n"
      "@p red.shared.add.u32 [%1], hi;\n"
      "}\n" ::"r"(cell),
      "r"(cell + hi_offset), "l"(v));
}

// Sums the copies of every cell and adds it to out[c * groups + g].
// Ends the block's work; starts with a __syncthreads().
__device__ __forceinline__ void publish(const BlockMemory& m, const Geometry& g, int groups,
                                        int cells, u64* out) {
  __syncthreads();
  const int q_cells = groups * cells;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < q_cells; q += kWarps) {
    u64 v = 0;
    if (lane < g.lane_copies) {
      const int word = q * g.lane_copies + lane;
      v = m.table[word] | static_cast<u64>(m.table[word + q_cells * g.lane_copies]) << 32;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0 && v != 0) {
      const int grp = q / cells, c = q - grp * cells;
      atomicAdd(out + c * groups + grp, v);
    }
  }
}

// Host side: checks what the device code relies on.  0 = fine.
inline int check_geometry(const Geometry& g, const StagedArrays& a, int q_cells) {
  if (g.n < 0 || g.head < 0 || g.body_rows < 0 || g.head + g.body_rows > g.n) return 1;
  if (g.body_rows % 16 != 0 || g.chunk_rows < 16 || g.chunk_rows % 16 != 0) return 1;
  if (g.stages < 2 || g.stages > kMaxStages || g.stage_bytes % 128 != 0) return 1;
  if (g.lane_copies < 1 || g.lane_copies > 32 || (g.lane_copies & (g.lane_copies - 1))) return 1;
  if (g.blocks < 1 || a.count < 1 || a.count > kMaxArrays) return 1;
  i64 need = 0;
  for (int k = 0; k < a.count; ++k) {
    const int w = a.width[k];
    if (w != 1 && w != 2 && w != 4 && w != 8) return 1;
    if (reinterpret_cast<uintptr_t>(a.ptr[k]) % w != 0) return 1;
    if (a.stage_off[k] % 16 != 0 || a.stage_off[k] < need) return 1;
    need = a.stage_off[k] + static_cast<i64>(g.chunk_rows) * w;
    if (g.body_rows > 0 &&
        (reinterpret_cast<uintptr_t>(a.ptr[k]) + static_cast<uintptr_t>(g.head) * w) % 16 != 0) {
      return 1;
    }
  }
  if (need > g.stage_bytes) return 1;
  const i64 table = 8LL * q_cells * g.lane_copies;
  if (kBarrierBytes + static_cast<i64>(g.stages) * g.stage_bytes + table > g.smem_bytes) return 1;
  if (g.smem_bytes > kMaxSharedBytes) return 1;
  return 0;
}

// Reads the host's geometry numbers (ops/launch_geometry.py Geometry.as_c()).
inline Geometry geometry_from_host(const long long* v) {
  Geometry g;
  g.n = v[0];
  g.head = v[1];
  g.body_rows = v[2];
  g.chunk_rows = static_cast<int32_t>(v[3]);
  g.stages = static_cast<int32_t>(v[4]);
  g.stage_bytes = static_cast<int32_t>(v[5]);
  g.lane_copies = static_cast<int32_t>(v[6]);
  g.smem_bytes = static_cast<int32_t>(v[7]);
  g.blocks = static_cast<int32_t>(v[8]);
  return g;
}

// Launches `kernel` with the geometry's blocks and shared memory, asking for
// more than 48 KB of dynamic shared memory first where the launch needs it.
template <class Args>
inline int launch(void (*kernel)(Args), const Args& args, const Geometry& g, void* stream) {
  if (g.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<g.blocks, kThreads, g.smem_bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace velox
