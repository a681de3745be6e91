// velox_hash_build / velox_hash_probe: a hash table over the unique keys of a
// join's build side and one lookup a probe row (ops/hash_probe.py, K5).
//
// Replaces no TPU kernel.  The JAX package probes a unique-key join by a merge
// sort (velox_tpu/exec/joins.py:1295 _probe_fused, which is no Pallas kernel):
// it sorts the whole build side with every probe tile, in 64-bit words, and
// scans for the last build row before each probe row, because on a TPU a sort
// beats scattered lookups.  On Hopper a lookup into a table of 4-byte slots
// costs one or two sectors, and only a live row needs one.  The reference
// probes a hash table too (velox/exec/HashTable.cpp:360).
//
// What it computes.  The build kernel inserts the slot ids 0 .. n-1 of the
// build's sorted, unique, valid keys into an open-addressing table of
// 2^log2cap int32 slots (-1: empty) by linear probing from a multiplicative
// hash of the key; the caller fills the table with -1 and makes it at least
// twice the keys, so a walk always ends at an empty slot.  The probe kernel
// writes, for probe row i, the build slot id whose key equals keys[i], or -1
// when the row is dead (i >= *length, or its selection byte is 0), its key is
// NULL (its validity byte is 0), lies outside [kmin, kmax], or is not in the
// table.  Keys are read in their stored width (1, 2, 4 or 8 bytes) and
// compared as int64.  With max_walk set, the probe also records the longest
// walk (slots read by one row) with one atomic a warp.
//
// The hash is Fibonacci hashing: the key times 2^64 / phi, its top log2cap
// bits.  Taking the key modulo the capacity would cluster TPC-H's order keys,
// which use 8 values out of every 32.
//
// What bounds it on the H100: bytes.  A probe row costs its selection byte,
// its validity byte, 4 bytes out and, for a live row, its key; only a live
// row with a key in range reads the table (one int32 slot, then the 8-byte
// build key it names, for each slot walked).  Q12 at SF 10 keeps about 0.5 %
// of a 2^24-row tile live, so the launch moves about 16 MiB of selection and
// 64 MiB of slot ids.
//
// The entry points launch on the stream they are given, allocate nothing, do
// not synchronise, and return cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;  // 2^64 / phi

__device__ __forceinline__ unsigned long long home(long long key, int log2cap) {
  return (static_cast<unsigned long long>(key) * kGolden) >> (64 - log2cap);
}

__global__ void hash_build_kernel(const long long* __restrict__ keys, long long n,
                                  int* __restrict__ slots, int log2cap) {
  const unsigned long long mask = (1ull << log2cap) - 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned long long s = home(keys[i], log2cap);
    // the keys are unique: a taken slot holds another key, so walk on
    while (atomicCAS(&slots[s], -1, static_cast<int>(i)) != -1) s = (s + 1) & mask;
  }
}

struct ProbeArgs {
  const int* length;       // rows live below it
  const uint8_t* sel;      // selection bytes, or null: every row below length
  const uint8_t* valid;    // key validity bytes, or null: no NULL key
  long long rows;
  const long long* build_keys;
  const int* slots;
  int log2cap;
  long long kmin, kmax;
  int* out;
  int* max_walk;  // or null
};

template <typename K>
__global__ void hash_probe_kernel(const K* __restrict__ keys, ProbeArgs a) {
  const unsigned long long mask = (1ull << a.log2cap) - 1;
  const long long len = *a.length;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int longest = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.rows;
       i += stride) {
    int found = -1;
    if (i < len && (a.sel == nullptr || a.sel[i]) && (a.valid == nullptr || a.valid[i])) {
      const long long key = static_cast<long long>(keys[i]);
      if (key >= a.kmin && key <= a.kmax) {
        unsigned long long s = home(key, a.log2cap);
        int walk = 0;
        for (;;) {
          const int id = a.slots[s];
          ++walk;
          if (id < 0) break;
          if (a.build_keys[id] == key) {
            found = id;
            break;
          }
          s = (s + 1) & mask;
        }
        longest = max(longest, walk);
      }
    }
    a.out[i] = found;
  }
  if (a.max_walk != nullptr) {
    longest = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(longest)));
    if ((threadIdx.x & 31) == 0 && longest > 0) atomicMax(a.max_walk, longest);
  }
}

int blocks_for(long long rows, int max_blocks) {
  const long long want = (rows + kThreads - 1) / kThreads;
  return static_cast<int>(want < max_blocks ? want : max_blocks);
}

}  // namespace

extern "C" int velox_hash_build(const void* keys, long long n, void* slots, int log2cap,
                                int max_blocks, void* stream) {
  if (log2cap < 1 || log2cap > 31 || max_blocks < 1 || n >= (1ll << log2cap)) {
    return cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  hash_build_kernel<<<blocks_for(n, max_blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, static_cast<int*>(slots), log2cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int velox_hash_probe(const void* keys, int key_bytes, const void* length,
                                const void* sel, const void* valid, long long rows,
                                const void* build_keys, const void* slots, int log2cap,
                                long long kmin, long long kmax, void* out, void* max_walk,
                                int max_blocks, void* stream) {
  if (log2cap < 1 || log2cap > 31 || max_blocks < 1) return cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  ProbeArgs a;
  a.length = static_cast<const int*>(length);
  a.sel = static_cast<const uint8_t*>(sel);
  a.valid = static_cast<const uint8_t*>(valid);
  a.rows = rows;
  a.build_keys = static_cast<const long long*>(build_keys);
  a.slots = static_cast<const int*>(slots);
  a.log2cap = log2cap;
  a.kmin = kmin;
  a.kmax = kmax;
  a.out = static_cast<int*>(out);
  a.max_walk = static_cast<int*>(max_walk);
  const int blocks = blocks_for(rows, max_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_bytes) {
    case 1:
      hash_probe_kernel<int8_t><<<blocks, kThreads, 0, s>>>(static_cast<const int8_t*>(keys), a);
      break;
    case 2:
      hash_probe_kernel<int16_t><<<blocks, kThreads, 0, s>>>(static_cast<const int16_t*>(keys), a);
      break;
    case 4:
      hash_probe_kernel<int32_t><<<blocks, kThreads, 0, s>>>(static_cast<const int32_t*>(keys), a);
      break;
    case 8:
      hash_probe_kernel<int64_t><<<blocks, kThreads, 0, s>>>(static_cast<const int64_t*>(keys), a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
