// velox_dict_like: SQL LIKE over every entry of a string dictionary, for a
// pattern made only of literal text and '%' (ops/dict_like.py).
//
// Replaces no TPU kernel.  The JAX package evaluates LIKE once per dictionary
// entry in host Python while the plan is bound; over the 15 M distinct
// o_comment values of TPC-H at SF 10 that is about 10 s of every Q13 plan.
// This kernel does the same work on the card when the query runs.
//
// What it computes: out[i] = 1 when entry i, the bytes
// data[offsets[i] .. offsets[i+1]), matches `prefix % m1 % ... % mk % suffix`:
// it starts with prefix, ends with suffix (the two not overlapping) and holds
// m1 .. mk in order between them, each taken at its leftmost place after the
// previous one, which is exact for such patterns; with `exact` set the entry
// must equal prefix.  Matching UTF-8 bytes is exact for UTF-8 text.
//
// What bounds it on the H100: bytes, once the search for a segment costs
// little a byte.  Every entry's bytes and its offset are read once from device
// memory and one byte an entry is written.
//
// What the design does about it: a block takes 256 entries (one a thread),
// and the grid covers the dictionary in one pass.  Their offsets come in with
// one coalesced load, and their bytes, which lie end to end, are staged into
// shared memory with 16-byte loads that neighbouring threads take from
// neighbouring addresses, several in flight a thread (the unaligned head and
// tail byte by byte).  Each thread then matches its own entry in shared
// memory.  A middle segment is searched eight bytes a step: two aligned
// words, each byte equal to the segment's first byte and followed by its
// second marked at once by bit tricks, and only the marked places compared
// in full.  A byte at a time, this search took 5.4 ms over Q13's 15 M
// comments on an H100 SXM, against 0.74 ms this way.  Entries too long for
// the stage are matched from where they lie, a byte at a time, so that no
// load passes the end of the bytes.  The pattern sits in shared memory.
//
// The entry point launches on the stream it is given, allocates nothing, does
// not synchronise, and returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;              // entries a block matches at a time
constexpr int kStageBytes = 24 * 1024;     // their bytes, when they fit (8 blocks an SM)
constexpr int kMaxPatternBytes = 1024;     // ops/dict_like.py MAX_PATTERN_BYTES
constexpr int kMaxSegments = 32;           // middle segments, MAX_SEGMENTS
constexpr int kLoads = 4;                  // 16-byte loads a thread issues together
constexpr int kStageSlack = 32;            // the line's shift and find<true>'s reads past the end

struct LikeArgs {
  const uint8_t* data;
  const void* offsets;  // int32 or int64, entries + 1
  long long entries;
  uint8_t* out;
  int text_len;
  int nmid;
  int exact;
  int seg_len[kMaxSegments + 2];  // prefix, the middle segments, suffix
  uint8_t text[kMaxPatternBytes];  // their bytes, in that order
};

__device__ __forceinline__ bool same(const uint8_t* s, const uint8_t* t, int k) {
  for (int j = 0; j < k; ++j) {
    if (s[j] != t[j]) return false;
  }
  return true;
}

// 0x80 in each byte of x that is zero, 0 elsewhere (exact: no carry crosses
// a byte)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}

// The leftmost place in [pos, last] where seg (k bytes) starts in s, or -1.
// kWords: eight bytes a step, reading up to 11 bytes past s[last], which the
// stage's slack holds; else a byte at a time.
template <bool kWords>
__device__ __forceinline__ int find(const uint8_t* s, int pos, int last, const uint8_t* seg,
                                    int k) {
  const uint8_t head = seg[0];
  if (!kWords) {
    for (int i = pos; i <= last; ++i) {
      if (s[i] == head && same(s + i + 1, seg + 1, k - 1)) return i;
    }
    return -1;
  }
  const uint32_t heads = 0x01010101u * head;
  const uint32_t seconds = 0x01010101u * (k > 1 ? seg[1] : 0);
  const uint32_t any_second = k > 1 ? 0u : 0x80808080u;
  for (int i = pos; i <= last;) {
    // the two aligned words from the one holding s[i]; a place is marked
    // when its byte is the head and the next byte the second
    const uintptr_t at = reinterpret_cast<uintptr_t>(s + i);
    const int off = static_cast<int>(at & 3);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(at - off);
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
    const uint32_t h0 = zero_bytes(w0 ^ heads) &
                        (zero_bytes(__funnelshift_r(w0, w1, 8) ^ seconds) | any_second);
    const uint32_t h1 = zero_bytes(w1 ^ heads) &
                        (zero_bytes(__funnelshift_r(w1, w2, 8) ^ seconds) | any_second);
    unsigned long long hit =
        (static_cast<unsigned long long>(h1) << 32 | h0) & (~0ull << (8 * off));
    while (hit) {
      const int cand = i - off + (__ffsll(static_cast<long long>(hit)) - 1) / 8;
      if (cand > last) return -1;
      if (same(s + cand + 1, seg + 1, k - 1)) return cand;
      hit &= hit - 1;
    }
    i += 8 - off;
  }
  return -1;
}

template <bool kWords>
__device__ __forceinline__ bool matches(const uint8_t* s, int len, const uint8_t* text,
                                        const int* seg_len, int nmid, int exact) {
  const int p = seg_len[0];
  const int q = seg_len[nmid + 1];
  if (exact) return len == p && same(s, text, p);
  if (len < p + q || !same(s, text, p)) return false;
  const int limit = len - q;  // the middle segments end at or before it
  int t = p;
  for (int m = 0; m < nmid; ++m) t += seg_len[1 + m];
  if (!same(s + limit, text + t, q)) return false;
  int pos = p;
  t = p;
  for (int m = 0; m < nmid; ++m) {
    const int k = seg_len[1 + m];
    const int at = find<kWords>(s, pos, limit - k, text + t, k);
    if (at < 0) return false;
    pos = at + k;
    t += k;
  }
  return true;
}

template <typename Off>
__global__ void __launch_bounds__(kThreads) dict_like_kernel(const LikeArgs a) {
  __shared__ __align__(16) uint8_t stage[kStageBytes + kStageSlack];
  __shared__ long long soff[kThreads + 1];
  __shared__ uint8_t text[kMaxPatternBytes];
  __shared__ int seg_len[kMaxSegments + 2];
  const int tid = static_cast<int>(threadIdx.x);
  for (int j = tid; j < a.text_len; j += kThreads) text[j] = a.text[j];
  for (int j = tid; j < a.nmid + 2; j += kThreads) seg_len[j] = a.seg_len[j];
  const Off* offsets = static_cast<const Off*>(a.offsets);
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int count = static_cast<int>(min(static_cast<long long>(kThreads), a.entries - first));
  for (int j = tid; j <= count; j += kThreads) soff[j] = static_cast<long long>(offsets[first + j]);
  __syncthreads();
  const long long lo = soff[0];
  const long long n = soff[count] - lo;
  const bool staged = n <= kStageBytes;  // the same for every thread of the block
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.data + lo);
  const int shift = static_cast<int>(addr & 15);  // the stage starts at addr's 16-byte line
  if (staged) {
    const uintptr_t end = addr + static_cast<uintptr_t>(n);
    const uintptr_t body = (addr + 15) & ~static_cast<uintptr_t>(15);
    const uintptr_t tail = end & ~static_cast<uintptr_t>(15);
    const uintptr_t base = addr - shift;
    if (body < tail) {
      // kLoads lines a thread in flight at once, then into the stage
      constexpr uintptr_t kStride = 16 * kThreads;
      for (uintptr_t c0 = body + 16 * static_cast<uintptr_t>(tid); c0 < tail;
           c0 += kLoads * kStride) {
        uint4 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const uintptr_t c = c0 + u * kStride;
          if (c < tail) v[u] = *reinterpret_cast<const uint4*>(c);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const uintptr_t c = c0 + u * kStride;
          if (c < tail) *reinterpret_cast<uint4*>(stage + (c - base)) = v[u];
        }
      }
      for (uintptr_t b = addr + tid; b < body; b += kThreads) {
        stage[b - base] = *reinterpret_cast<const uint8_t*>(b);
      }
      for (uintptr_t b = tail + tid; b < end; b += kThreads) {
        stage[b - base] = *reinterpret_cast<const uint8_t*>(b);
      }
    } else {  // no whole 16-byte line inside: byte by byte
      for (uintptr_t b = addr + tid; b < end; b += kThreads) {
        stage[b - base] = *reinterpret_cast<const uint8_t*>(b);
      }
    }
  }
  __syncthreads();
  if (tid < count) {
    const long long at = soff[tid] - lo;
    const int len = static_cast<int>(soff[tid + 1] - soff[tid]);
    const bool m = staged ? matches<true>(stage + shift + at, len, text, seg_len, a.nmid, a.exact)
                          : matches<false>(a.data + lo + at, len, text, seg_len, a.nmid, a.exact);
    a.out[first + tid] = m ? 1 : 0;
  }
}

}  // namespace

extern "C" int velox_dict_like(const void* data, const void* offsets, int offsets64,
                               long long entries, const void* text, int text_len,
                               const int* seg_len_host, int nmid, int exact, void* out,
                               void* stream) {
  if (entries <= 0) return 0;
  if (text_len < 0 || text_len > kMaxPatternBytes || nmid < 0 || nmid > kMaxSegments) {
    return cudaErrorInvalidValue;
  }
  LikeArgs a;
  a.data = static_cast<const uint8_t*>(data);
  a.offsets = offsets;
  a.entries = entries;
  a.out = static_cast<uint8_t*>(out);
  a.text_len = text_len;
  a.nmid = nmid;
  a.exact = exact;
  for (int j = 0; j < kMaxSegments + 2; ++j) a.seg_len[j] = j < nmid + 2 ? seg_len_host[j] : 0;
  memset(a.text, 0, sizeof(a.text));
  if (text_len > 0) memcpy(a.text, text, static_cast<size_t>(text_len));
  const long long blocks = (entries + kThreads - 1) / kThreads;  // one a block, all in one wave
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (offsets64) {
    dict_like_kernel<int64_t><<<static_cast<int>(blocks), kThreads, 0, s>>>(a);
  } else {
    dict_like_kernel<int32_t><<<static_cast<int>(blocks), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
