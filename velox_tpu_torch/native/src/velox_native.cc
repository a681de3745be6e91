// Native runtime kernels for the host half of the engine.
//
// The port's own copy of the JAX package's velox_native.cc: the same
// functions and the same byte streams, so pages written by either package
// decode in the other.  The host-side pieces that stay hot are native:
//   * string-dictionary interning (reference: velox/exec/VectorHasher.h value
//     ids and the dwrf string-dictionary writers) — the ingest hot path that
//     turns raw UTF-8 columns into device int32 code vectors;
//   * integer column codec: zigzag varint with run-length escapes (reference:
//     velox/dwio/common RLE/IntDecoder encoders, used by spill files and the
//     PrestoPage analog in serde/page.py).
//
// Exposed as a plain C ABI for ctypes.  Built at first use by
// velox_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// String interning.
//
// Input: a concatenated UTF-8 blob with n+1 offsets (Arrow string layout).
// Output: codes[i] = dictionary code of string i; uniq_idx[k] = row index of
// the first occurrence of dictionary entry k.  Code 0 is reserved for "" to
// match StringTable's canonical empty entry: if "" never occurs, entry 0 is
// still emitted with uniq_idx[0] == -1.
//
// Returns the number of dictionary entries (>= 1), or -1 on overflow.

static inline uint64_t hash_bytes(const uint8_t* p, int64_t len) {
  // FNV-1a, good enough for interning; collisions handled by full compare.
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < len; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

int64_t vx_intern_strings(const uint8_t* blob, const int64_t* offsets,
                          int64_t n, int32_t* codes, int64_t* uniq_idx,
                          int64_t uniq_cap) {
  // open-addressing table; size = next power of two >= 2n, min 16
  int64_t cap = 16;
  while (cap < 2 * (n + 1)) cap <<= 1;
  std::vector<int64_t> slots(cap, -1);  // holds dictionary entry id
  std::vector<int64_t> entry_off(1, -1), entry_len(1, 0);
  std::vector<uint64_t> entry_hash(1, hash_bytes(nullptr, 0));
  const uint64_t mask = cap - 1;
  // seed the empty string as entry 0
  {
    uint64_t h = entry_hash[0];
    uint64_t s = h & mask;
    slots[s] = 0;
  }
  if (uniq_cap < 1) return -1;
  uniq_idx[0] = -1;

  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = blob + offsets[i];
    const int64_t len = offsets[i + 1] - offsets[i];
    const uint64_t h = hash_bytes(p, len);
    uint64_t s = h & mask;
    for (;;) {
      int64_t e = slots[s];
      if (e < 0) {
        // new entry
        int64_t id = static_cast<int64_t>(entry_off.size());
        if (id >= uniq_cap || id > 0x7fffffff) return -1;
        entry_off.push_back(offsets[i]);
        entry_len.push_back(len);
        entry_hash.push_back(h);
        slots[s] = id;
        uniq_idx[id] = i;
        codes[i] = static_cast<int32_t>(id);
        break;
      }
      if (entry_hash[e] == h && entry_len[e] == len &&
          (len == 0 ||
           std::memcmp(blob + entry_off[e], p, static_cast<size_t>(len)) == 0)) {
        if (e == 0 && uniq_idx[0] < 0) uniq_idx[0] = i;
        codes[i] = static_cast<int32_t>(e);
        break;
      }
      s = (s + 1) & mask;
    }
  }
  return static_cast<int64_t>(entry_off.size());
}

// ---------------------------------------------------------------------------
// Integer codec: zigzag varint with run-length escapes.
//
// Stream of ops:
//   [runlen varint][value zigzag-varint]      runlen >= 1: value repeated
// Runs of length 1 cost 1 extra byte vs plain varint but keep decode trivial;
// repeated values (dictionary codes, dates, flags) compress dramatically.

static inline int vx_put_varint(uint64_t v, uint8_t* dst) {
  int k = 0;
  while (v >= 0x80) {
    dst[k++] = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  dst[k++] = static_cast<uint8_t>(v);
  return k;
}

static inline const uint8_t* vx_get_varint(const uint8_t* p, const uint8_t* end,
                                           uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end) {
    uint8_t b = *p++;
    v |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return p;
    }
    shift += 7;
    if (shift > 63) break;
  }
  return nullptr;
}

static inline uint64_t zigzag(int64_t v) {
  return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
}

static inline int64_t unzigzag(uint64_t v) {
  return static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
}

// Returns bytes written, or -1 if dst_cap too small.
int64_t vx_encode_i64(const int64_t* src, int64_t n, uint8_t* dst,
                      int64_t dst_cap) {
  int64_t w = 0;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i + 1;
    while (j < n && src[j] == src[i]) ++j;
    const uint64_t run = static_cast<uint64_t>(j - i);
    if (w + 20 > dst_cap) return -1;
    w += vx_put_varint(run, dst + w);
    w += vx_put_varint(zigzag(src[i]), dst + w);
    i = j;
  }
  return w;
}

// Returns values decoded, or -1 on malformed input / overflow of dst.
int64_t vx_decode_i64(const uint8_t* src, int64_t len, int64_t* dst,
                      int64_t n) {
  const uint8_t* p = src;
  const uint8_t* end = src + len;
  int64_t k = 0;
  while (p < end) {
    uint64_t run, zz;
    p = vx_get_varint(p, end, &run);
    if (p == nullptr) return -1;
    p = vx_get_varint(p, end, &zz);
    if (p == nullptr) return -1;
    if (k + static_cast<int64_t>(run) > n) return -1;
    const int64_t v = unzigzag(zz);
    for (uint64_t r = 0; r < run; ++r) dst[k++] = v;
  }
  return k;
}

// Delta variant: encodes differences (sorted keys, row numbers compress to
// almost nothing).  Same stream format over deltas; first delta is vs 0.
int64_t vx_encode_i64_delta(const int64_t* src, int64_t n, uint8_t* dst,
                            int64_t dst_cap) {
  std::vector<int64_t> deltas(static_cast<size_t>(n));
  int64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    deltas[i] = src[i] - prev;
    prev = src[i];
  }
  return vx_encode_i64(deltas.data(), n, dst, dst_cap);
}

int64_t vx_decode_i64_delta(const uint8_t* src, int64_t len, int64_t* dst,
                            int64_t n) {
  int64_t k = vx_decode_i64(src, len, dst, n);
  if (k < 0) return k;
  int64_t acc = 0;
  for (int64_t i = 0; i < k; ++i) {
    acc += dst[i];
    dst[i] = acc;
  }
  return k;
}

int32_t vx_abi_version() { return 1; }

}  // extern "C"
