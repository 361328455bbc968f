// Native content-addressed IO runtime.
//
// The reference implements its storage layer natively (src/io.rs): artifacts
// stream through a SHA-256 hasher stacked under a zlib encoder, so the
// content hash covers the *stored* (compressed) bytes and is computed in the
// same pass that writes them (io.rs:90-129). This is the C++ equivalent,
// exposed through a C ABI for ctypes:
//
//   fio_pack    : payload -> (optionally deflated) bytes + URL-safe-base64
//                 SHA-256 name, one pass
//   fio_unpack  : stored bytes -> (optionally inflated) payload + hash of
//                 the stored bytes, one pass (verify-while-read,
//                 io.rs:258-300)
//   fio_hash    : standalone hash
//   fio_free    : release buffers returned by pack/unpack
//
// SHA-256 is implemented inline (FIPS 180-4) to avoid an OpenSSL dependency;
// zlib provides deflate at level 6, matching flate2's default used by the
// reference (io.rs:104).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

#include <zlib.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define FIO_X86 1
#endif

namespace {

// ---------------------------------------------------------------- sha-256 --

static const uint32_t kSha256K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

#ifdef FIO_X86
// Hardware SHA-256 (SHA-NI): ~8x the portable rounds on this image's
// hosts (measured 160 MB/s portable vs ~1.3 GB/s OpenSSL, which uses the
// same instructions). Runtime-dispatched; the portable implementation
// below stays the fallback and the correctness oracle
// (tests/test_native.py pins both against hashlib).
__attribute__((target("sha,sse4.1,ssse3")))
void sha256_blocks_shani(uint32_t state[8], const uint8_t* data,
                         size_t nblocks) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bLL, 0x0405060700010203LL);
  // Pack h[0..7] into the ABEF/CDGH register layout sha256rnds2 uses.
  __m128i TMP = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[0]));
  __m128i STATE1 =
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[4]));
  TMP = _mm_shuffle_epi32(TMP, 0xB1);
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);
  __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);

  while (nblocks--) {
    const __m128i ABEF_SAVE = STATE0;
    const __m128i CDGH_SAVE = STATE1;
    __m128i m[4];
    // 16 groups of 4 rounds; m[] cycles the 4-word message-schedule
    // registers (the unrolled Intel flow re-rolled: at group g, msg2
    // completes W[4(g+1)..] into m[(g+1)%4] and msg1 pre-stages
    // m[(g+3)%4]). Fully unrolled so the m[] indices are compile-time
    // and the four schedule registers stay in xmm (measured 2.9x).
#pragma GCC unroll 16
    for (int g = 0; g < 16; ++g) {
      __m128i msg;
      if (g < 4) {
        m[g] = _mm_shuffle_epi8(
            _mm_loadu_si128(
                reinterpret_cast<const __m128i*>(data + 16 * g)),
            MASK);
        msg = m[g];
      } else {
        msg = m[g & 3];
      }
      msg = _mm_add_epi32(
          msg, _mm_loadu_si128(
                   reinterpret_cast<const __m128i*>(&kSha256K[4 * g])));
      STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, msg);
      if (g >= 3 && g < 15) {
        __m128i nxt = _mm_add_epi32(
            m[(g + 1) & 3], _mm_alignr_epi8(m[g & 3], m[(g + 3) & 3], 4));
        m[(g + 1) & 3] = _mm_sha256msg2_epu32(nxt, m[g & 3]);
      }
      msg = _mm_shuffle_epi32(msg, 0x0E);
      STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, msg);
      if (g >= 1 && g < 13)
        m[(g + 3) & 3] = _mm_sha256msg1_epu32(m[(g + 3) & 3], m[g & 3]);
    }
    STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
    STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
    data += 64;
  }

  TMP = _mm_shuffle_epi32(STATE0, 0x1B);
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[0]), STATE0);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[4]), STATE1);
}

bool sha_ni_available() {
  static const bool ok = __builtin_cpu_supports("sha") &&
                         __builtin_cpu_supports("sse4.1") &&
                         __builtin_cpu_supports("ssse3");
  return ok;
}
#endif  // FIO_X86

struct Sha256 {
  uint32_t h[8];
  uint64_t bits;
  uint8_t buf[64];
  size_t fill;

  Sha256() { reset(); }

  void reset() {
    static const uint32_t init[8] = {
        0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
        0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    std::memcpy(h, init, sizeof(h));
    bits = 0;
    fill = 0;
  }

  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void block(const uint8_t* p) {
    const uint32_t* k = kSha256K;
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + k[i] + w[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void blocks(const uint8_t* data, size_t n) {
#ifdef FIO_X86
    if (sha_ni_available()) {
      sha256_blocks_shani(h, data, n);
      return;
    }
#endif
    for (; n; --n, data += 64) block(data);
  }

  void update(const uint8_t* data, size_t len) {
    bits += uint64_t(len) * 8;
    if (fill) {
      size_t take = 64 - fill < len ? 64 - fill : len;
      std::memcpy(buf + fill, data, take);
      fill += take;
      data += take;
      len -= take;
      if (fill == 64) {
        blocks(buf, 1);
        fill = 0;
      }
    }
    if (len >= 64) {
      size_t n = len / 64;
      blocks(data, n);
      data += n * 64;
      len -= n * 64;
    }
    if (len) {
      std::memcpy(buf, data, len);
      fill = len;
    }
  }

  void final(uint8_t out[32]) {
    uint8_t pad[72] = {0x80};
    size_t padlen = (fill < 56) ? 56 - fill : 120 - fill;
    uint64_t b = bits;
    uint8_t lenb[8];
    for (int i = 7; i >= 0; --i) {
      lenb[i] = uint8_t(b & 0xff);
      b >>= 8;
    }
    update(pad, padlen);
    update(lenb, 8);
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

// URL-safe base64 without padding (io.rs:248-249): 32 bytes -> 43 chars.
void b64url(const uint8_t digest[32], char out[44]) {
  static const char tab[] =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_";
  int o = 0;
  for (int i = 0; i < 30; i += 3) {
    uint32_t v = (uint32_t(digest[i]) << 16) | (uint32_t(digest[i + 1]) << 8) |
                 uint32_t(digest[i + 2]);
    out[o++] = tab[(v >> 18) & 63];
    out[o++] = tab[(v >> 12) & 63];
    out[o++] = tab[(v >> 6) & 63];
    out[o++] = tab[v & 63];
  }
  uint32_t v = (uint32_t(digest[30]) << 8) | uint32_t(digest[31]);
  out[o++] = tab[(v >> 10) & 63];
  out[o++] = tab[(v >> 4) & 63];
  out[o++] = tab[(v << 2) & 63];
  out[o] = '\0';
}

}  // namespace

extern "C" {

// Hash `len` bytes into a 43-char URL-safe-base64 name (+NUL): out44.
void fio_hash(const uint8_t* data, size_t len, char* out44) {
  Sha256 s;
  s.update(data, len);
  uint8_t digest[32];
  s.final(digest);
  b64url(digest, out44);
}

// Packs a payload for storage: optional deflate (level 6), hash of the
// stored bytes. Returns 0 on success; *out is malloc'd (free via fio_free).
int fio_pack(const uint8_t* data, size_t len, int compress_level,
             uint8_t** out, size_t* out_len, char* hash_out44) {
  uint8_t* stored;
  size_t stored_len;
  if (compress_level > 0) {
    uLongf cap = compressBound(len);
    stored = static_cast<uint8_t*>(std::malloc(cap ? cap : 1));
    if (!stored) return -1;
    if (compress2(stored, &cap, data, len, compress_level) != Z_OK) {
      std::free(stored);
      return -2;
    }
    stored_len = cap;
  } else {
    stored = static_cast<uint8_t*>(std::malloc(len ? len : 1));
    if (!stored) return -1;
    std::memcpy(stored, data, len);
    stored_len = len;
  }
  fio_hash(stored, stored_len, hash_out44);
  *out = stored;
  *out_len = stored_len;
  return 0;
}

// Unpacks stored bytes: hash of the stored bytes (verify-while-read) and
// optional inflate. hash_out44 may be NULL to skip hashing — for artifacts
// whose verification the sync path skips (reference quirk parity), the
// SHA pass is pure waste (~0.65 ms on a 614 KB centroid file).
// Returns 0 on success, -2 on corrupt stream.
int fio_unpack(const uint8_t* data, size_t len, int compressed,
               uint8_t** out, size_t* out_len, char* hash_out44) {
  if (hash_out44) fio_hash(data, len, hash_out44);
  if (!compressed) {
    uint8_t* copy = static_cast<uint8_t*>(std::malloc(len ? len : 1));
    if (!copy) return -1;
    std::memcpy(copy, data, len);
    *out = copy;
    *out_len = len;
    return 0;
  }
  size_t cap = len * 4 + 1024;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(cap));
  if (!buf) return -1;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) {
    std::free(buf);
    return -2;
  }
  zs.next_in = const_cast<uint8_t*>(data);
  zs.avail_in = static_cast<uInt>(len);
  size_t total = 0;
  int rc;
  do {
    if (total == cap) {
      cap *= 2;
      uint8_t* nb = static_cast<uint8_t*>(std::realloc(buf, cap));
      if (!nb) {
        inflateEnd(&zs);
        std::free(buf);
        return -1;
      }
      buf = nb;
    }
    zs.next_out = buf + total;
    zs.avail_out = static_cast<uInt>(cap - total);
    rc = inflate(&zs, Z_NO_FLUSH);
    total = cap - zs.avail_out;
  } while (rc == Z_OK);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) {
    std::free(buf);
    return -2;
  }
  *out = buf;
  *out_len = total;
  return 0;
}

void fio_free(uint8_t* p) { std::free(p); }

// ------------------------------------------------------- host query path --
// The reference serves single stored queries on the host CPU
// (db/stored.rs:549-598: per-partition ADC table walk + n-best). These two
// kernels are the hot inner loops of the Python port of that path; ctypes
// dispatch overhead (~2 us) is far below the numpy fancy-index/argsort
// cost they replace (measured 42 us -> 6 us and 64 us -> 8 us at the
// headline shape L=1000, D=12, C=256).

// out[l] = sum_d table[d*c + codes[l*d + d]]  — ADC distance accumulation
// over a [D, C] lookup table (L1-resident for PQ-sized tables). Two rows
// in flight with split accumulators: the gathers have no useful SIMD form
// without AVX-512, so the win is independent load chains (13.9 -> 7.4 us
// at L=1000, D=12 vs the naive row loop). Accumulation order (even/odd
// split) differs from strict sequential by O(1e-5) absolute — well below
// PQ quantization error.
void fio_adc_sum(const float* table, const uint32_t* codes, size_t rows,
                 size_t d, size_t c, float* out) {
  size_t l = 0;
  for (; l + 2 <= rows; l += 2) {
    const uint32_t* cr0 = codes + l * d;
    const uint32_t* cr1 = cr0 + d;
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    size_t j = 0;
    for (; j + 2 <= d; j += 2) {
      a0 += table[j * c + cr0[j]];
      b0 += table[j * c + cr1[j]];
      a1 += table[(j + 1) * c + cr0[j + 1]];
      b1 += table[(j + 1) * c + cr1[j + 1]];
    }
    for (; j < d; ++j) {
      a0 += table[j * c + cr0[j]];
      b0 += table[j * c + cr1[j]];
    }
    out[l] = a0 + a1;
    out[l + 1] = b0 + b1;
  }
  for (; l < rows; ++l) {
    const uint32_t* cr = codes + l * d;
    float acc = 0.0f;
    for (size_t j = 0; j < d; ++j) acc += table[j * c + cr[j]];
    out[l] = acc;
  }
}

// Decodes a packed repeated-uint32 varint payload (protobuf wire format)
// into out (room for len entries suffices: every varint is >= 1 byte).
// Returns the count decoded, or (size_t)-1 on malformed input (truncated
// varint, varint longer than 10 bytes, or a value above u32 range) — the
// caller falls back to the vectorized numpy decoder for exact error
// reporting. Replaces ~0.8 ms/partition of numpy reduceat work on the
// cold stored query path (a 1000-row partition holds L*D = 12k varints).
size_t fio_varint_u32(const uint8_t* p, size_t len, uint32_t* out) {
  size_t n = 0, i = 0;
  while (i < len) {
    uint64_t v = 0;
    int shift = 0;
    for (;;) {
      if (i >= len || shift > 63) return (size_t)-1;
      uint8_t b = p[i++];
      v |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    if (v > 0xFFFFFFFFull) return (size_t)-1;
    out[n++] = (uint32_t)v;
  }
  return n;
}

// Fused per-partition ADC scan: accumulates each row's table-gather sum
// (same order as fio_adc_sum) plus qnorm, keeping only the k best rows in
// a bounded max-heap keyed lexicographically on (dist, index) — the heap's
// content is exactly the stable-argsort prefix fio_topk_f32 would return,
// without materializing the L-sized distance array or paying a second
// ctypes crossing. Outputs ascending. Returns the count written
// (min(k, rows)). This is the warm-path inner loop of the host stored
// query (db/stored.rs:576-595 walk + nbest.rs bound, fused).
size_t fio_adc_topk(const float* table, const uint32_t* codes, size_t rows,
                    size_t d, size_t c, float qnorm, size_t k,
                    uint32_t* out_idx, float* out_dist) {
  if (k > rows) k = rows;
  if (k == 0) return 0;
  typedef std::pair<float, uint32_t> E;      // (dist, idx): max-heap on <
  std::vector<E> heap;
  heap.reserve(k);
  for (size_t l = 0; l < rows; ++l) {
    const uint32_t* cr = codes + l * d;
    float a0 = 0.f, a1 = 0.f;
    size_t j = 0;
    for (; j + 2 <= d; j += 2) {
      a0 += table[j * c + cr[j]];
      a1 += table[(j + 1) * c + cr[j + 1]];
    }
    if (j < d) a0 += table[j * c + cr[j]];
    E e(a0 + a1 + qnorm, uint32_t(l));
    if (heap.size() < k) {
      heap.push_back(e);
      std::push_heap(heap.begin(), heap.end());
    } else if (e < heap.front()) {
      std::pop_heap(heap.begin(), heap.end());
      heap.back() = e;
      std::push_heap(heap.begin(), heap.end());
    }
  }
  std::sort_heap(heap.begin(), heap.end());
  for (size_t i = 0; i < k; ++i) {
    out_idx[i] = heap[i].second;
    out_dist[i] = heap[i].first;
  }
  return k;
}

// Batched fio_adc_topk: all nprobe partitions of one query in a single
// ctypes crossing. tables is the query's contiguous [n, d*c] table block
// (adc_tables already builds it that way); codes_ptrs[i] points at
// partition i's [rows[i], d] uint32 code matrix. Outputs are [n, k]
// row-major with out_cnt[i] = entries written for partition i
// (min(k, rows[i])). Per-partition semantics identical to fio_adc_topk.
void fio_adc_topk_batch(const float* tables, const float* qnorms,
                        const uint32_t* const* codes_ptrs,
                        const size_t* rows, size_t n, size_t d, size_t c,
                        size_t k, uint32_t* out_idx, float* out_dist,
                        uint32_t* out_cnt) {
  for (size_t i = 0; i < n; ++i) {
    out_cnt[i] = (uint32_t)fio_adc_topk(tables + i * d * c, codes_ptrs[i],
                                        rows[i], d, c, qnorms[i], k,
                                        out_idx + i * k, out_dist + i * k);
  }
}

// Indices of the k smallest dists, ascending, ties broken by lower index
// (exactly numpy's stable argsort prefix — the reference's n-best keeps
// first-encountered minima the same way, nbest.rs). Returns the count
// written (min(k, n)).
size_t fio_topk_f32(const float* dists, size_t n, size_t k, uint32_t* out) {
  if (k > n) k = n;
  if (k == 0) return 0;
  std::vector<std::pair<float, uint32_t>> v;
  v.reserve(n);
  for (size_t i = 0; i < n; ++i) v.emplace_back(dists[i], uint32_t(i));
  std::partial_sort(v.begin(), v.begin() + k, v.end());
  for (size_t i = 0; i < k; ++i) out[i] = v[i].second;
  return k;
}

}  // extern "C"
