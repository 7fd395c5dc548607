// Host kernels of the hashing trick: batch murmur3, the HashingTF
// token -> bucket count fill, and the fused tokenize + hash + count of free
// text.  Strings stay on the host; the dense float32 count blocks they fill
// are what moves to the device.  The port's own copy of
// transmogrifai_tpu/native/fasthost.cpp, bit-exact with it.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o _fasthost.so fasthost.cpp (done at
// first use by native/__init__.py into build/native/, with a pure-Python path
// beside it that gives the same bits).

#include <cstdint>
#include <cstring>

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

// MurmurHash3 x86 32-bit over one UTF-8 string; bit-exact with
// utils/hashing.py::murmur3_32.
static uint32_t murmur3_32(const char* data, int64_t len, uint32_t seed) {
  const uint8_t* d = reinterpret_cast<const uint8_t*>(data);
  const int64_t nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51u;
  const uint32_t c2 = 0x1b873593u;

  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, d + i * 4, 4);  // little-endian load
    k1 *= c1;
    k1 = rotl32(k1, 15);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl32(h1, 13);
    h1 = h1 * 5 + 0xe6546b64u;
  }

  const uint8_t* tail = d + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= static_cast<uint32_t>(tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= static_cast<uint32_t>(tail[1]) << 8; [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = rotl32(k1, 15);
      k1 *= c2;
      h1 ^= k1;
  }

  h1 ^= static_cast<uint32_t>(len);
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  h1 ^= h1 >> 16;
  return h1;
}

extern "C" {

// Hash n packed UTF-8 strings.  offsets has n+1 entries into buf.
void murmur3_batch(const char* buf, const int64_t* offsets, int64_t n,
                   uint32_t seed, uint32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = murmur3_32(buf + offsets[i], offsets[i + 1] - offsets[i], seed);
  }
}

// HashingTF hot loop: bucket-count packed tokens into a dense (n_rows, width)
// float32 block.  row_ids maps each token to its row; binary=1 sets presence
// instead of counts.  out must be zero-initialised by the caller.
void hash_count_block(const char* buf, const int64_t* offsets,
                      const int32_t* row_ids, int64_t n_tokens, int32_t width,
                      uint32_t seed, int32_t binary, float* out) {
  for (int64_t i = 0; i < n_tokens; i++) {
    uint32_t h = murmur3_32(buf + offsets[i], offsets[i + 1] - offsets[i], seed);
    int64_t col = h % static_cast<uint32_t>(width);
    float* cell = out + static_cast<int64_t>(row_ids[i]) * width + col;
    if (binary) {
      *cell = 1.0f;
    } else {
      *cell += 1.0f;
    }
  }
}

// Fused tokenizer + hashing trick: ASCII letter runs / digit runs (the
// [^\W\d_]+|\d+ analyzer on ASCII input), lowercased, hashed with murmur3 into
// `width` buckets — no token strings ever materialize.  Rows containing any
// byte >= 0x80 are SKIPPED and flagged with n_tokens_out[row] = -1 so the
// caller re-runs them through the exact Unicode Python path; pure-ASCII rows
// are bit-identical to tokenize() + hash_count_block().
void tokenize_hash_count(const char* buf, const int64_t* offsets, int64_t n_rows,
                         int32_t width, uint32_t seed, int32_t lowercase,
                         int32_t min_len, int32_t binary, float* out,
                         int64_t* n_tokens_out) {
  char tok[4096];
  for (int64_t r = 0; r < n_rows; r++) {
    const char* p = buf + offsets[r];
    const int64_t len = offsets[r + 1] - offsets[r];
    bool ascii = true;
    for (int64_t i = 0; i < len; i++) {
      if (static_cast<unsigned char>(p[i]) >= 0x80u) { ascii = false; break; }
    }
    if (!ascii) {
      n_tokens_out[r] = -1;
      continue;
    }
    float* row = out + r * static_cast<int64_t>(width);
    int64_t count = 0;
    int64_t i = 0;
    while (i < len) {
      unsigned char c = static_cast<unsigned char>(p[i]);
      const bool alpha = (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z');
      const bool digit = (c >= '0' && c <= '9');
      if (!alpha && !digit) { i++; continue; }
      int64_t t = 0;
      bool overflow = false;
      if (alpha) {
        while (i < len) {
          c = static_cast<unsigned char>(p[i]);
          const bool up = (c >= 'A' && c <= 'Z');
          if (!up && !(c >= 'a' && c <= 'z')) break;
          if (t == static_cast<int64_t>(sizeof(tok))) { overflow = true; break; }
          tok[t++] = (lowercase && up) ? static_cast<char>(c + 32) : static_cast<char>(c);
          i++;
        }
      } else {
        while (i < len) {
          c = static_cast<unsigned char>(p[i]);
          if (!(c >= '0' && c <= '9')) break;
          if (t == static_cast<int64_t>(sizeof(tok))) { overflow = true; break; }
          tok[t++] = static_cast<char>(c);
          i++;
        }
      }
      if (overflow) {  // pathological >4KB token: exact path handles the row
        count = -1;
        break;
      }
      if (t < min_len) continue;
      count++;
      const uint32_t h = murmur3_32(tok, t, seed);
      float* cell = row + (h % static_cast<uint32_t>(width));
      if (binary) {
        *cell = 1.0f;
      } else {
        *cell += 1.0f;
      }
    }
    n_tokens_out[r] = count;  // -1 flags a fallback row
  }
}

}  // extern "C"
