// Native Criteo TSV parser + hasher (frozen data spec v1).
//
// Parses raw Criteo TSV bytes into (labels, dense, ids) batches with the
// same hashing spec as recmodels_tpu_torch/data/hashing.py (splitmix64 over
// slot-salted fingerprints; hex fast path; FNV-1a 64 fallback; missing ->
// bucket 0) and the same dense transform (log1p(max(x, 0)), missing -> 0),
// the latter taken in double and rounded to f32 (the Python parser takes it
// in f32, so dense values may differ by an ulp; labels and ids are equal).
// The same source as the JAX package's native parser, so the two packages'
// native parsers give the same bits (tests/test_torch_data.py).
//
// Built as a plain shared object with g++ at first use and loaded with
// ctypes (recmodels_tpu_torch/data/fastparse.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>

namespace {

constexpr uint64_t SM64_GAMMA = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t SM64_M1 = 0xBF58476D1CE4E5B9ULL;
constexpr uint64_t SM64_M2 = 0x94D049BB133111EBULL;
constexpr uint64_t FNV_OFFSET = 0xCBF29CE484222325ULL;
constexpr uint64_t FNV_PRIME = 0x100000001B3ULL;

inline uint64_t splitmix64(uint64_t x) {
  uint64_t z = x + SM64_GAMMA;
  z = (z ^ (z >> 30)) * SM64_M1;
  z = (z ^ (z >> 27)) * SM64_M2;
  return z ^ (z >> 31);
}

inline uint64_t fnv1a64(const char* s, long n) {
  uint64_t h = FNV_OFFSET;
  for (long i = 0; i < n; ++i) {
    h ^= (uint8_t)s[i];
    h *= FNV_PRIME;
  }
  return h;
}

// parse hex token; returns false if any non-hex char
inline bool parse_hex(const char* s, long n, uint64_t* out) {
  if (n == 0 || n > 16) return false;
  uint64_t v = 0;
  for (long i = 0; i < n; ++i) {
    char c = s[i];
    uint64_t d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = 10 + c - 'a';
    else if (c >= 'A' && c <= 'F') d = 10 + c - 'A';
    else return false;
    v = (v << 4) | d;
  }
  *out = v;
  return true;
}

constexpr int N_DENSE = 13;
constexpr int N_CAT = 26;

}  // namespace

extern "C" {

// Parse up to max_rows lines from buf[0..len).
// Outputs: labels [max_rows], dense [max_rows*13] (transformed),
// ids [max_rows*26] (hashed), vocab [26].
// Returns number of rows parsed; *consumed set to bytes consumed
// (complete lines only).
long rm_parse_criteo(const char* buf, long len, long max_rows,
                     const int64_t* vocab, float* labels, float* dense,
                     int32_t* ids, long* consumed) {
  long row = 0;
  long pos = 0;
  while (row < max_rows) {
    // find end of line
    const char* nl = (const char*)memchr(buf + pos, '\n', len - pos);
    if (nl == nullptr) break;  // incomplete line: stop
    long line_end = nl - buf;
    long p = pos;
    // field 0: label
    {
      long q = p;
      while (q < line_end && buf[q] != '\t') ++q;
      labels[row] = (float)strtod(buf + p, nullptr);
      p = (q < line_end) ? q + 1 : line_end;
    }
    // dense fields
    for (int j = 0; j < N_DENSE; ++j) {
      long q = p;
      while (q < line_end && buf[q] != '\t') ++q;
      float v = 0.0f;
      if (q > p) {
        double x = strtod(buf + p, nullptr);
        if (x > 0.0) v = (float)log1p(x);
      }
      dense[row * N_DENSE + j] = v;
      p = (q < line_end) ? q + 1 : line_end;
    }
    // categorical fields
    for (int j = 0; j < N_CAT; ++j) {
      long q = p;
      while (q < line_end && buf[q] != '\t') ++q;
      long n = q - p;
      int32_t id = 0;
      if (n > 0) {
        uint64_t fp;
        if (!parse_hex(buf + p, n, &fp)) fp = fnv1a64(buf + p, n);
        uint64_t salt = splitmix64((uint64_t)(j + 1));
        uint64_t h = splitmix64(fp ^ salt);
        uint64_t v = (uint64_t)vocab[j];
        id = (int32_t)(1ULL + h % (v - 1ULL));
      }
      ids[row * N_CAT + j] = id;
      p = (q < line_end) ? q + 1 : line_end;
    }
    pos = line_end + 1;
    ++row;
  }
  *consumed = pos;
  return row;
}

}  // extern "C"
