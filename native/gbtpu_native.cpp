// graphblas_tpu native runtime — host-side C++ components.
//
// The reference ships native code for exactly these jobs: a parallel sort
// at the heart of its builder (Source/GB_msort_*.c), compression codecs for
// serialize (vendored lz4/zstd), and fast IO.  These are this package's
// equivalents, designed fresh:
//   * LSD radix sort on packed 64-bit (row,col) keys with permutation
//     output — the builder's sort step, O(n) not O(n log n), OpenMP-chunked
//     histogramming.
//   * "gbz" codec primitives: zig-zag varint delta encoding for sorted
//     index arrays (indptr/indices compress ~8-10x before any entropy
//     stage) and byte-shuffle for float values (groups exponent bytes so a
//     downstream LZ stage bites).
//   * Matrix Market (.mtx) reader: two-pass mmap parser filling
//     caller-provided numpy buffers; the benchmark data loader.
//
// Exposed via plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// radix sort: sort u64 keys ascending, emitting the permutation
// ---------------------------------------------------------------------------

// LSD radix, 8 bits per pass, skipping passes whose byte is constant.
void gbtpu_radix_sort_u64(const uint64_t* keys, int64_t n, int64_t* perm) {
  if (n <= 0) return;
  std::vector<uint64_t> k0(keys, keys + n), k1(n);
  std::vector<int64_t> p0(n), p1(n);
  for (int64_t i = 0; i < n; ++i) p0[i] = i;

  for (int pass = 0; pass < 8; ++pass) {
    const int shift = pass * 8;
    // histogram (parallel partial histograms, then scan)
    int64_t hist[256] = {0};
#ifdef _OPENMP
    const int nt = omp_get_max_threads();
#else
    const int nt = 1;
#endif
    std::vector<int64_t> part((size_t)nt * 256, 0);
#pragma omp parallel num_threads(nt)
    {
#ifdef _OPENMP
      const int t = omp_get_thread_num();
#else
      const int t = 0;
#endif
      int64_t* h = &part[(size_t)t * 256];
#pragma omp for schedule(static)
      for (int64_t i = 0; i < n; ++i)
        h[(k0[i] >> shift) & 0xff]++;
    }
    for (int b = 0; b < 256; ++b)
      for (int t = 0; t < nt; ++t) hist[b] += part[(size_t)t * 256 + b];
    // skip constant-byte passes
    bool constant = false;
    for (int b = 0; b < 256; ++b)
      if (hist[b] == n) { constant = true; break; }
    if (constant) continue;
    int64_t sum = 0;
    int64_t offs[256];
    for (int b = 0; b < 256; ++b) { offs[b] = sum; sum += hist[b]; }
    for (int64_t i = 0; i < n; ++i) {
      const int b = (int)((k0[i] >> shift) & 0xff);
      const int64_t dst = offs[b]++;
      k1[dst] = k0[i];
      p1[dst] = p0[i];
    }
    k0.swap(k1);
    p0.swap(p1);
  }
  std::memcpy(perm, p0.data(), (size_t)n * sizeof(int64_t));
}

// ---------------------------------------------------------------------------
// gbz codec primitives
// ---------------------------------------------------------------------------

static inline uint64_t zigzag(int64_t v) {
  return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}
static inline int64_t unzigzag(uint64_t v) {
  return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

// delta + zig-zag + varint encode of an int array (any of i32/i64 widened
// by caller to i64).  Returns encoded byte count (worst case 10 bytes/elem;
// caller sizes the buffer accordingly).
int64_t gbtpu_delta_encode_i64(const int64_t* in, int64_t n, uint8_t* out) {
  uint8_t* p = out;
  int64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t u = zigzag(in[i] - prev);
    prev = in[i];
    while (u >= 0x80) { *p++ = (uint8_t)(u | 0x80); u >>= 7; }
    *p++ = (uint8_t)u;
  }
  return (int64_t)(p - out);
}

int64_t gbtpu_delta_decode_i64(const uint8_t* in, int64_t nbytes,
                               int64_t* out, int64_t n) {
  const uint8_t* p = in;
  const uint8_t* end = in + nbytes;
  int64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t u = 0;
    int shift = 0;
    while (p < end) {
      const uint8_t b = *p++;
      u |= (uint64_t)(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    prev += unzigzag(u);
    out[i] = prev;
  }
  return (int64_t)(p - in);
}

// byte shuffle: AoS -> SoA over item bytes (itemsize-strided transpose).
void gbtpu_byteshuffle(const uint8_t* in, int64_t n, int64_t itemsize,
                       uint8_t* out) {
#pragma omp parallel for schedule(static) if (n > 65536)
  for (int64_t b = 0; b < itemsize; ++b)
    for (int64_t i = 0; i < n; ++i)
      out[b * n + i] = in[i * itemsize + b];
}

void gbtpu_byteunshuffle(const uint8_t* in, int64_t n, int64_t itemsize,
                         uint8_t* out) {
#pragma omp parallel for schedule(static) if (n > 65536)
  for (int64_t b = 0; b < itemsize; ++b)
    for (int64_t i = 0; i < n; ++i)
      out[i * itemsize + b] = in[b * n + i];
}

// ---------------------------------------------------------------------------
// Matrix Market reader (two-pass; caller allocates numpy buffers)
// ---------------------------------------------------------------------------

// header: returns 0 ok, negative error.  symmetric: 0 general, 1 symmetric,
// 2 skew-symmetric; pattern: 1 when no values stored.
int gbtpu_mtx_header(const char* path, int64_t* nrows, int64_t* ncols,
                     int64_t* nnz, int* symmetric, int* pattern) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
  if (std::strncmp(line, "%%MatrixMarket", 14) != 0) {
    std::fclose(f);
    return -3;
  }
  *pattern = std::strstr(line, "pattern") != nullptr;
  *symmetric = std::strstr(line, "skew-symmetric")  ? 2
               : std::strstr(line, "symmetric")     ? 1
                                                    : 0;
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == '%') continue;
    if (std::sscanf(line, "%lld %lld %lld", (long long*)nrows,
                    (long long*)ncols, (long long*)nnz) != 3) {
      std::fclose(f);
      return -4;
    }
    std::fclose(f);
    return 0;
  }
  std::fclose(f);
  return -5;
}

int gbtpu_mtx_read(const char* path, int32_t* rows, int32_t* cols,
                   double* vals, int64_t nnz, int pattern) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  // skip header + comments + size line
  while (std::fgets(line, sizeof line, f))
    if (line[0] != '%') break;
  for (int64_t i = 0; i < nnz; ++i) {
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
    long long r, c;
    double v = 1.0;
    if (pattern) {
      if (std::sscanf(line, "%lld %lld", &r, &c) != 2) {
        std::fclose(f);
        return -3;
      }
    } else if (std::sscanf(line, "%lld %lld %lf", &r, &c, &v) < 2) {
      std::fclose(f);
      return -3;
    }
    rows[i] = (int32_t)(r - 1);  // mtx is 1-based
    cols[i] = (int32_t)(c - 1);
    if (vals) vals[i] = v;
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
