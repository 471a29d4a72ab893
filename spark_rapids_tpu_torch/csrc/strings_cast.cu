// Numbers, booleans and dates to and from the string byte matrix, and the
// row hashes, for sm_90a.
//
// None replaces a Pallas kernel: the JAX package writes each as XLA code
// over the (rows, width) uint8 matrix of a string column, a lax.scan over
// its columns or (rows x width) masks:
//   - str_parse: spark_rapids_tpu/expr/cast_kernels.py:169
//     string_to_long_device, :229 string_to_double_device, :310
//     string_to_bool_device and :336 string_to_date_device (with
//     _trim_bounds :134, _parse_digits_u64 :149, _parse_digits_float :207);
//   - str_format: cast_kernels.py:30 int_to_string_device, :51
//     bool_to_string_device, :87 date_to_string_device and :103
//     decimal_to_string_device;
//   - row_hash: spark_rapids_tpu/expr/hashing.py:176 Murmur3Hash (with
//     _murmur3_fixed :85 and _murmur3_string_device :112) and :255 XxHash64
//     (with _xx_long :235, _xx_int :247 and _xx_bytes_device :313).
// Plain versions and wrappers: expr/cast_kernels.py (str_parse_reference,
// str_format_reference) and expr/hashing.py (row_hash_reference); each
// kernel equals its plain version bit for bit.
//
// One thread a row, in a grid-stride loop. Bound: bytes. A row reads its
// bytes once (at most its length, never the padding past it) and writes its
// value and flag, or its formatted row, once; the work a byte is a few
// integer operations, far below the card's rate.
//
// str_parse trims ASCII whitespace (9-13, 32), then walks the token once,
// keeping what the JAX masks select: the first point (and for a double the
// first 'e'), the digits before and after them, and whether every byte is
// one the grammar allows. A malformed row gets ok = 0 and value 0. Two
// float details follow what XLA:CPU makes of the JAX formulas, so that the
// device matches the JAX package on the CPU bit for bit:
//   - XLA contracts `acc * 10.0 + d` and `mant + frac * 10^-fcnt` into
//     fused multiply-adds: here __fma_rn, one rounding each;
//   - it flushes subnormal results to zero, and its pow(10, k) is a table
//     the wrapper passes (`pow10`, k in [-400, 400]): exact powers of ten,
//     but 0 below 10^-307 and one ulp high at k = 23 and 210.
// str_format writes each row's text left-aligned and zero-padded to the
// output width W (32, 16 or 8 bytes: a multiple of 8, so the row is built
// in registers and stored as 8-byte words).
// row_hash folds k columns' hashes from the seed in column order; a null
// leaves the running hash as it was. Floats hash with -0.0 as 0.0 and every
// NaN as the canonical one. Murmur3 hashes a string's 4-byte blocks (as
// aligned words where the row allows) and then its tail bytes one by one,
// sign-extended, as Spark's hashUnsafeBytes; XxHash64 its 32-byte stripes,
// 8-byte words, a 4-byte word and its tail bytes.
#include <cstdint>
#include <cuda_runtime.h>

// One column of a row hash, as the wrapper describes it (ctypes mirrors
// this layout). Outside the anonymous namespace, as the extern "C" entry
// takes it.
struct SrtHashCol {
  int32_t kind;
  int32_t width;        // a string matrix's width
  int64_t stride;       // bytes from one string row to the next (0: one row
                        // broadcast to every row)
  const void* data;
  const uint8_t* valid;  // null: every row valid
  const int32_t* lengths;
};

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr int kMaxHashCols = 16;
constexpr int kPowLo = -400;
constexpr int kPowHi = 400;

enum ParseKind : int32_t { kParseLong = 0, kParseDouble = 1, kParseBool = 2,
                           kParseDate = 3 };
enum FormatKind : int32_t { kFmtLong = 0, kFmtDate = 1, kFmtDecimal = 2,
                            kFmtBool = 3 };
enum HashKind : int32_t { kHBool = 0, kHInt8 = 1, kHInt16 = 2, kHInt32 = 3,
                          kHInt64 = 4, kHFloat32 = 5, kHFloat64 = 6,
                          kHString = 7 };

struct HashSet {
  SrtHashCol c[kMaxHashCols];
  int32_t n;
};

__device__ __forceinline__ bool is_space(uint8_t c) {
  return c == 32 || (c >= 9 && c <= 13);
}

__device__ __forceinline__ bool is_digit(uint8_t c) {
  return c >= '0' && c <= '9';
}

__device__ __forceinline__ uint8_t lower(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<uint8_t>(c + 32) : c;
}

// Whether row[s, e) is `tok` (lower case) in any case.
__device__ bool token_is(const uint8_t* row, int32_t s, int32_t e,
                         const char* tok, int32_t len) {
  if (e - s != len) return false;
  for (int32_t k = 0; k < len; ++k) {
    if (lower(row[s + k]) != static_cast<uint8_t>(tok[k])) return false;
  }
  return true;
}

__device__ __forceinline__ double pow10_of(const double* pow10, double k) {
  const double c = fmin(fmax(k, static_cast<double>(kPowLo)),
                        static_cast<double>(kPowHi));
  return pow10[static_cast<int>(c) - kPowLo];
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int64_t days_from_civil(int64_t y, int64_t m,
                                                   int64_t d) {
  y -= (m <= 2);
  const int64_t era = floor_div(y, 400);
  const int64_t yoe = y - era * 400;
  const int64_t mp = m > 2 ? m - 3 : m + 9;
  const int64_t doy = floor_div(153 * mp + 2, 5) + d - 1;
  const int64_t doe = yoe * 365 + floor_div(yoe, 4) - floor_div(yoe, 100) +
                      doy;
  return era * 146097 + doe - 719468;
}

__device__ __forceinline__ void civil_from_days(int64_t z, int64_t* y,
                                                int64_t* m, int64_t* d) {
  z += 719468;
  const int64_t era = floor_div(z, 146097);
  const int64_t doe = z - era * 146097;
  const int64_t yoe = floor_div(doe - floor_div(doe, 1460) +
                                    floor_div(doe, 36524) -
                                    floor_div(doe, 146096), 365);
  const int64_t doy = doe - (365 * yoe + floor_div(yoe, 4) -
                             floor_div(yoe, 100));
  const int64_t mp = floor_div(5 * doy + 2, 153);
  *d = doy - floor_div(153 * mp + 2, 5) + 1;
  *m = mp + (mp < 10 ? 3 : -9);
  *y = yoe + era * 400 + (*m <= 2);
}

__device__ __forceinline__ int64_t days_in_month(int64_t y, int64_t m) {
  const bool leap = ((y % 4 == 0) && (y % 100 != 0)) || (y % 400 == 0);
  if (m == 2 && leap) return 29;
  if (m < 1 || m > 12) return 0;
  const int32_t base[12] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
  return base[m - 1];
}

// ---------------------------------------------------------------------------
// str_parse
// ---------------------------------------------------------------------------
__device__ void parse_long(const uint8_t* row, int32_t start, int32_t end,
                           int64_t* val, bool* ok) {
  const uint8_t c0 = row[start];
  const bool neg = c0 == '-';
  const int32_t ds = start + ((neg || c0 == '+') ? 1 : 0);
  int32_t point = end;
  for (int32_t j = ds; j < end; ++j) {
    if (row[j] == '.') { point = j; break; }
  }
  bool valid = true;
  uint64_t acc = 0;
  double facc = 0.0;
  int32_t cnt = 0;
  for (int32_t j = ds; j < end; ++j) {
    const uint8_t c = row[j];
    if (is_digit(c)) {
      if (j < point) {
        const uint32_t d = c - '0';
        acc = acc * 10u + d;
        facc = __fma_rn(facc, 10.0, static_cast<double>(d));
        ++cnt;
      }
    } else if (j != point) {
      valid = false;
    }
  }
  const uint64_t limit = 0x7FFFFFFFFFFFFFFFull + (neg ? 1u : 0u);
  *ok = valid && cnt > 0 && facc <= 9.3e18 && acc <= limit;
  *val = *ok ? static_cast<int64_t>(neg ? 0ull - acc : acc) : 0;
}

__device__ void parse_double(const uint8_t* row, int32_t start, int32_t end,
                             const double* pow10, double* val, bool* ok) {
  const uint8_t c0 = row[start];
  const bool neg = c0 == '-';
  const bool sign = neg || c0 == '+';
  const int32_t ds = start + (sign ? 1 : 0);
  const bool is_inf = token_is(row, ds, end, "infinity", 8) ||
                      token_is(row, ds, end, "inf", 3);
  const bool is_nan = token_is(row, ds, end, "nan", 3) && !sign;
  int32_t e_pos = end;
  for (int32_t j = ds; j < end; ++j) {
    if (lower(row[j]) == 'e') { e_pos = j; break; }
  }
  int32_t point = e_pos;
  for (int32_t j = ds; j < e_pos; ++j) {
    if (row[j] == '.') { point = j; break; }
  }
  const bool has_e = e_pos < end;
  const int32_t es = e_pos + 1;
  const bool e_sign = es < end && (row[es] == '-' || row[es] == '+');
  const bool e_neg = e_sign && row[es] == '-';
  const int32_t e_ds = es + (e_sign ? 1 : 0);
  double mant = 0.0, frac = 0.0, expv = 0.0;
  int32_t icnt = 0, fcnt = 0, ecnt = 0;
  bool classified = true;
  for (int32_t j = ds; j < end; ++j) {
    const uint8_t c = row[j];
    if (is_digit(c)) {
      const double d = static_cast<double>(c - '0');
      if (j < e_pos) {
        if (j < point) {
          mant = __fma_rn(mant, 10.0, d);
          ++icnt;
        } else {
          frac = __fma_rn(frac, 10.0, d);
          ++fcnt;
        }
      } else if (j >= e_ds) {
        expv = __fma_rn(expv, 10.0, d);
        ++ecnt;
      }
    } else if (!((c == '.' && j == point && j < e_pos) ||
                 (lower(c) == 'e' && j == e_pos) ||
                 ((c == '-' || c == '+') && j == es && has_e))) {
      classified = false;
    }
  }
  const bool valid = classified && (icnt + fcnt) > 0 && (!has_e || ecnt > 0);
  const double expo = e_neg ? -expv : expv;
  double v = __dmul_rn(__fma_rn(frac, pow10_of(pow10, -fcnt), mant),
                       pow10_of(pow10, expo));
  if (v != 0.0 && fabs(v) < 2.2250738585072014e-308) v = 0.0;  // flush
  if (neg) v = -v;
  if (is_inf) v = neg ? -__longlong_as_double(0x7FF0000000000000ll)
                      : __longlong_as_double(0x7FF0000000000000ll);
  if (is_nan) v = __longlong_as_double(0x7FF8000000000000ll);
  *ok = valid || is_inf || is_nan;
  *val = *ok ? v : 0.0;
}

__device__ bool parse_bool(const uint8_t* row, int32_t start, int32_t end,
                           bool* ok) {
  const bool t = token_is(row, start, end, "true", 4) ||
                 token_is(row, start, end, "t", 1) ||
                 token_is(row, start, end, "yes", 3) ||
                 token_is(row, start, end, "y", 1) ||
                 token_is(row, start, end, "1", 1);
  const bool f = token_is(row, start, end, "false", 5) ||
                 token_is(row, start, end, "f", 1) ||
                 token_is(row, start, end, "no", 2) ||
                 token_is(row, start, end, "n", 1) ||
                 token_is(row, start, end, "0", 1);
  *ok = t || f;
  return t;
}

__device__ void parse_date(const uint8_t* row, int32_t start, int32_t end,
                           int32_t* val, bool* ok) {
  int32_t d1 = end, d2 = end, ndash = 0;
  for (int32_t j = start; j < end; ++j) {
    if (row[j] == '-') {
      if (ndash == 0) d1 = j;
      else if (ndash == 1) d2 = j;
      ++ndash;
    }
  }
  uint64_t yv = 0, mv = 0, dv = 0;
  int32_t ycnt = 0, mcnt = 0, dcnt = 0;
  bool classified = true;
  for (int32_t j = start; j < end; ++j) {
    const uint8_t c = row[j];
    if (is_digit(c)) {
      const uint32_t d = c - '0';
      if (j < d1) { yv = yv * 10u + d; ++ycnt; }
      else if (j > d1 && j < d2) { mv = mv * 10u + d; ++mcnt; }
      else if (j > d2) { dv = dv * 10u + d; ++dcnt; }
    } else if (!(c == '-' && (j == d1 || j == d2))) {
      classified = false;
    }
  }
  const int64_t y = static_cast<int64_t>(yv);
  const int64_t m = ndash >= 1 ? static_cast<int64_t>(mv) : 1;
  const int64_t d = ndash >= 2 ? static_cast<int64_t>(dv) : 1;
  const bool mcnt_ok = ndash >= 1 ? (mcnt >= 1 && mcnt <= 2) : true;
  const bool dcnt_ok = ndash >= 2 ? (dcnt >= 1 && dcnt <= 2) : true;
  *ok = classified && ndash <= 2 && ycnt == 4 && mcnt_ok && dcnt_ok &&
        y >= 1 && m >= 1 && m <= 12 && d >= 1 && d <= days_in_month(y, m);
  *val = *ok ? static_cast<int32_t>(days_from_civil(y, m, d)) : 0;
}

__global__ void str_parse_kernel(const uint8_t* __restrict__ data,
                                 int64_t stride, int32_t width,
                                 const int32_t* __restrict__ lengths,
                                 int64_t n, int32_t kind,
                                 const double* __restrict__ pow10,
                                 void* __restrict__ out,
                                 uint8_t* __restrict__ ok_out) {
  const int64_t step = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const uint8_t* row = data + i * stride;
    int32_t len = lengths[i];
    len = len < 0 ? 0 : (len > width ? width : len);
    int32_t start = 0;
    while (start < len && is_space(row[start])) ++start;
    int32_t end = len;
    while (end > start && is_space(row[end - 1])) --end;
    bool ok = false;
    if (kind == kParseBool) {
      const bool t = end > start ? parse_bool(row, start, end, &ok) : false;
      static_cast<uint8_t*>(out)[i] = t ? 1 : 0;
    } else if (end == start) {  // nothing but whitespace: null
      if (kind == kParseLong) static_cast<int64_t*>(out)[i] = 0;
      else if (kind == kParseDouble) static_cast<double*>(out)[i] = 0.0;
      else static_cast<int32_t*>(out)[i] = 0;
    } else if (kind == kParseLong) {
      parse_long(row, start, end, static_cast<int64_t*>(out) + i, &ok);
    } else if (kind == kParseDouble) {
      parse_double(row, start, end, pow10, static_cast<double*>(out) + i,
                   &ok);
    } else {
      parse_date(row, start, end, static_cast<int32_t*>(out) + i, &ok);
    }
    ok_out[i] = ok ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// str_format
// ---------------------------------------------------------------------------
constexpr int kMaxWidth = 32;

// Writes the decimal digits of `mag` into buf[pos, pos + ndig) and returns
// ndig (at least `min_digits`, zero-padded on the left).
__device__ int32_t put_digits(uint8_t* buf, int32_t pos, uint64_t mag,
                              int32_t min_digits) {
  uint8_t tmp[20];
  int32_t nd = 0;
  do {
    tmp[nd++] = static_cast<uint8_t>('0' + mag % 10u);
    mag /= 10u;
  } while (mag != 0);
  while (nd < min_digits && nd < 20) tmp[nd++] = '0';
  for (int32_t k = 0; k < nd; ++k) buf[pos + k] = tmp[nd - 1 - k];
  return nd;
}

__global__ void str_format_kernel(const void* __restrict__ vals, int64_t n,
                                  int32_t kind, int32_t scale, int32_t width,
                                  uint8_t* __restrict__ out,
                                  int32_t* __restrict__ lengths) {
  const int64_t step = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    uint8_t buf[kMaxWidth];
#pragma unroll
    for (int k = 0; k < kMaxWidth; ++k) buf[k] = 0;
    int32_t len = 0;
    if (kind == kFmtBool) {
      const bool b = static_cast<const uint8_t*>(vals)[i] != 0;
      const char* s = b ? "true" : "false";
      len = b ? 4 : 5;
      for (int32_t k = 0; k < len; ++k) buf[k] = static_cast<uint8_t>(s[k]);
    } else if (kind == kFmtDate) {
      int64_t y, m, d;
      civil_from_days(static_cast<const int32_t*>(vals)[i], &y, &m, &d);
      y = y < 0 ? 0 : (y > 9999 ? 9999 : y);
      put_digits(buf, 0, static_cast<uint64_t>(y), 4);
      buf[4] = '-';
      put_digits(buf, 5, static_cast<uint64_t>(m), 2);
      buf[7] = '-';
      put_digits(buf, 8, static_cast<uint64_t>(d), 2);
      len = 10;
    } else {
      const int64_t v = static_cast<const int64_t*>(vals)[i];
      const bool neg = v < 0;
      // INT64_MIN-safe magnitude
      const uint64_t mag = neg ? 0ull - static_cast<uint64_t>(v)
                               : static_cast<uint64_t>(v);
      int32_t pos = 0;
      if (neg) buf[pos++] = '-';
      if (kind == kFmtLong || scale <= 0) {
        len = pos + put_digits(buf, pos, mag, 1);
      } else {
        // '[-]int.frac' with at least one digit before the point
        uint8_t digs[20];
        const int32_t nd = put_digits(digs, 0, mag, scale + 1);
        const int32_t int_digits = nd - scale;
        for (int32_t k = 0; k < int_digits; ++k) buf[pos++] = digs[k];
        buf[pos++] = '.';
        for (int32_t k = int_digits; k < nd; ++k) buf[pos++] = digs[k];
        len = pos;
      }
    }
    uint64_t* dst = reinterpret_cast<uint64_t*>(out + i * width);
    for (int32_t w = 0; w < width / 8; ++w) {
      uint64_t word = 0;
#pragma unroll
      for (int b = 7; b >= 0; --b) word = (word << 8) | buf[8 * w + b];
      dst[w] = word;
    }
    lengths[i] = len;
  }
}

// ---------------------------------------------------------------------------
// row_hash
// ---------------------------------------------------------------------------
constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  return rotl32(k1 * kC1, 15) * kC2;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  return rotl32(h1 ^ k1, 13) * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

__device__ __forceinline__ uint32_t mm_int(uint32_t k, uint32_t seed) {
  return fmix32(mix_h1(seed, mix_k1(k)), 4u);
}

__device__ __forceinline__ uint32_t mm_long(uint64_t v, uint32_t seed) {
  uint32_t h1 = mix_h1(seed, mix_k1(static_cast<uint32_t>(v)));
  h1 = mix_h1(h1, mix_k1(static_cast<uint32_t>(v >> 32)));
  return fmix32(h1, 8u);
}

__device__ __forceinline__ uint64_t xx_fmix(uint64_t h) {
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  return h ^ (h >> 32);
}

__device__ __forceinline__ uint64_t xx_int(uint32_t v, uint64_t seed) {
  uint64_t h = seed + kP5 + 4u;
  h ^= static_cast<uint64_t>(v) * kP1;
  h = rotl64(h, 23) * kP2 + kP3;
  return xx_fmix(h);
}

__device__ __forceinline__ uint64_t xx_long(uint64_t v, uint64_t seed) {
  uint64_t h = seed + kP5 + 8u;
  h ^= rotl64(v * kP2, 31) * kP1;
  h = rotl64(h, 27) * kP1 + kP4;
  return xx_fmix(h);
}

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

__device__ __forceinline__ uint64_t load_u64(const uint8_t* p, bool aligned) {
  return static_cast<uint64_t>(load_u32(p, aligned)) |
         (static_cast<uint64_t>(load_u32(p + 4, aligned)) << 32);
}

__device__ uint32_t mm_bytes(const uint8_t* p, int32_t len, bool aligned,
                             uint32_t seed) {
  const int32_t blocks = len - len % 4;
  uint32_t h1 = seed;
  for (int32_t off = 0; off < blocks; off += 4) {
    h1 = mix_h1(h1, mix_k1(load_u32(p + off, aligned)));
  }
  for (int32_t off = blocks; off < len; ++off) {
    // Java's byte is signed: a tail byte sign-extends
    const uint32_t k = static_cast<uint32_t>(
        static_cast<int32_t>(static_cast<int8_t>(p[off])));
    h1 = mix_h1(h1, mix_k1(k));
  }
  return fmix32(h1, static_cast<uint32_t>(len));
}

__device__ uint64_t xx_bytes(const uint8_t* p, int32_t len, bool aligned,
                             uint64_t seed) {
  int32_t off = 0;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed,
             v4 = seed - kP1;
    for (; off + 32 <= len; off += 32) {
      v1 = rotl64(v1 + load_u64(p + off, aligned) * kP2, 31) * kP1;
      v2 = rotl64(v2 + load_u64(p + off + 8, aligned) * kP2, 31) * kP1;
      v3 = rotl64(v3 + load_u64(p + off + 16, aligned) * kP2, 31) * kP1;
      v4 = rotl64(v4 + load_u64(p + off + 24, aligned) * kP2, 31) * kP1;
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    const uint64_t vs[4] = {v1, v2, v3, v4};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h ^= rotl64(vs[k] * kP2, 31) * kP1;
      h = h * kP1 + kP4;
    }
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint64_t>(len);
  for (; off + 8 <= len; off += 8) {
    h ^= rotl64(load_u64(p + off, aligned) * kP2, 31) * kP1;
    h = rotl64(h, 27) * kP1 + kP4;
  }
  if (off + 4 <= len) {
    h ^= static_cast<uint64_t>(load_u32(p + off, aligned)) * kP1;
    h = rotl64(h, 23) * kP2 + kP3;
    off += 4;
  }
  for (; off < len; ++off) {
    h ^= static_cast<uint64_t>(p[off]) * kP5;
    h = rotl64(h, 11) * kP1;
  }
  return xx_fmix(h);
}

// The 32 or 64 bits a fixed-width value hashes as (floats normalised), and
// whether it hashes as a long.
__device__ __forceinline__ uint64_t fixed_bits(const SrtHashCol& c, int64_t i,
                                               bool* wide) {
  *wide = false;
  switch (c.kind) {
    case kHBool:
      return static_cast<const uint8_t*>(c.data)[i] ? 1u : 0u;
    case kHInt8:
      return static_cast<uint32_t>(
          static_cast<int32_t>(static_cast<const int8_t*>(c.data)[i]));
    case kHInt16:
      return static_cast<uint32_t>(
          static_cast<int32_t>(static_cast<const int16_t*>(c.data)[i]));
    case kHInt32:
      return static_cast<uint32_t>(static_cast<const int32_t*>(c.data)[i]);
    case kHFloat32: {
      const float f = static_cast<const float*>(c.data)[i];
      if (f != f) return 0x7FC00000u;
      return f == 0.0f ? 0u : __float_as_uint(f);
    }
    case kHFloat64: {
      *wide = true;
      const double d = static_cast<const double*>(c.data)[i];
      if (d != d) return 0x7FF8000000000000ull;
      return d == 0.0 ? 0ull
                      : static_cast<uint64_t>(__double_as_longlong(d));
    }
    default:  // kHInt64
      *wide = true;
      return static_cast<uint64_t>(static_cast<const int64_t*>(c.data)[i]);
  }
}

__global__ void row_hash_kernel(const HashSet cols, int64_t n, int32_t xx,
                                uint64_t seed, void* __restrict__ out) {
  const int64_t step = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    uint64_t h = xx ? seed : (seed & 0xFFFFFFFFull);
    for (int32_t j = 0; j < cols.n; ++j) {
      const SrtHashCol& c = cols.c[j];
      if (c.valid != nullptr && !c.valid[i]) continue;
      if (c.kind == kHString) {
        const uint8_t* p = static_cast<const uint8_t*>(c.data) + i * c.stride;
        int32_t len = c.lengths[i];
        len = len < 0 ? 0 : (len > c.width ? c.width : len);
        const bool aligned = (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
        h = xx ? xx_bytes(p, len, aligned, h)
               : mm_bytes(p, len, aligned, static_cast<uint32_t>(h));
        continue;
      }
      bool wide;
      const uint64_t b = fixed_bits(c, i, &wide);
      if (xx) {
        h = wide ? xx_long(b, h) : xx_int(static_cast<uint32_t>(b), h);
      } else {
        h = wide ? mm_long(b, static_cast<uint32_t>(h))
                 : mm_int(static_cast<uint32_t>(b), static_cast<uint32_t>(h));
      }
    }
    if (xx) static_cast<uint64_t*>(out)[i] = h;
    else static_cast<uint32_t*>(out)[i] = static_cast<uint32_t>(h);
  }
}

int64_t grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

}  // namespace

// Parses n string rows (`data`: rows `stride` bytes apart, `width` bytes
// each; int32 `lengths`) as kind 0 long, 1 double, 2 boolean, 3 date ->
// values (int64, float64, uint8, int32) and ok (uint8). `pow10`: 801
// float64 values, pow(10, k) for k in [-400, 400].
extern "C" int srt_str_parse(const uint8_t* data, int64_t stride,
                             int32_t width, const int32_t* lengths, int64_t n,
                             int32_t kind, const double* pow10, void* out,
                             uint8_t* ok, void* stream) {
  if (n <= 0 || kind < kParseLong || kind > kParseDate || width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  str_parse_kernel<<<static_cast<unsigned>(grid_for(n)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      data, stride, width, lengths, n, kind, pow10, out, ok);
  return static_cast<int>(cudaGetLastError());
}

// Formats n values of kind 0 long (int64), 1 date (int32 days), 2 decimal
// (int64 unscaled, `scale`), 3 boolean (uint8) into `out` (n rows of
// `width` bytes, a multiple of 8 up to 32, zero past each row's length) and
// int32 `lengths`.
extern "C" int srt_str_format(const void* vals, int64_t n, int32_t kind,
                              int32_t scale, int32_t width, uint8_t* out,
                              int32_t* lengths, void* stream) {
  if (n <= 0 || kind < kFmtLong || kind > kFmtBool || width % 8 != 0 ||
      width < 8 || width > kMaxWidth || scale < 0 || scale > 18) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  str_format_kernel<<<static_cast<unsigned>(grid_for(n)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      vals, n, kind, scale, width, out, lengths);
  return static_cast<int>(cudaGetLastError());
}

// Folds the hashes of `n_cols` columns over n rows from `seed`: xx = 0 gives
// Spark's Murmur3 (uint32 out), 1 its XxHash64 (uint64 out).
extern "C" int srt_row_hash(const SrtHashCol* cols, int32_t n_cols,
                            int64_t n, int32_t xx, uint64_t seed, void* out,
                            void* stream) {
  if (n <= 0 || n_cols < 0 || n_cols > kMaxHashCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HashSet hs;
  hs.n = n_cols;
  for (int32_t j = 0; j < n_cols; ++j) hs.c[j] = cols[j];
  row_hash_kernel<<<static_cast<unsigned>(grid_for(n)), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(hs, n, xx, seed,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int32_t srt_row_hash_max_cols() { return kMaxHashCols; }
