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
// bytes once and writes its value and flag, or its formatted row, once; the
// work a byte is a few integer operations. Byte-sized work is what keeps
// such a kernel from that bound: a row or digit array indexed at run time
// lives in local memory, a one-byte load moves a whole sector, a 64-bit
// division is a long chain of instructions. So str_parse and str_format
// keep a row in registers, as 32-bit words (byte j of the row is byte
// j % 4 of word j / 4), and touch it only at positions known at compile
// time:
//
// str_parse (rows of up to 128 bytes; wider rows keep the byte loop)
// loads a row once, in 16- or 8-byte vectors where the matrix allows
// (bytes one by one into the same registers where it does not: an
// unaligned view), only the vectors that hold bytes within its length.
// A byte class (space, digit, dash) is a bit mask of the row's positions,
// four bytes a step (SWAR). The trims are the first and last bits of the
// non-space mask (skipped when neither end is a space), and a row whose
// start moves is shifted down to byte 0 (funnel shifts and selects). The
// non-digits of a well-formed token are few and in a fixed order (a
// point; a point, an 'e' and its sign; two dashes), so the lowest bits of
// the non-digit mask, and their bytes, decide its shape: it keeps what the
// JAX masks select, the first point (and for a double the first 'e'), the
// digits before and after them. A double with at most one non-digit takes
// its shape from that byte alone, and one without an exponent skips the
// exponent's chain and power (a warp whose rows all do skips that code).
// A token is then runs of digits between known positions, and its digits
// go through serial chains in the order the plain version takes them. A
// malformed row gets ok = 0 and value 0. A measured limit: the double's
// point, a place in its chain known only at run time (a select a byte), and
// its shape cost about as much again as the rest, so it reaches under half
// of its bound where the long reaches past half (PERF.md). Two float
// details follow what XLA:CPU makes of the
// JAX formulas, so that the device matches the JAX package on the CPU bit
// for bit:
//   - XLA contracts `acc * 10.0 + d` and `mant + frac * 10^-fcnt` into
//     fused multiply-adds: here __fma_rn, one rounding each;
//   - it flushes subnormal results to zero, and its pow(10, k) is a table
//     the wrapper passes (`pow10`, k in [-400, 400]): exact powers of ten,
//     but 0 below 10^-307 and one ulp high at k = 23 and 210.
// str_format builds each row's text in eight registers and writes it
// left-aligned and zero-padded to the output width W (32, 16 or 8 bytes) in
// 16-byte stores (8-byte ones where W is not a multiple of 16). A magnitude
// splits as a * 10^16 + b * 10^8 + c (two 64-bit divisions by constants);
// each part becomes 8 ASCII digits by SWAR halving (/ 10^4, / 100, / 10,
// multiplies by reciprocals), so the 24 digits stand right-aligned in
// fixed bytes; a decimal's point goes in by a one-byte shift of the bytes
// before it, and one shift by the count of leading zeros left-aligns the
// text. A date's fields come from 32-bit arithmetic past the one 64-bit
// division by the days of an era.
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
// str_parse keeps rows of up to this many bytes in registers
constexpr int kRegWidth = 128;

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

__device__ __forceinline__ bool is_space(uint32_t c) {
  return c == 32 || (c >= 9 && c <= 13);
}

__device__ __forceinline__ bool is_digit(uint8_t c) {
  return c >= '0' && c <= '9';
}

__device__ __forceinline__ uint8_t lower(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<uint8_t>(c + 32) : c;
}

__device__ __forceinline__ double pow10_of(const double* pow10, double k) {
  const double c = fmin(fmax(k, static_cast<double>(kPowLo)),
                        static_cast<double>(kPowHi));
  return pow10[static_cast<int>(c) - kPowLo];
}

// d (< 2^32) as a double: 2^52 + d has d in its low mantissa bits, and the
// subtraction is exact (one add, where a conversion runs at a quarter of
// its rate)
__device__ __forceinline__ double small_double(uint32_t d) {
  return __hiloint2double(0x43300000, static_cast<int>(d)) -
         4503599627370496.0;
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

// 0 outside 1..12; 31 for the months whose number, folded with its bit 3,
// is odd
__device__ __forceinline__ int64_t days_in_month(int64_t y, int64_t m) {
  const bool leap = ((y % 4 == 0) && (y % 100 != 0)) || (y % 400 == 0);
  if (m < 1 || m > 12) return 0;
  if (m == 2) return leap ? 29 : 28;
  return 30 + ((m ^ (m >> 3)) & 1);
}

// ---------------------------------------------------------------------------
// Rows in registers
// ---------------------------------------------------------------------------

// Moves the N words' bytes k places toward byte 0, zeros coming in at the
// top (k < 4N): whole words by 1, 2, 4, ... (selects), then 0-3 bytes
// (funnel shifts).
template <int N>
__device__ __forceinline__ void shift_down(uint32_t (&w)[N], int k) {
  const int q = k >> 2;
#pragma unroll
  for (int s = 1; s < N; s <<= 1) {
    const bool on = (q & s) != 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      w[i] = on ? (i + s < N ? w[i + s] : 0u) : w[i];
    }
  }
  const int r = 8 * (k & 3);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    w[i] = __funnelshift_r(w[i], i + 1 < N ? w[i + 1] : 0u, r);
  }
}

// Byte j of the row, j known at compile time.
template <int N>
__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[N], int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
}

// Byte j of the row, j known at run time: up to 16 words, the word by a
// tree of selects, one level a bit of its index (a chain of selects is as
// long as the row); past that, a copy of the row shifted down j bytes (a
// tree or a chain of 32 words on one index is compiled as a lookup in
// local memory).
template <int N>
__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[N], int j) {
  if constexpr (N <= 16) {
    uint32_t x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = w[i];
#pragma unroll
    for (int half = N / 2; half >= 1; half /= 2) {
      const bool up = ((j >> 2) & half) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) x[i] = up ? x[i + half] : x[i];
    }
    return (x[0] >> (8 * (j & 3))) & 0xFFu;
  } else {
    uint32_t x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = w[i];
    shift_down(x, j < 4 * N ? j : 0);
    return x[0] & 0xFFu;
  }
}

// Four bytes at a time: the high bit of each byte of the result is set
// where the byte is in the class (exact for every byte value: no carry
// crosses a byte).
__device__ __forceinline__ uint32_t eq_bytes(uint32_t x, uint32_t c) {
  const uint32_t t = x ^ c;
  return ~(((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t) & 0x80808080u;
}

__device__ __forceinline__ uint32_t digit_bytes(uint32_t x) {
  const uint32_t t = x ^ 0x30303030u;
  return ~(((t & 0x7F7F7F7Fu) + 0x76767676u) | t) & 0x80808080u;
}

__device__ __forceinline__ uint32_t space_bytes(uint32_t x) {  // 9-13, 32
  const uint32_t lo = x & 0x7F7F7F7Fu;
  const uint32_t ge9 = (lo + 0x77777777u) | x;
  const uint32_t ge14 = (lo + 0x72727272u) | x;
  return (ge9 & ~ge14 & 0x80808080u) | eq_bytes(x, 0x20202020u);
}

// The four high bits of a class word as bits 0-3, byte 0 first.
__device__ __forceinline__ uint32_t nib(uint32_t hi) {
  return ((hi >> 7) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t low_bits(int k) {  // bits [0, k)
  return k <= 0 ? 0u : (k >= 32 ? ~0u : (1u << k) - 1u);
}

// One bit a byte position of a row of up to 32 * M bytes.
template <int M>
struct Bits {
  uint32_t m[M];

  __device__ __forceinline__ static Bits none() {
    Bits r;
#pragma unroll
    for (int k = 0; k < M; ++k) r.m[k] = 0;
    return r;
  }
  __device__ __forceinline__ static Bits range(int lo, int hi) {  // [lo, hi)
    Bits r;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      r.m[k] = low_bits(hi - 32 * k) & ~low_bits(lo - 32 * k);
    }
    return r;
  }
  __device__ __forceinline__ static Bits one(int j) {  // {j}, j >= 0
    Bits r;
#pragma unroll
    for (int k = 0; k < M; ++k) r.m[k] = (j >> 5) == k ? 1u << (j & 31) : 0u;
    return r;
  }
  // the class bits of word i (bytes 4 i .. 4 i + 3)
  __device__ __forceinline__ void put(int i, uint32_t hi) {
    const uint32_t v = nib(hi) << (4 * (i & 7));
#pragma unroll
    for (int k = 0; k < M; ++k) m[k] |= (i >> 3) == k ? v : 0u;
  }
  __device__ __forceinline__ Bits operator&(const Bits& o) const {
    Bits r;
#pragma unroll
    for (int k = 0; k < M; ++k) r.m[k] = m[k] & o.m[k];
    return r;
  }
  __device__ __forceinline__ Bits operator|(const Bits& o) const {
    Bits r;
#pragma unroll
    for (int k = 0; k < M; ++k) r.m[k] = m[k] | o.m[k];
    return r;
  }
  __device__ __forceinline__ Bits operator~() const {
    Bits r;
#pragma unroll
    for (int k = 0; k < M; ++k) r.m[k] = ~m[k];
    return r;
  }
  __device__ __forceinline__ bool any() const {
    uint32_t a = 0;
#pragma unroll
    for (int k = 0; k < M; ++k) a |= m[k];
    return a != 0;
  }
  __device__ __forceinline__ int count() const {
    int c = 0;
#pragma unroll
    for (int k = 0; k < M; ++k) c += __popc(m[k]);
    return c;
  }
  __device__ __forceinline__ int first(int none) const {  // lowest set bit
    int r = none;
#pragma unroll
    for (int k = M - 1; k >= 0; --k) {
      if (m[k]) r = 32 * k + __ffs(m[k]) - 1;
    }
    return r;
  }
  __device__ __forceinline__ int last() const {  // highest set bit, or -1
    int r = -1;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (m[k]) r = 32 * k + 31 - __clz(m[k]);
    }
    return r;
  }
};

// ---------------------------------------------------------------------------
// str_parse
// ---------------------------------------------------------------------------

// The row's bytes [0, len) into w (len <= the width <= 16 V), zero past the
// vectors that hold them: `grain`-byte vectors (16 or 8: the matrix, its
// stride and its width are multiples of it), else bytes one by one.
template <int V>
__device__ __forceinline__ void load_row(uint32_t (&w)[4 * V],
                                         const uint8_t* __restrict__ row,
                                         int len, int grain) {
#pragma unroll
  for (int i = 0; i < 4 * V; ++i) w[i] = 0;
  if (grain == 16) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (16 * k < len) {
        const uint4 q = *reinterpret_cast<const uint4*>(row + 16 * k);
        w[4 * k] = q.x;
        w[4 * k + 1] = q.y;
        w[4 * k + 2] = q.z;
        w[4 * k + 3] = q.w;
      }
    }
  } else if (grain == 8) {
#pragma unroll
    for (int k = 0; k < 2 * V; ++k) {
      if (8 * k < len) {
        const uint2 q = *reinterpret_cast<const uint2*>(row + 8 * k);
        w[2 * k] = q.x;
        w[2 * k + 1] = q.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16 * V; ++j) {
      if (j < len) {
        w[j >> 2] |= static_cast<uint32_t>(row[j]) << (8 * (j & 3));
      }
    }
  }
}

// The loops over a row run over its 16-byte chunks, unrolled, each chunk
// behind a test (not a break) and its bytes unrolled with a break: every
// index into the row is known at compile time, so the row stays in
// registers at every width (a loop over a 64- or 128-byte row with a
// break is not unrolled, and its runtime index moves the row to local
// memory), and a thread's work still ends with its token.

// The digit class of bytes [0, n), four bytes a step.
template <int N, int M>
__device__ __forceinline__ Bits<M> digits_of(const uint32_t (&w)[N], int n) {
  Bits<M> digit = Bits<M>::none();
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    if (16 * c < n) {
#pragma unroll
      for (int i = 4 * c; i < 4 * c + 4; ++i) {
        if (4 * i >= n) break;
        digit.put(i, digit_bytes(w[i]));
      }
    }
  }
  return digit;
}

// [sign] digits [. digits] (the fraction truncated): the uint64 value and
// its float64 shadow accumulate the digits before the point, left to
// right; a value past the int64 range (the shadow sees past 2^64) is null.
// The token is well formed when its first non-digit past the sign is its
// only one and a point.
template <int N, int M>
__device__ __forceinline__ int64_t parse_long(const uint32_t (&w)[N], int tl,
                                              bool* ok) {
  const uint32_t c0 = w[0] & 0xFFu;
  const bool neg = c0 == '-';
  const int ds = (neg || c0 == '+') ? 1 : 0;
  const Bits<M> other = Bits<M>::range(ds, tl) & ~digits_of<N, M>(w, tl);
  const int p = other.first(tl);
  const bool valid = p == tl || (byte_at(w, p) == '.' &&
                                 !(other & ~Bits<M>::one(p)).any());
  uint64_t acc = 0;
  double facc = 0.0;
  if (valid) {  // [ds, p) are digits
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      if (16 * c < p) {
#pragma unroll
        for (int j = 16 * c; j < 16 * c + 16; ++j) {
          if (j >= p) break;
          if (j >= ds) {
            const uint32_t d = byte_of(w, j) - '0';
            acc = acc * 10u + d;
            facc = __fma_rn(facc, 10.0, small_double(d));
          }
        }
      }
    }
  }
  const uint64_t limit = 0x7FFFFFFFFFFFFFFFull + (neg ? 1u : 0u);
  *ok = valid && p > ds && facc <= 9.3e18 && acc <= limit;
  return *ok ? static_cast<int64_t>(neg ? 0ull - acc : acc) : 0;
}

__device__ __forceinline__ bool is_e(uint32_t c) { return (c | 0x20u) == 'e'; }
__device__ __forceinline__ bool is_sign(uint32_t c) {
  return c == '-' || c == '+';
}

// The digits [lo, hi) left to right into a float64 from 0.0, each step
// one fused multiply-add (empty where hi <= lo).
template <int N>
__device__ __forceinline__ double chain(const uint32_t (&w)[N], int lo,
                                        int hi) {
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    if (16 * c < hi && 16 * c + 16 > lo) {
#pragma unroll
      for (int j = 16 * c; j < 16 * c + 16; ++j) {
        if (j >= hi) break;
        if (j >= lo) {
          acc = __fma_rn(acc, 10.0, small_double(byte_of(w, j) - '0'));
        }
      }
    }
  }
  return acc;
}

// [sign] digits [. digits] [e [sign] digits], or inf, infinity, nan in any
// case (nan unsigned). Past the sign, a well-formed token's non-digits are
// at most a point, an 'e' after it and a sign right after the 'e', so the
// first three non-digits and whether there are more decide its shape.
template <int N, int M>
__device__ __forceinline__ double parse_double(const uint32_t (&w)[N], int tl,
                                               const double* pow10,
                                               bool* ok) {
  const uint32_t c0 = w[0] & 0xFFu;
  const bool neg = c0 == '-';
  const bool sign = neg || c0 == '+';
  const int ds = sign ? 1 : 0;
  // the token past the sign, lowered (every byte compared is a letter, and
  // x | 0x20 is a given lower-case letter only for it and its upper case)
  const uint32_t t0 = __funnelshift_r(w[0], w[1], 8 * ds) | 0x20202020u;
  const uint32_t t1 = __funnelshift_r(w[1], w[2], 8 * ds) | 0x20202020u;
  const int tn = tl - ds;
  const bool is_inf = (tn == 8 && t0 == 0x69666E69u && t1 == 0x7974696Eu) ||
                      (tn == 3 && (t0 & 0xFFFFFFu) == 0x666E69u);
  const bool is_nan = !sign && tn == 3 && (t0 & 0xFFFFFFu) == 0x6E616Eu;
  Bits<M> other = Bits<M>::range(ds, tl) & ~digits_of<N, M>(w, tl);
  int o[3];
  uint32_t b[3] = {0u, 0u, 0u};
  o[0] = other.first(tl);
  b[0] = byte_at(w, o[0]);
  other = other & ~Bits<M>::one(o[0]);
  // the point (else the 'e'), the 'e' (else the end), the exponent's sign
  int p = tl, e_pos = tl;
  bool e_sign = false, e_neg = false, shape = true;
  if (!other.any()) {
    // at most one non-digit (a warp of such rows skips the rest): a point,
    // or an 'e'
    if (o[0] < tl) {
      if (b[0] == '.') p = o[0];
      else e_pos = o[0];
      shape = b[0] == '.' || is_e(b[0]);
    }
  } else {
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      o[k] = other.first(tl);
      b[k] = byte_at(w, o[k]);
      other = other & ~Bits<M>::one(o[k]);
    }
    shape = !other.any();
    int k = 0;
    if (b[0] == '.') {
      p = o[0];
      k = 1;
    }
    if (k == 1 ? (o[1] < tl) : (o[0] < tl)) {
      const int at = k == 1 ? o[1] : o[0];
      const uint32_t c = k == 1 ? b[1] : b[0];
      const int next = k == 1 ? o[2] : o[1];
      const uint32_t cn = k == 1 ? b[2] : b[1];
      const int after = k == 1 ? tl : o[2];
      e_pos = at;
      e_sign = next == at + 1 && next < tl && is_sign(cn);
      e_neg = e_sign && cn == '-';
      shape = shape && is_e(c) && (e_sign ? after == tl : next == tl);
    }
  }
  if (p == tl) p = e_pos;
  const bool has_e = e_pos < tl;
  const int es = e_pos + 1;
  const int e_ds = es + (e_sign ? 1 : 0);
  const int fcnt = p < e_pos ? e_pos - p - 1 : 0;
  // [ds, p), (p, e_pos) and [e_ds, tl) are digits
  const bool valid = shape && (p - ds) + fcnt > 0 && (!has_e || tl > e_ds);
  double v = 0.0;
  if (valid) {
    // the mantissa's and the fraction's digits in one pass: at the point
    // the mantissa takes the chain, which starts again from 0.0 (the same
    // fused multiply-adds in the same order as two chains, and one pass
    // over a warp's rows in place of two)
    double acc = 0.0, mant = 0.0;
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      if (16 * c < e_pos) {
#pragma unroll
        for (int j = 16 * c; j < 16 * c + 16; ++j) {
          if (j >= e_pos) break;
          const double next =
              __fma_rn(acc, 10.0, small_double(byte_of(w, j) - '0'));
          mant = j == p ? acc : mant;
          acc = j == p ? 0.0 : (j >= ds ? next : acc);
        }
      }
    }
    double frac = 0.0;
    if (p < e_pos) frac = acc;
    else mant = acc;
    // without an exponent (a warp of such rows skips its chain) or a
    // fraction the power is 10^0, 1.0 in the table: x * 1.0 is x
    double scale = 1.0;
    if (has_e) {
      const double expv = chain(w, e_ds, tl);
      scale = pow10_of(pow10, e_neg ? -expv : expv);
    }
    v = __dmul_rn(__fma_rn(frac, fcnt > 0 ? pow10_of(pow10, -fcnt) : 1.0,
                           mant), scale);
    if (v != 0.0 && fabs(v) < 2.2250738585072014e-308) v = 0.0;  // flush
    if (neg) v = -v;
  }
  if (is_inf) v = neg ? -__longlong_as_double(0x7FF0000000000000ll)
                      : __longlong_as_double(0x7FF0000000000000ll);
  if (is_nan) v = __longlong_as_double(0x7FF8000000000000ll);
  *ok = valid || is_inf || is_nan;
  return *ok ? v : 0.0;
}

// true, t, yes, y, 1 / false, f, no, n, 0 in any case.
template <int N>
__device__ __forceinline__ bool parse_bool(const uint32_t (&w)[N], int tl,
                                           bool* ok) {
  const uint32_t b0 = w[0] & 0xFFu, l0 = b0 | 0x20u;
  const uint32_t t0 = w[0] | 0x20202020u;
  bool t = false, f = false;
  if (tl == 1) {
    t = b0 == '1' || l0 == 't' || l0 == 'y';
    f = b0 == '0' || l0 == 'f' || l0 == 'n';
  } else if (tl == 2) {
    f = (t0 & 0xFFFFu) == 0x6F6Eu;                  // no
  } else if (tl == 3) {
    t = (t0 & 0xFFFFFFu) == 0x736579u;              // yes
  } else if (tl == 4) {
    t = t0 == 0x65757274u;                          // true
  } else if (tl == 5) {
    f = t0 == 0x736C6166u && ((w[1] | 0x20u) & 0xFFu) == 0x65u;  // false
  }
  *ok = t || f;
  return t;
}

// yyyy[-m[m][-d[d]]], at most 10 bytes.
template <int N, int M>
__device__ __forceinline__ int32_t parse_date(const uint32_t (&w)[N], int tl,
                                              bool* ok) {
  *ok = false;
  if (tl > 10) return 0;
  Bits<M> digit = Bits<M>::none(), dash = Bits<M>::none();
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (4 * i >= tl) break;
    digit.put(i, digit_bytes(w[i]));
    dash.put(i, eq_bytes(w[i], 0x2D2D2D2Du));
  }
  const Bits<M> tok = Bits<M>::range(0, tl);
  dash = dash & tok;
  const int ndash = dash.count();
  const int d1 = dash.first(tl);
  const int d2 = (dash & ~Bits<M>::one(d1)).first(tl);
  const bool classified =
      !(tok & ~(digit | Bits<M>::one(d1) | Bits<M>::one(d2))).any();
  const int mcnt = d2 - d1 - 1, dcnt = tl - d2 - 1;
  // [0, d1), (d1, d2) and (d2, tl) are digits
  if (!classified || ndash > 2 || d1 != 4 ||
      (ndash >= 1 && (mcnt < 1 || mcnt > 2)) ||
      (ndash >= 2 && (dcnt < 1 || dcnt > 2))) {
    return 0;
  }
  const uint32_t h[4] = {w[0], w[1], w[2], 0u};  // bytes 0-9
  const int64_t y = (byte_of(h, 0) - '0') * 1000 + (byte_of(h, 1) - '0') * 100 +
                    (byte_of(h, 2) - '0') * 10 + (byte_of(h, 3) - '0');
  int64_t m = 1, d = 1;
  if (ndash >= 1) {
    m = byte_at(h, d1 + 1) - '0';
    if (mcnt == 2) m = 10 * m + (byte_at(h, d1 + 2) - '0');
  }
  if (ndash >= 2) {
    d = byte_at(h, d2 + 1) - '0';
    if (dcnt == 2) d = 10 * d + (byte_at(h, d2 + 2) - '0');
  }
  *ok = y >= 1 && m >= 1 && m <= 12 && d >= 1 && d <= days_in_month(y, m);
  return *ok ? static_cast<int32_t>(days_from_civil(y, m, d)) : 0;
}

template <class T>
__device__ __forceinline__ void put_value(void* out, int64_t i, T v) {
  static_cast<T*>(out)[i] = v;
}

// Rows of up to 16 V bytes in registers, one thread a row.
template <int V, int KIND>
__global__ void __launch_bounds__(kThreads)
str_parse_kernel(const uint8_t* __restrict__ data, int64_t stride,
                 int32_t width, const int32_t* __restrict__ lengths,
                 int64_t n, int32_t grain, const double* __restrict__ pow10,
                 void* __restrict__ out, uint8_t* __restrict__ ok_out) {
  constexpr int N = 4 * V;
  constexpr int M = (V + 1) / 2;
  const int64_t step = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    int32_t len = lengths[i];
    len = len < 0 ? 0 : (len > width ? width : len);
    uint32_t w[N];
    load_row<V>(w, data + i * stride, len, grain);
    // the trims: only where an end is a space
    int tl = len;
    if (len > 0 && (is_space(w[0] & 0xFFu) || is_space(byte_at(w, len - 1)))) {
      Bits<M> sp = Bits<M>::none();
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (4 * k < len) sp.put(k, space_bytes(w[k]));
      }
      const Bits<M> content = Bits<M>::range(0, len) & ~sp;
      const int start = content.first(0);
      tl = content.last() + 1 - start;
      if (start > 0) shift_down(w, start);
    }
    bool ok = false;
    if constexpr (KIND == kParseLong) {
      put_value<int64_t>(out, i, tl > 0 ? parse_long<N, M>(w, tl, &ok) : 0);
    } else if constexpr (KIND == kParseDouble) {
      put_value<double>(out, i,
                        tl > 0 ? parse_double<N, M>(w, tl, pow10, &ok) : 0.0);
    } else if constexpr (KIND == kParseBool) {
      put_value<uint8_t>(out, i, parse_bool(w, tl, &ok) ? 1 : 0);
    } else {
      put_value<int32_t>(out, i, tl > 0 ? parse_date<N, M>(w, tl, &ok) : 0);
    }
    ok_out[i] = ok ? 1 : 0;
  }
}

// Rows wider than kRegWidth: the byte loop, each byte loaded as it is
// needed (the same grammar; a token there may be longer than any register
// row, leading zeros and all).
__device__ bool token_is(const uint8_t* row, int32_t s, int32_t e,
                         const char* tok, int32_t len) {
  if (e - s != len) return false;
  for (int32_t k = 0; k < len; ++k) {
    if (lower(row[s + k]) != static_cast<uint8_t>(tok[k])) return false;
  }
  return true;
}

__device__ void wide_long(const uint8_t* row, int32_t start, int32_t end,
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

__device__ void wide_double(const uint8_t* row, int32_t start, int32_t end,
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

__device__ bool wide_bool(const uint8_t* row, int32_t start, int32_t end,
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

__device__ void wide_date(const uint8_t* row, int32_t start, int32_t end,
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

__global__ void str_parse_wide_kernel(const uint8_t* __restrict__ data,
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
      const bool t = end > start ? wide_bool(row, start, end, &ok) : false;
      static_cast<uint8_t*>(out)[i] = t ? 1 : 0;
    } else if (end == start) {  // nothing but whitespace: null
      if (kind == kParseLong) static_cast<int64_t*>(out)[i] = 0;
      else if (kind == kParseDouble) static_cast<double*>(out)[i] = 0.0;
      else static_cast<int32_t*>(out)[i] = 0;
    } else if (kind == kParseLong) {
      wide_long(row, start, end, static_cast<int64_t*>(out) + i, &ok);
    } else if (kind == kParseDouble) {
      wide_double(row, start, end, pow10, static_cast<double*>(out) + i,
                  &ok);
    } else {
      wide_date(row, start, end, static_cast<int32_t*>(out) + i, &ok);
    }
    ok_out[i] = ok ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// str_format
// ---------------------------------------------------------------------------
constexpr int kMaxWidth = 32;
constexpr uint64_t kZeros8 = 0x3030303030303030ull;  // "00000000"

// The 8 ASCII digits of x < 10^8, the most significant first in memory
// (the lowest byte): x / 10^4 and its remainder in the two 32-bit lanes,
// each lane / 100 into 16-bit lanes, each of those / 10 into bytes; every
// quotient a multiply by a reciprocal, exact over its lane's range, and no
// carry crosses a lane.
__device__ __forceinline__ uint64_t digits8(uint32_t x) {
  const uint32_t hi = __umulhi(x, 0xD1B71759u) >> 13;  // x / 10^4
  uint64_t v = hi | (static_cast<uint64_t>(x - hi * 10000u) << 32);
  const uint64_t q2 = ((v * 5243u) >> 19) & 0x0000007F0000007Full;
  v = q2 | ((v - q2 * 100u) << 16);
  const uint64_t q1 = ((v * 103u) >> 10) & 0x000F000F000F000Full;
  v = q1 | ((v - q1 * 10u) << 8);
  return v | kZeros8;
}

// A long, or a decimal of `scale` digits after its point ('[-]int.frac',
// at least one digit before the point), into w; -> its length.
__device__ __forceinline__ int32_t format_number(int64_t v, int32_t scale,
                                                 uint32_t (&w)[8]) {
  const bool neg = v < 0;
  // INT64_MIN-safe magnitude, at most 2^63 = a * 10^16 + b * 10^8 + c
  const uint64_t mag = neg ? 0ull - static_cast<uint64_t>(v)
                           : static_cast<uint64_t>(v);
  const uint64_t hi8 = mag / 100000000ull;
  const uint32_t c = static_cast<uint32_t>(mag - hi8 * 100000000ull);
  const uint32_t a = static_cast<uint32_t>(hi8 / 100000000ull);
  const uint32_t b = static_cast<uint32_t>(hi8 - a * 100000000ull);
  // the 24 digits, right-aligned: bytes 0-23
  const uint64_t d0 = digits8(a), d1 = digits8(b), d2 = digits8(c);
  const uint64_t x0 = d0 ^ kZeros8, x1 = d1 ^ kZeros8, x2 = d2 ^ kZeros8;
  const int lead =
      x0 ? (__ffsll(static_cast<long long>(x0)) - 1) >> 3
         : x1 ? 8 + ((__ffsll(static_cast<long long>(x1)) - 1) >> 3)
              : x2 ? 16 + ((__ffsll(static_cast<long long>(x2)) - 1) >> 3)
                   : 24;
  const int nd = max(24 - lead, scale + 1);
  w[0] = static_cast<uint32_t>(d0);
  w[1] = static_cast<uint32_t>(d0 >> 32);
  w[2] = static_cast<uint32_t>(d1);
  w[3] = static_cast<uint32_t>(d1 >> 32);
  w[4] = static_cast<uint32_t>(d2);
  w[5] = static_cast<uint32_t>(d2 >> 32);
  w[6] = w[7] = 0;
  const int point = scale > 0 ? 1 : 0;
  if (point) {
    // bytes [1, 24 - scale) down one place, '.' at 23 - scale (byte 0 is a
    // leading zero: at most 19 digits)
    uint32_t s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = w[i];
    shift_down(s, 1);
    const int at = 23 - scale;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int k = at - 4 * i;  // bytes of word i below the point
      const uint32_t below = k <= 0 ? 0u
                             : (k >= 4 ? ~0u : (1u << (8 * k)) - 1u);
      const uint32_t dot = k >= 0 && k < 4 ? 0xFFu << (8 * k) : 0u;
      w[i] = (s[i] & below) | (dot & 0x2E2E2E2Eu) | (w[i] & ~(below | dot));
    }
  }
  // the text is bytes [24 - nd - point, 24), below it a leading zero for
  // the sign; past byte 23 all bytes are zero
  shift_down(w, 24 - nd - point - (neg ? 1 : 0));
  if (neg) w[0] = (w[0] & ~0xFFu) | '-';
  return nd + point + (neg ? 1 : 0);
}

// 'yyyy-mm-dd' of days since the epoch, the year clipped to 0..9999.
__device__ __forceinline__ void format_date(int32_t days, uint32_t (&w)[8]) {
  // civil_from_days: the era in 64 bits (days + 719468 passes int32), the
  // rest in 32 (doe < 146097, |era| < 2^15)
  constexpr int64_t kEras = 14700;  // days + 719468 + kEras * 146097 >= 0
  const uint64_t u = static_cast<uint64_t>(static_cast<int64_t>(days) +
                                           719468 + kEras * 146097);
  const uint64_t eras = u / 146097u;
  const uint32_t doe = static_cast<uint32_t>(u - eras * 146097u);
  const int32_t era = static_cast<int32_t>(eras) - static_cast<int32_t>(kEras);
  const uint32_t yoe = (doe - doe / 1460u + doe / 36524u - doe / 146096u) /
                       365u;
  const uint32_t doy = doe - (365u * yoe + yoe / 4u - yoe / 100u);
  const uint32_t mp = (5u * doy + 2u) / 153u;
  const uint32_t d = doy - (153u * mp + 2u) / 5u + 1u;
  const uint32_t m = mp < 10u ? mp + 3u : mp - 9u;
  int32_t y = static_cast<int32_t>(yoe) + era * 400 + (m <= 2u ? 1 : 0);
  y = y < 0 ? 0 : (y > 9999 ? 9999 : y);
  const uint32_t yh = static_cast<uint32_t>(y) / 100u;
  uint32_t v = yh | ((static_cast<uint32_t>(y) - yh * 100u) << 16);
  const uint32_t q = ((v * 103u) >> 10) & 0x000F000Fu;
  v = q | ((v - q * 10u) << 8);
  const uint32_t mt = (m * 103u) >> 10, dt = (d * 103u) >> 10;
  w[0] = v | 0x30303030u;
  w[1] = 0x2D00002Du | ((mt + '0') << 8) | ((m - 10u * mt + '0') << 16);
  w[2] = (dt + '0') | ((d - 10u * dt + '0') << 8);
  w[3] = w[4] = w[5] = w[6] = w[7] = 0;
}

// The first `width` bytes of w as the row at dst: 16-byte stores where
// width is a multiple of 16, else 8-byte ones.
__device__ __forceinline__ void store_row(uint8_t* dst, int32_t width,
                                          const uint32_t (&w)[8]) {
  if ((width & 15) == 0) {
#pragma unroll
    for (int k = 0; k < kMaxWidth / 16; ++k) {
      if (16 * k < width) {
        *reinterpret_cast<uint4*>(dst + 16 * k) =
            make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxWidth / 8; ++k) {
      if (8 * k < width) {
        *reinterpret_cast<uint2*>(dst + 8 * k) =
            make_uint2(w[2 * k], w[2 * k + 1]);
      }
    }
  }
}

// The text of value i in w, zero past it; -> its length.
__device__ __forceinline__ int32_t format_row(const void* vals, int64_t i,
                                              int32_t kind, int32_t scale,
                                              uint32_t (&w)[8]) {
  if (kind == kFmtBool) {
    const bool b = static_cast<const uint8_t*>(vals)[i] != 0;
    w[0] = b ? 0x65757274u : 0x736C6166u;  // "true", "fals"
    w[1] = b ? 0u : 0x65u;                   // "e"
    w[2] = w[3] = w[4] = w[5] = w[6] = w[7] = 0;
    return b ? 4 : 5;
  }
  if (kind == kFmtDate) {
    format_date(static_cast<const int32_t*>(vals)[i], w);
    return 10;
  }
  return format_number(static_cast<const int64_t*>(vals)[i],
                       kind == kFmtDecimal ? scale : 0, w);
}

__global__ void __launch_bounds__(kThreads)
str_format_kernel(const void* __restrict__ vals, int64_t n, int32_t kind,
                  int32_t scale, int32_t width, uint8_t* __restrict__ out,
                  int32_t* __restrict__ lengths) {
  const int64_t step = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    uint32_t w[8];
    lengths[i] = format_row(vals, i, kind, scale, w);
    store_row(out + i * width, width, w);
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

template <int V>
void launch_parse(int32_t kind, unsigned grid, cudaStream_t stream,
                  const uint8_t* data, int64_t stride, int32_t width,
                  const int32_t* lengths, int64_t n, int32_t grain,
                  const double* pow10, void* out, uint8_t* ok) {
  switch (kind) {
    case kParseLong:
      str_parse_kernel<V, kParseLong><<<grid, kThreads, 0, stream>>>(
          data, stride, width, lengths, n, grain, pow10, out, ok);
      break;
    case kParseDouble:
      str_parse_kernel<V, kParseDouble><<<grid, kThreads, 0, stream>>>(
          data, stride, width, lengths, n, grain, pow10, out, ok);
      break;
    case kParseBool:
      str_parse_kernel<V, kParseBool><<<grid, kThreads, 0, stream>>>(
          data, stride, width, lengths, n, grain, pow10, out, ok);
      break;
    default:
      str_parse_kernel<V, kParseDate><<<grid, kThreads, 0, stream>>>(
          data, stride, width, lengths, n, grain, pow10, out, ok);
      break;
  }
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
  if (n <= 0 || kind < kParseLong || kind > kParseDate || width < 1 ||
      stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(grid_for(n));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the vector a row loads in: the matrix, its rows and its width all
  // multiples of it
  const uint64_t where = reinterpret_cast<uintptr_t>(data) |
                         static_cast<uint64_t>(stride) |
                         static_cast<uint64_t>(width);
  const int32_t grain = where % 16 == 0 ? 16 : where % 8 == 0 ? 8 : 1;
  if (width <= 16) {
    launch_parse<1>(kind, grid, st, data, stride, width, lengths, n, grain,
                    pow10, out, ok);
  } else if (width <= 32) {
    launch_parse<2>(kind, grid, st, data, stride, width, lengths, n, grain,
                    pow10, out, ok);
  } else if (width <= 64) {
    launch_parse<4>(kind, grid, st, data, stride, width, lengths, n, grain,
                    pow10, out, ok);
  } else if (width <= kRegWidth) {
    launch_parse<8>(kind, grid, st, data, stride, width, lengths, n, grain,
                    pow10, out, ok);
  } else {
    str_parse_wide_kernel<<<grid, kThreads, 0, st>>>(
        data, stride, width, lengths, n, kind, pow10, out, ok);
  }
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
