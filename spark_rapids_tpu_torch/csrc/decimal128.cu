// Exact 128-bit decimal arithmetic, one thread a row, for sm_90a.
//
// Replaces the XLA digit-plane code of spark_rapids_tpu/expr/decimal128.py
// (the JAX package computes these as 32-bit digits in int64 lanes):
//   - d128_mul_rescaled: d128_mul :189, _div_pow10_round_half_up :239 and
//     _digits_to_limbs_checked :293, wrapped by d128_mul_rescaled :327;
//   - d128_rescale :310;
//   - d128_segment_sum :395.
// Plain versions and wrappers: expr/decimal128.py.
//
// A value is two int64 limbs [hi, lo] (row-major (n, 2)), or one scaled
// int64 (the decimal64 tier), read and sign-extended here so the caller
// never widens it. Arithmetic is on magnitudes in 64-bit limbs:
//   - a product of two magnitudes below 2^128 is exact in 256 bits
//     (__umul64hi gives each partial product's high half);
//   - division by 10^k with HALF_UP rounding is floor((x + 10^k / 2) / 10^k)
//     (10^k is even), in a chain of divisions by at most 10^9 over 32-bit
//     halves: floor(floor(x / a) / b) = floor(x / (a b));
//   - the overflow flag is |result| >= 10^p (p <= 38, so 10^p < 2^127 and a
//     magnitude past 127 bits is over too); the limbs are the signed result
//     modulo 2^128, as the JAX functions leave them.
//
// d128_segment_sum keeps a 192-bit signed accumulator a group: a batch of
// up to 2^31 rows below 2^127 each sums to under 2^158, which 128 bits
// would wrap. Integer addition modulo 2^192 is exact and commutative, so
// the total is the same in every run whatever the order. Two paths:
//   - cap <= kSmallCap (Q6's grand total, up to 16 groups): each thread
//     keeps the groups' sums in registers as four 64-bit sums of the rows'
//     32-bit digits (the top digit signed), so a row costs four adds and no
//     carries; it adds each of its rows into its group's by an unrolled,
//     predicated compare against every group (no register array indexed at
//     run time, so nothing spills), instantiated at the least of 1, 2, 4,
//     6, 8, 12 and 16 that holds cap. No atomics or warp collectives in the
//     row loop, whose loads are 16-byte words over kRows consecutive rows a
//     thread (limbs, gid and contrib alike). A grid of as many blocks as
//     fit on the card at once walks the rows; at its end each block adds
//     every group's digit sums across its warps (shuffles, then shared
//     memory) and stores them with plain stores into the caller's scratch,
//     so nothing is zeroed first. A second kernel, a block a group, adds the
//     blocks' digit sums, forms the 192-bit total and writes the limbs and
//     the flag: two launches a call. A batch holds fewer than 2^31 rows, so
//     no digit sum wraps on the way.
//   - cap > kSmallCap: the scratch holds (cap, 3) words in global memory,
//     zeroed first (cudaMemsetAsync). The lanes of a warp that share a
//     group add their rows (every group of the warp at once, in twelve
//     16-bit warp reductions, __reduce_add_sync), the group's first lane
//     adds the sum into a shared-memory slot of the block (or, where the
//     slot holds another group, into global memory) with 64-bit atomics,
//     each word's carry read from its atomic's old value, and the block
//     adds its slots into global memory at its end. A second kernel reads
//     each group's total and writes its limbs and flag.
//
// Bound: memory. Each kernel reads its rows once and writes its outputs
// once; the arithmetic is a few dozen integer operations a row (the 64-bit
// divisions of a scale drop more, the small-cap sum's compare against
// every group about a dozen a group).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
// shared-memory accumulator slots of a large-cap segment-sum block
constexpr int kSlots = 256;
// the small-cap segment sum: the most groups a thread keeps in registers,
// and the consecutive rows a thread reads a step (a multiple of 4: contrib
// as 32-bit words, an int32 gid as 16-byte words)
constexpr int kSmallCap = 16;
constexpr int kRows = 4;
static_assert(kSmallCap <= 16, "the caps small_sum_any instantiates");
static_assert(kRows % 4 == 0, "whole words of contrib and gid");
constexpr unsigned kFull = 0xFFFFFFFFu;

struct U256 {
  u64 w[4];  // little-endian words
};

__host__ __device__ __forceinline__ u64 add_carry(u64& acc, u64 v) {
  acc += v;
  return acc < v ? 1ull : 0ull;
}

// x += c (mod 2^256)
__host__ __device__ __forceinline__ void add256(U256& x, const U256& c) {
  u64 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u64 t = x.w[i] + carry;
    u64 c1 = t < carry ? 1ull : 0ull;
    c1 += add_carry(t, c.w[i]);
    x.w[i] = t;
    carry = c1;
  }
}

__device__ __forceinline__ U256 mul128(u64 a0, u64 a1, u64 b0, u64 b1) {
  U256 r;
  const u64 p00l = a0 * b0, p00h = __umul64hi(a0, b0);
  const u64 p01l = a0 * b1, p01h = __umul64hi(a0, b1);
  const u64 p10l = a1 * b0, p10h = __umul64hi(a1, b0);
  const u64 p11l = a1 * b1, p11h = __umul64hi(a1, b1);
  r.w[0] = p00l;
  u64 w1 = p00h;
  u64 c2 = add_carry(w1, p01l);
  c2 += add_carry(w1, p10l);
  u64 w2 = p01h;
  u64 c3 = add_carry(w2, p10h);
  c3 += add_carry(w2, p11l);
  c3 += add_carry(w2, c2);
  r.w[1] = w1;
  r.w[2] = w2;
  r.w[3] = p11h + c3;
  return r;
}

// x = floor(x / d) for 0 < d < 2^32, over the eight 32-bit halves
__device__ __forceinline__ void div256_small(U256& x, uint32_t d) {
  u64 r = 0;
  for (int i = 7; i >= 0; --i) {
    const int word = i >> 1, shift = (i & 1) * 32;
    const u64 cur = (r << 32) | ((x.w[word] >> shift) & 0xFFFFFFFFull);
    const u64 q = cur / d;
    r = cur - q * d;
    x.w[word] = (x.w[word] & ~(0xFFFFFFFFull << shift)) | (q << shift);
  }
}

__device__ __forceinline__ uint32_t pow10_u32(int k) {
  uint32_t v = 1;
  for (int i = 0; i < k; ++i) v *= 10u;
  return v;
}

// x = floor((x + half) / 10^k), half = 10^k / 2 (k >= 1)
__device__ __forceinline__ void div_pow10_half_up(U256& x, int k,
                                                  const U256& half) {
  add256(x, half);
  for (int left = k; left > 0; left -= 9) {
    div256_small(x, pow10_u32(left < 9 ? left : 9));
  }
}

// value of row i: limbs (wide) or a scaled int64, as (lo, hi)
__device__ __forceinline__ void load_value(const int64_t* p, int wide,
                                           int64_t i, u64& lo, u64& hi) {
  if (wide) {
    hi = static_cast<u64>(p[2 * i]);
    lo = static_cast<u64>(p[2 * i + 1]);
  } else {
    const int64_t v = p[i];
    lo = static_cast<u64>(v);
    hi = v < 0 ? ~0ull : 0ull;
  }
}

// (lo, hi) -> its magnitude in place; returns whether it was negative
__host__ __device__ __forceinline__ bool magnitude128(u64& lo, u64& hi) {
  const bool neg = static_cast<int64_t>(hi) < 0;
  if (neg) {
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0 ? 1ull : 0ull);
  }
  return neg;
}

// the checked result: flag |x| >= bound (x a magnitude), then write the
// low 128 bits, negated when the result is negative
__device__ __forceinline__ void store_checked(const U256& x, bool neg,
                                              u64 bound_lo, u64 bound_hi,
                                              int64_t i, int64_t* out,
                                              bool* over) {
  const bool ov = (x.w[3] | x.w[2]) != 0 || x.w[1] > bound_hi ||
                  (x.w[1] == bound_hi && x.w[0] >= bound_lo);
  u64 lo = x.w[0], hi = x.w[1];
  if (neg) {
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0 ? 1ull : 0ull);
  }
  out[2 * i] = static_cast<int64_t>(hi);
  out[2 * i + 1] = static_cast<int64_t>(lo);
  over[i] = ov;
}

__global__ void d128_mul_rescaled_kernel(const int64_t* __restrict__ a,
                                         int a_wide,
                                         const int64_t* __restrict__ b,
                                         int b_wide, int64_t n, int k,
                                         U256 half, u64 bound_lo,
                                         u64 bound_hi,
                                         int64_t* __restrict__ out,
                                         bool* __restrict__ over) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    u64 a0, a1, b0, b1;
    load_value(a, a_wide, i, a0, a1);
    load_value(b, b_wide, i, b0, b1);
    const bool neg = magnitude128(a0, a1) != magnitude128(b0, b1);
    U256 x = mul128(a0, a1, b0, b1);
    if (k > 0) div_pow10_half_up(x, k, half);
    store_checked(x, neg, bound_lo, bound_hi, i, out, over);
  }
}

// shift > 0: times 10^shift (pow10 holds it); shift < 0: over 10^-shift,
// HALF_UP (half holds 10^-shift / 2)
__global__ void d128_rescale_kernel(const int64_t* __restrict__ a, int wide,
                                    int64_t n, int shift, u64 pow10_lo,
                                    u64 pow10_hi, U256 half, u64 bound_lo,
                                    u64 bound_hi, int64_t* __restrict__ out,
                                    bool* __restrict__ over) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    u64 lo, hi;
    load_value(a, wide, i, lo, hi);
    const bool neg = magnitude128(lo, hi);
    U256 x;
    if (shift > 0) {
      x = mul128(lo, hi, pow10_lo, pow10_hi);
    } else {
      x.w[0] = lo;
      x.w[1] = hi;
      x.w[2] = x.w[3] = 0;
      if (shift < 0) div_pow10_half_up(x, -shift, half);
    }
    store_checked(x, neg, bound_lo, bound_hi, i, out, over);
  }
}

// acc (three words, little-endian) += (v0, v1, v2) modulo 2^192, with
// 64-bit atomics: each word's carry out comes from its atomic's old value
__device__ __forceinline__ void atomic_add192(u64* acc, u64 v0, u64 v1,
                                              u64 v2) {
  u64 carry = 0;
  if (v0) {
    const u64 old = atomicAdd(acc, v0);
    carry = old + v0 < old ? 1ull : 0ull;
  }
  const u64 s1 = v1 + carry;
  u64 carry2 = s1 < v1 ? 1ull : 0ull;  // v1 = 2^64 - 1 and a carry in
  if (s1) {
    const u64 old = atomicAdd(acc + 1, s1);
    carry2 += old + s1 < old ? 1ull : 0ull;
  }
  const u64 s2 = v2 + carry2;
  if (s2) atomicAdd(acc + 2, s2);
}

// each lane's 192-bit value -> the sum over the lanes of its ``peers``
// (every lane of the warp calls this with its own group's mask, so all the
// warp's groups reduce at once): twelve 16-bit pieces, each summed by one
// warp reduction (32 pieces below 2^16 sum below 2^21), then put back
// together with carries modulo 2^192
__device__ __forceinline__ void group_sum192(unsigned peers, u64& x0,
                                             u64& x1, u64& x2) {
  const u64 in[3] = {x0, x1, x2};
  u64 w[3] = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int word = j >> 2, shift = (j & 3) * 16;
    const u64 s = __reduce_add_sync(
        peers, static_cast<unsigned>((in[word] >> shift) & 0xFFFFull));
    const u64 c = add_carry(w[word], s << shift);
    if (word < 2) {
      u64 c2 = add_carry(w[word + 1], shift ? s >> (64 - shift) : 0ull);
      c2 += add_carry(w[word + 1], c);
      if (word < 1) w[2] += c2;
    }
  }
  x0 = w[0];
  x1 = w[1];
  x2 = w[2];
}

// acc (three words, little-endian) += (v0, v1, v2) modulo 2^192
__device__ __forceinline__ void add192(u64& a0, u64& a1, u64& a2, u64 v0,
                                       u64 v1, u64 v2) {
  const u64 c0 = add_carry(a0, v0);
  const u64 t = v1 + c0;
  u64 c1 = t < c0 ? 1ull : 0ull;  // v1 = 2^64 - 1 and a carry in
  c1 += add_carry(a1, t);
  a2 += v2 + c1;
}

// each lane's digit sums -> their sums over the warp (a butterfly, so every
// lane ends with them)
__device__ __forceinline__ void warp_sum_digits(u64 (&d)[4]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int w = 0; w < 4; ++w) d[w] += __shfl_xor_sync(kFull, d[w], off);
  }
}

// the group's total and its flag |total| >= bound, as the limbs [hi, lo]
// of the low 128 bits
__device__ __forceinline__ void store_total(u64 m0, u64 m1, u64 m2,
                                            u64 bound_lo, u64 bound_hi,
                                            int64_t g,
                                            int64_t* __restrict__ out,
                                            bool* __restrict__ over) {
  out[2 * g] = static_cast<int64_t>(m1);
  out[2 * g + 1] = static_cast<int64_t>(m0);
  if (static_cast<int64_t>(m2) < 0) {  // the magnitude of a negative total
    m0 = ~m0 + 1ull;
    const u64 c1 = m0 == 0 ? 1ull : 0ull;
    m1 = ~m1 + c1;
    m2 = ~m2 + ((c1 && m1 == 0) ? 1ull : 0ull);
  }
  over[g] = m2 != 0 || m1 > bound_hi || (m1 == bound_hi && m0 >= bound_lo);
}

// kRows consecutive rows from row i0 (a multiple of kRows; the caller's
// pointers 16-byte aligned): each row's group id, -1 where it does not
// contribute, and its value as (lo, hi)
template <bool kWide, typename GidT>
__device__ __forceinline__ void load_rows(const int64_t* __restrict__ a,
                                          const bool* __restrict__ contrib,
                                          const GidT* __restrict__ gid,
                                          int64_t i0, GidT (&g)[kRows],
                                          u64 (&lo)[kRows],
                                          u64 (&hi)[kRows]) {
  if constexpr (sizeof(GidT) == 8) {
    const longlong2* p = reinterpret_cast<const longlong2*>(gid + i0);
#pragma unroll
    for (int j = 0; j < kRows / 2; ++j) {
      const longlong2 v = __ldg(p + j);
      g[2 * j] = static_cast<GidT>(v.x);
      g[2 * j + 1] = static_cast<GidT>(v.y);
    }
  } else {
    const int4* p = reinterpret_cast<const int4*>(gid + i0);
#pragma unroll
    for (int j = 0; j < kRows / 4; ++j) {
      const int4 v = __ldg(p + j);
      g[4 * j] = v.x;
      g[4 * j + 1] = v.y;
      g[4 * j + 2] = v.z;
      g[4 * j + 3] = v.w;
    }
  }
  if constexpr (kWide) {
    const longlong2* p = reinterpret_cast<const longlong2*>(a + 2 * i0);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const longlong2 v = __ldg(p + j);
      hi[j] = static_cast<u64>(v.x);
      lo[j] = static_cast<u64>(v.y);
    }
  } else {
    const longlong2* p = reinterpret_cast<const longlong2*>(a + i0);
#pragma unroll
    for (int j = 0; j < kRows / 2; ++j) {
      const longlong2 v = __ldg(p + j);
      lo[2 * j] = static_cast<u64>(v.x);
      lo[2 * j + 1] = static_cast<u64>(v.y);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      hi[j] = static_cast<int64_t>(lo[j]) < 0 ? ~0ull : 0ull;
  }
  const unsigned* c = reinterpret_cast<const unsigned*>(contrib + i0);
#pragma unroll
  for (int j = 0; j < kRows / 4; ++j) {
    const unsigned w = __ldg(c + j);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (((w >> (8 * b)) & 0xFFu) == 0) g[4 * j + b] = -1;
  }
}

// one row into its group's accumulator, kept as four 64-bit sums of the
// value's 32-bit digits (the low three unsigned, the top one signed, so the
// sign needs no word of its own): four adds and no carries a row. A
// predicated add a group keeps the accumulators in registers; a group id
// outside [0, K) matches none. A batch holds fewer than 2^31 rows, so no
// digit sum of its rows wraps: the unsigned ones stay below 2^63, the
// signed one below 2^62 in magnitude, and the threads', warps' and blocks'
// sums are plain adds too.
template <int K, typename GidT>
__device__ __forceinline__ void add_row(u64 (&acc)[K][4], GidT g, u64 lo,
                                        u64 hi) {
  const u64 d0 = lo & 0xFFFFFFFFull, d1 = lo >> 32;
  const u64 d2 = hi & 0xFFFFFFFFull;
  const u64 d3 = static_cast<u64>(static_cast<int64_t>(hi) >> 32);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (g == static_cast<GidT>(k)) {
      acc[k][0] += d0;
      acc[k][1] += d1;
      acc[k][2] += d2;
      acc[k][3] += d3;
    }
  }
}

// digit sums -> their 192-bit total d0 + d1 2^32 + d2 2^64 + d3 2^96 (d3
// signed: d3 2^32 as 128 bits is [d3 << 32, d3 >> 32 arithmetic])
__device__ __forceinline__ void digits_to_192(const u64 (&d)[4], u64& x0,
                                              u64& x1, u64& x2) {
  x0 = d[0];
  x1 = x2 = 0;
  add192(x0, x1, x2, d[1] << 32, d[1] >> 32, 0);
  add192(x0, x1, x2, 0, d[2], 0);
  add192(x0, x1, x2, 0, d[3] << 32,
         static_cast<u64>(static_cast<int64_t>(d[3]) >> 32));
}

// the small-cap path's first kernel: every group's digit sums over the
// block's rows into partial[(block * cap + g) * 4 ..] (groups g < cap <=
// K)
template <int K, bool kWide, typename GidT>
__global__ void __launch_bounds__(kThreads)
d128_segsum_small_kernel(const int64_t* __restrict__ a,
                         const bool* __restrict__ contrib,
                         const GidT* __restrict__ gid, int64_t n, int cap,
                         u64* __restrict__ partial) {
  u64 acc[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0;
  const int64_t chunks = n / kRows;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       c < chunks; c += stride) {
    GidT g[kRows];
    u64 lo[kRows], hi[kRows];
    load_rows<kWide>(a, contrib, gid, c * kRows, g, lo, hi);
#pragma unroll
    for (int j = 0; j < kRows; ++j) add_row<K>(acc, g[j], lo[j], hi[j]);
  }
  // the rows past the last whole step: block 0's first threads
  const int64_t i = chunks * kRows + threadIdx.x;
  if (blockIdx.x == 0 && i < n && contrib[i]) {
    u64 lo, hi;
    load_value(a, kWide, i, lo, hi);
    add_row<K>(acc, gid[i], lo, hi);
  }
  __shared__ u64 warp_acc[kThreads / 32][K][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < cap) {  // the same for every lane
      warp_sum_digits(acc[k]);
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < 4; ++w) warp_acc[warp][k][w] = acc[k][w];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 4 * cap) {  // a thread a digit of a group
    const int k = threadIdx.x >> 2, w = threadIdx.x & 3;
    u64 x = 0;
    for (int v = 0; v < kThreads / 32; ++v) x += warp_acc[v][k][w];
    partial[4 * (static_cast<int64_t>(blockIdx.x) * cap + k) + w] = x;
  }
}

// the small-cap path's second kernel, a block a group: the blocks' digit
// sums added, then the 192-bit total, its limbs and its flag
__global__ void __launch_bounds__(kThreads)
d128_segsum_partials_kernel(const u64* __restrict__ partial, int blocks,
                            int cap, u64 bound_lo, u64 bound_hi,
                            int64_t* __restrict__ out,
                            bool* __restrict__ over) {
  const int g = blockIdx.x;
  u64 d[4] = {0, 0, 0, 0};
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    const u64* p = partial + 4 * (static_cast<int64_t>(b) * cap + g);
#pragma unroll
    for (int w = 0; w < 4; ++w) d[w] += p[w];
  }
  warp_sum_digits(d);
  __shared__ u64 warp_acc[kThreads / 32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < 4; ++w) warp_acc[warp][w] = d[w];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < kThreads / 32; ++v) {
#pragma unroll
      for (int w = 0; w < 4; ++w) d[w] += warp_acc[v][w];
    }
    u64 x0, x1, x2;
    digits_to_192(d, x0, x1, x2);
    store_total(x0, x1, x2, bound_lo, bound_hi, g, out, over);
  }
}

__global__ void d128_segsum_accumulate_kernel(
    const int64_t* __restrict__ a, int wide,
    const bool* __restrict__ contrib, const void* __restrict__ gid,
    int gid64, int64_t n, int64_t cap, u64* __restrict__ acc) {
  __shared__ int slot_key[kSlots];
  __shared__ u64 slot_acc[kSlots * 3];
  for (int j = threadIdx.x; j < kSlots; j += blockDim.x) {
    slot_key[j] = -1;
    slot_acc[3 * j] = slot_acc[3 * j + 1] = slot_acc[3 * j + 2] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  // the loop bound is the same for every lane of a warp, so the warp's
  // shuffles always see all 32 lanes
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    bool act = false;
    int64_t g = -1;
    u64 v0 = 0, v1 = 0, v2 = 0;
    if (i < n) {
      g = gid64 ? static_cast<const int64_t*>(gid)[i]
                : static_cast<int64_t>(static_cast<const int32_t*>(gid)[i]);
      act = contrib[i] && g >= 0 && g < cap;
      if (act) {
        load_value(a, wide, i, v0, v1);
        v2 = static_cast<int64_t>(v1) < 0 ? ~0ull : 0ull;
      }
    }
    // the lanes of one group (the inactive lanes form one of their own)
    const unsigned peers =
        __match_any_sync(kFull, act ? static_cast<u64>(g) : ~0ull);
    group_sum192(peers, v0, v1, v2);
    if (act && (__ffs(peers) - 1) == lane) {  // the group's first lane
      const int slot = static_cast<int>(g % kSlots);
      const int old = atomicCAS(&slot_key[slot], -1, static_cast<int>(g));
      if (old == -1 || old == static_cast<int>(g)) {
        atomic_add192(&slot_acc[3 * slot], v0, v1, v2);
      } else {
        atomic_add192(acc + 3 * g, v0, v1, v2);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kSlots; j += blockDim.x) {
    const int key = slot_key[j];
    if (key >= 0) {
      atomic_add192(acc + 3 * static_cast<int64_t>(key), slot_acc[3 * j],
                    slot_acc[3 * j + 1], slot_acc[3 * j + 2]);
    }
  }
}

__global__ void d128_segsum_finalize_kernel(const u64* __restrict__ acc,
                                            int64_t cap, u64 bound_lo,
                                            u64 bound_hi,
                                            int64_t* __restrict__ out,
                                            bool* __restrict__ over) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < cap; g += stride) {
    store_total(acc[3 * g], acc[3 * g + 1], acc[3 * g + 2], bound_lo,
                bound_hi, g, out, over);
  }
}

// 10^k as a 256-bit value (host side; k <= 76)
U256 pow10_256(int k) {
  U256 r = {{1, 0, 0, 0}};
  for (int i = 0; i < k; ++i) {
    u64 carry = 0;
    for (int w = 0; w < 4; ++w) {
      const unsigned __int128 t =
          static_cast<unsigned __int128>(r.w[w]) * 10u + carry;
      r.w[w] = static_cast<u64>(t);
      carry = static_cast<u64>(t >> 64);
    }
  }
  return r;
}

// 10^k / 2 (0 for k = 0)
U256 half_pow10(int k) {
  if (k == 0) return U256{{0, 0, 0, 0}};
  U256 r = pow10_256(k);
  for (int w = 0; w < 4; ++w) {
    const u64 next = w < 3 ? r.w[w + 1] : 0;
    r.w[w] = (r.w[w] >> 1) | (next << 63);
  }
  return r;
}

unsigned blocks_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// the most blocks a small-cap sum of n rows uses (its scratch holds their
// partials): one a kThreads steps of kRows rows, at most kMaxBlocks
int64_t small_blocks_max(int64_t n) { return blocks_for(n / kRows); }

// the blocks of one instantiation that fit on the card at once, found once
template <int K, bool kWide, typename GidT>
int64_t small_resident_blocks() {
  static const int64_t blocks = [] {
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, d128_segsum_small_kernel<K, kWide, GidT>, kThreads, 0);
    const int64_t b = static_cast<int64_t>(sms) * per_sm;
    return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
  }();
  return blocks;
}

template <int K, bool kWide, typename GidT>
int small_sum(const int64_t* a, const bool* contrib, const void* gid,
              int64_t n, int cap, const U256& bound, u64* partial,
              int64_t* out, bool* over, cudaStream_t s) {
  int64_t blocks = small_blocks_max(n);
  const int64_t resident = small_resident_blocks<K, kWide, GidT>();
  if (blocks > resident) blocks = resident;
  d128_segsum_small_kernel<K, kWide, GidT><<<static_cast<unsigned>(blocks),
                                             kThreads, 0, s>>>(
      a, contrib, static_cast<const GidT*>(gid), n, cap, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  d128_segsum_partials_kernel<<<static_cast<unsigned>(cap), kThreads, 0,
                                s>>>(partial, static_cast<int>(blocks), cap,
                                     bound.w[0], bound.w[1], out, over);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int small_sum_of(const int64_t* a, int wide, const bool* contrib,
                 const void* gid, int gid64, int64_t n, int cap,
                 const U256& bound, u64* partial, int64_t* out, bool* over,
                 cudaStream_t s) {
  if (wide) {
    return gid64 ? small_sum<K, true, int64_t>(a, contrib, gid, n, cap,
                                               bound, partial, out, over, s)
                 : small_sum<K, true, int32_t>(a, contrib, gid, n, cap,
                                               bound, partial, out, over, s);
  }
  return gid64 ? small_sum<K, false, int64_t>(a, contrib, gid, n, cap, bound,
                                              partial, out, over, s)
               : small_sum<K, false, int32_t>(a, contrib, gid, n, cap, bound,
                                              partial, out, over, s);
}

// the first instantiated bound K >= cap, so a few groups add a few times
template <int K, int... More>
int small_sum_any(const int64_t* a, int wide, const bool* contrib,
                  const void* gid, int gid64, int64_t n, int cap,
                  const U256& bound, u64* partial, int64_t* out, bool* over,
                  cudaStream_t s) {
  if constexpr (sizeof...(More) > 0) {
    if (cap > K)
      return small_sum_any<More...>(a, wide, contrib, gid, gid64, n, cap,
                                    bound, partial, out, over, s);
  }
  return small_sum_of<K>(a, wide, contrib, gid, gid64, n, cap, bound,
                         partial, out, over, s);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// Values are (n, 2) int64 limbs when their *_wide flag is set, else (n,)
// scaled int64; out is (n, 2) int64, over (n,) bool. n > 0, 0 <= k <= 76,
// 1 <= precision <= 38 (the wrapper checks).
int srt_d128_mul_rescaled(const void* a, int32_t a_wide, const void* b,
                          int32_t b_wide, int64_t n, int32_t k,
                          int32_t precision, void* out, void* over,
                          void* stream) {
  const U256 bound = pow10_256(precision);
  d128_mul_rescaled_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), a_wide,
      static_cast<const int64_t*>(b), b_wide, n, k, half_pow10(k),
      bound.w[0], bound.w[1], static_cast<int64_t*>(out),
      static_cast<bool*>(over));
  return static_cast<int>(cudaGetLastError());
}

// shift = to_scale - from_scale, |shift| <= 38
int srt_d128_rescale(const void* a, int32_t wide, int64_t n, int32_t shift,
                     int32_t precision, void* out, void* over,
                     void* stream) {
  const U256 bound = pow10_256(precision);
  const U256 up = pow10_256(shift > 0 ? shift : 0);
  d128_rescale_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), wide, n, shift, up.w[0], up.w[1],
      half_pow10(shift < 0 ? -shift : 0), bound.w[0], bound.w[1],
      static_cast<int64_t*>(out), static_cast<bool*>(over));
  return static_cast<int>(cudaGetLastError());
}

// The words of int64 scratch a segment sum of n rows into cap groups
// takes: the small-cap path's partials (a (cap, 4) block of digit sums a
// block), or the large-cap path's (cap, 3) accumulators.
int64_t srt_d128_segment_sum_scratch(int64_t n, int64_t cap) {
  return cap > kSmallCap ? 3 * cap : 4 * cap * small_blocks_max(n);
}

// The most groups the small-cap path takes.
int32_t srt_d128_segment_sum_small_cap() { return kSmallCap; }

// scratch: srt_d128_segment_sum_scratch(n, cap) int64 words; gid int64 when
// gid64 is set, else int32; out (cap, 2) int64, over (cap,) bool. cap >= 1;
// 0 <= n < 2^31; a, contrib and gid 16-byte aligned.
int srt_d128_segment_sum(const void* a, int32_t wide, const void* contrib,
                         const void* gid, int32_t gid64, int64_t n,
                         int64_t cap, int32_t precision, void* scratch,
                         void* out, void* over, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const U256 bound = pow10_256(precision);
  const int64_t* va = static_cast<const int64_t*>(a);
  const bool* vc = static_cast<const bool*>(contrib);
  u64* acc = static_cast<u64*>(scratch);
  int64_t* vo = static_cast<int64_t*>(out);
  bool* vf = static_cast<bool*>(over);
  if (cap <= kSmallCap) {
    return small_sum_any<1, 2, 4, 6, 8, 12, 16>(
        va, wide, vc, gid, gid64, n, static_cast<int>(cap), bound, acc, vo,
        vf, s);
  }
  cudaError_t err = cudaMemsetAsync(acc, 0, 3 * cap * sizeof(u64), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    d128_segsum_accumulate_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        va, wide, vc, gid, gid64, n, cap, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  d128_segsum_finalize_kernel<<<blocks_for(cap), kThreads, 0, s>>>(
      acc, cap, bound.w[0], bound.w[1], vo, vf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
