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
// d128_segment_sum keeps a 192-bit signed accumulator a group, three
// uint64 words in global memory zeroed by the caller: a batch of up to 2^31
// rows below 2^127 each sums to under 2^158, which 128 bits would wrap. A
// row's 192-bit value is added word by word with 64-bit atomics, the carry
// out of each word read from the atomic's old value and added into the next
// word: integer addition is exact and commutative, so the total is the same
// in every run whatever the order. Before the atomics the lanes of a warp
// that share a group add their rows (every group of the warp at once, in
// twelve 16-bit warp reductions, __reduce_add_sync), the group's first lane
// adds the sum into a shared-memory slot of the block (or, where the slot
// holds another group, into global memory), and the block adds its slots
// into global memory at its end: one group (Q6's grand total) or a few
// (Q1's) cost each block a few global atomics instead of one a row. A
// second kernel reads each group's total and writes its limbs and flag.
//
// Bound: memory. Each kernel reads its rows once and writes its outputs
// once; the arithmetic is a few dozen integer operations a row (the 64-bit
// divisions of a scale drop more).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
// shared-memory accumulator slots of a segment-sum block
constexpr int kSlots = 256;
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
    u64 m0 = acc[3 * g], m1 = acc[3 * g + 1], m2 = acc[3 * g + 2];
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

// acc: (cap, 3) zeroed 64-bit words; gid int64 when gid64 is set, else
// int32; out (cap, 2) int64, over (cap,) bool. cap >= 1; n may be 0.
int srt_d128_segment_sum(const void* a, int32_t wide, const void* contrib,
                         const void* gid, int32_t gid64, int64_t n,
                         int64_t cap, int32_t precision, void* acc,
                         void* out, void* over, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    d128_segsum_accumulate_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int64_t*>(a), wide,
        static_cast<const bool*>(contrib), gid, gid64, n, cap,
        static_cast<u64*>(acc));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const U256 bound = pow10_256(precision);
  d128_segsum_finalize_kernel<<<blocks_for(cap), kThreads, 0, s>>>(
      static_cast<const u64*>(acc), cap, bound.w[0], bound.w[1],
      static_cast<int64_t*>(out), static_cast<bool*>(over));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
