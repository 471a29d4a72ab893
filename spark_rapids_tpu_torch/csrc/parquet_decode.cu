// The Parquet page decode's device kernels, for sm_90a, with a plain C
// interface (loaded through ctypes by spark_rapids_tpu_torch/native.py,
// wrapped by spark_rapids_tpu_torch/io/parquet_kernels.py), and the host
// walk of a PLAIN BYTE_ARRAY stream.
//
// They replace the XLA code of spark_rapids_tpu/io/parquet_device.py:
//   pq_expand_hybrid      <- _expand_hybrid_device :404
//   pq_gather_fixed       <- the row choice of _mixed_kernel_builder :429
//   pq_gather_byte_array  <- the row choice of _ba_kernel_builder :457
//
// What bounds them on the card: bytes. Each output value costs a few
// loads of small, L2-resident tables (the run table, the dictionary, the
// row's position) and one store; the arithmetic is a binary search, a
// funnel shift and a mask. The simple design here is one thread per output
// value (per 16-byte granule of a string row) with coalesced stores; the
// reads it depends on (a binary search per position, a dictionary gather,
// byte loads of an unaligned source row) are what keep it from the byte
// bound, and what a later version would stage through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// runs: int64 (5, R) row-major: out_start, is_rle, rle_value, bit_base,
// width. packed: 4-byte aligned, readable to round_up(nb, 4) + 4 bytes;
// reads are clamped to [0, nb) byte by byte exactly as the JAX g(k) does
// whenever the four bytes of a value are not all inside.
__global__ void expand_hybrid_kernel(const int64_t* __restrict__ runs, int R,
                                     const uint8_t* __restrict__ packed,
                                     int64_t nb, int64_t cap,
                                     int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int64_t* out_start = runs;
  // searchsorted(out_start, i, right) - 1, clamped to [0, R - 1]
  int lo = 0, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(out_start + mid) <= i) lo = mid + 1; else hi = mid;
  }
  const int run = lo - 1 < 0 ? 0 : (lo - 1 > R - 1 ? R - 1 : lo - 1);
  int64_t v;
  if (__ldg(runs + R + run)) {
    v = __ldg(runs + 2 * (int64_t)R + run);
  } else {
    const int64_t w = __ldg(runs + 4 * (int64_t)R + run);
    const int64_t bit = __ldg(runs + 3 * (int64_t)R + run)
        + (i - __ldg(out_start + run)) * w;
    const int64_t byte0 = bit >> 3;
    const uint32_t shift = (uint32_t)(bit & 7);
    uint32_t dword;
    if (byte0 >= 0 && byte0 + 3 <= nb - 1) {
      // two aligned words and a funnel shift
      const int64_t a = byte0 & ~(int64_t)3;
      const uint32_t* p = reinterpret_cast<const uint32_t*>(packed + a);
      dword = __funnelshift_r(__ldg(p), __ldg(p + 1),
                              (uint32_t)(byte0 - a) * 8u);
    } else {
      dword = 0;
      for (int k = 0; k < 4; ++k)
        dword |= (uint32_t)__ldg(packed + clamp64(byte0 + k, 0, nb - 1))
                 << (8 * k);
    }
    const uint32_t mask = (uint32_t)((1ull << (uint32_t)w) - 1ull);
    v = (int64_t)((dword >> shift) & mask);
  }
  out[i] = (int32_t)v;
}

template <typename T>
__global__ void gather_fixed_kernel(const uint8_t* __restrict__ valid,
                                    const int32_t* __restrict__ pos,
                                    const int32_t* __restrict__ idx,
                                    int64_t nv, const T* __restrict__ dict,
                                    int64_t nd, const T* __restrict__ plain,
                                    int64_t np_, int64_t n_dict, int64_t cap,
                                    T* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= cap) return;
  T v = T(0);
  if (valid[i]) {
    const int64_t p = pos[i];
    if (p < n_dict) {
      const int64_t k = __ldg(idx + clamp64(p, 0, nv - 1));
      v = __ldg(dict + clamp64(k, 0, nd - 1));
    } else {
      v = __ldg(plain + clamp64(p - n_dict, 0, np_ - 1));
    }
  }
  out[i] = v;
}

// One thread a 16-byte granule of an output row: the row's entry (-1 for a
// null or a padding row), then the granule's bytes of it, zero past its
// length, stored as one 16- or 8-byte word where the row's width allows.
__global__ void gather_byte_array_kernel(
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ idx, int64_t nv,
    const int64_t* __restrict__ starts, const int32_t* __restrict__ lens,
    const uint8_t* __restrict__ blob, int64_t n_dict, int64_t d_entries,
    int64_t d_rows, int64_t p_entries, int64_t p_rows, int64_t cap,
    int64_t width, int64_t granules, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_len) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= cap * granules) return;
  const int64_t r = t / granules;
  const int64_t c0 = (t - r * granules) * 16;
  int64_t len = 0, start = 0;
  if (valid[r]) {
    const int64_t p = pos[r];
    int64_t e = -1;
    if (p < n_dict) {
      const int64_t k = clamp64(__ldg(idx + clamp64(p, 0, nv - 1)), 0,
                                d_rows - 1);
      if (k < d_entries) e = k;
    } else {
      const int64_t q = clamp64(p - n_dict, 0, p_rows - 1);
      if (q < p_entries) e = d_entries + q;
    }
    if (e >= 0) {
      len = __ldg(lens + e);
      start = __ldg(starts + e);
    }
  }
  if (c0 == 0) out_len[r] = (int32_t)len;
  const int64_t nbytes = width - c0 < 16 ? width - c0 : 16;
  union { uint4 v; uint8_t b[16]; } g;
  const uint8_t* src = blob + start + c0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    g.b[j] = (c0 + j < len) ? __ldg(src + j) : (uint8_t)0;
  uint8_t* dst = out + r * width + c0;
  if (nbytes == 16 && (width & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = g.v;
  } else if (nbytes == 8 && (width & 7) == 0) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(g.v.x, g.v.y);
  } else {
    for (int64_t j = 0; j < nbytes; ++j) dst[j] = g.b[j];
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int srt_pq_expand_hybrid(const void* runs, int32_t R, const void* packed,
                         int64_t nb, int64_t cap, void* out, void* stream) {
  expand_hybrid_kernel<<<blocks_for(cap), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int64_t*)runs, R, (const uint8_t*)packed, nb, cap,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int srt_pq_gather_fixed(int32_t elem_size, const void* valid, const void* pos,
                        const void* idx, int64_t nv, const void* dict,
                        int64_t nd, const void* plain, int64_t np_,
                        int64_t n_dict, int64_t cap, void* out, void* stream) {
  const unsigned blocks = blocks_for(cap);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* v = (const uint8_t*)valid;
  const int32_t* p = (const int32_t*)pos;
  const int32_t* x = (const int32_t*)idx;
  switch (elem_size) {
    case 1:
      gather_fixed_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(
          v, p, x, nv, (const uint8_t*)dict, nd, (const uint8_t*)plain, np_,
          n_dict, cap, (uint8_t*)out);
      break;
    case 2:
      gather_fixed_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          v, p, x, nv, (const uint16_t*)dict, nd, (const uint16_t*)plain,
          np_, n_dict, cap, (uint16_t*)out);
      break;
    case 4:
      gather_fixed_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
          v, p, x, nv, (const uint32_t*)dict, nd, (const uint32_t*)plain,
          np_, n_dict, cap, (uint32_t*)out);
      break;
    case 8:
      gather_fixed_kernel<unsigned long long><<<blocks, kThreads, 0, s>>>(
          v, p, x, nv, (const unsigned long long*)dict, nd,
          (const unsigned long long*)plain, np_, n_dict, cap,
          (unsigned long long*)out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int srt_pq_gather_byte_array(const void* valid, const void* pos,
                             const void* idx, int64_t nv, const void* starts,
                             const void* lens, const void* blob,
                             int64_t n_dict, int64_t d_entries,
                             int64_t d_rows, int64_t p_entries,
                             int64_t p_rows, int64_t cap, int64_t width,
                             void* out, void* out_len, void* stream) {
  const int64_t granules = (width + 15) / 16;
  gather_byte_array_kernel<<<blocks_for(cap * granules), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)valid, (const int32_t*)pos, (const int32_t*)idx, nv,
      (const int64_t*)starts, (const int32_t*)lens, (const uint8_t*)blob,
      n_dict, d_entries, d_rows, p_entries, p_rows, cap, width, granules,
      (uint8_t*)out, (int32_t*)out_len);
  return (int)cudaGetLastError();
}

// The PLAIN BYTE_ARRAY walk on the host (a u32 length before each value):
// each value's start and length, and the bytes walked, or -1 when the
// stream ends inside a value. Sequential by nature; the JAX package runs
// the same walk in its host C helper (srtpu_native.cpp srtpu_ba_walk).
int64_t srt_ba_walk(const uint8_t* buf, int64_t nbytes, int64_t n,
                    int64_t* starts, int64_t* lens) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (pos + 4 > nbytes) return -1;
    const uint32_t ln = (uint32_t)buf[pos] | ((uint32_t)buf[pos + 1] << 8) |
                        ((uint32_t)buf[pos + 2] << 16) |
                        ((uint32_t)buf[pos + 3] << 24);
    pos += 4;
    if (pos + (int64_t)ln > nbytes) return -1;
    starts[i] = pos;
    lens[i] = (int64_t)ln;
    pos += (int64_t)ln;
  }
  return pos;
}

}  // extern "C"
