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
// What bounds them on the card: bytes, and at the scan's shapes (a few MB a
// call) the latency of each chain of dependent loads more than the bytes.
//
// pq_expand_hybrid: a value's run is a search of the run table, then a
// read of the run's row, then a read of its packed bits. A block owns a
// tile of kTile consecutive outputs and searches once for the tile's first
// run (256 probes a round, by __syncthreads_count, until at most kWindow
// runs remain), stages a slice of kSlice runs into shared memory, and each
// thread takes kPerThread consecutive outputs. Where they lie in one run
// (the common case: runs of hundreds of values) the run's row is read once
// and each value is a funnel shift of two aligned 32-bit words at 32-bit
// offsets from the group's first word (neighbouring threads, neighbouring
// words); else the thread walks forward through the slice output by
// output. A tile that spans more runs than a slice (runs of length 1)
// walks slice after slice. The outputs go out as 16-byte stores. What is
// left is the launch and a short chain (search, slice, words, stores):
// the kernel with its body taken out takes most of the byte bound at 2^20
// outputs (PERF.md, parquet_kernel_ab.py).
//
// pq_gather_byte_array: a row's bytes hang off a chain (validity and
// position, dictionary index, entry start and length, then the bytes).
// Each thread takes kRows rows (validity and positions loaded as one
// uchar4 and one int4) and one 16-byte granule column of them, and issues
// each link of the chain for all its rows before the next link, the page
// bytes' loads of every row too, with no branch between them, so the
// latencies overlap. A granule is built from at most two aligned 16-byte
// loads of the page bytes, realigned by a word select and funnel shifts;
// no byte loads on the common path (a row reaching outside the page bytes
// is read byte by byte, clamped).
//
// pq_gather_fixed: one thread an output; the dictionary is small and stays
// in L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// pq_expand_hybrid
// ---------------------------------------------------------------------------
constexpr int kPerThread = 8;                         // outputs a thread
constexpr int64_t kTile = (int64_t)kThreads * kPerThread;  // outputs a block
constexpr int kSlice = kThreads;                      // runs staged at once
constexpr int64_t kWindow = 32;                       // the search stops here

// A slice of the run table in shared memory.
struct RunSlice {
  int64_t start[kSlice];
  int64_t bit_base[kSlice];
  int64_t width[kSlice];
  int32_t value[kSlice];   // the RLE value, cut to 32 bits as the output is
  int32_t is_rle[kSlice];
};

// The value at output i of slice run r. packed: 4-byte aligned, readable to
// round_up(nb, 4) + 4 bytes. Where the four bytes from the value's first
// byte are all inside [0, nb) they come from two aligned words; else byte by
// byte, each byte's index clamped to [0, nb) exactly as the JAX g(k) does.
// Either way the field holds the 32 - (bit & 7) bits that those four bytes
// hold from the value's first bit, as the JAX dword >> shift does.
__device__ __forceinline__ int32_t hybrid_value(const RunSlice& s, int r,
                                                int64_t i,
                                                const uint8_t* __restrict__ packed,
                                                int64_t nb) {
  if (s.is_rle[r]) return s.value[r];
  const int64_t w = s.width[r];
  const int64_t bit = s.bit_base[r] + (i - s.start[r]) * w;
  const int64_t byte0 = bit >> 3;
  const uint32_t shift = (uint32_t)(bit & 7);
  uint32_t field;
  if (byte0 >= 0 && byte0 + 3 <= nb - 1) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(packed);
    const int64_t k = bit >> 5;
    field = __funnelshift_r(__ldg(words + k), __ldg(words + k + 1),
                            (uint32_t)(bit & 31)) & (0xFFFFFFFFu >> shift);
  } else {
    uint32_t dword = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dword |= (uint32_t)__ldg(packed + clamp64(byte0 + k, 0, nb - 1))
               << (8 * k);
    field = dword >> shift;
  }
  const uint32_t mask = (uint32_t)((1ull << (uint32_t)w) - 1ull);
  return (int32_t)(field & mask);
}

// The kPerThread outputs from i0, all in slice run r: the run's row read
// once; where every value's four bytes lie inside [0, nb), each value is a
// funnel shift of two aligned words at 32-bit offsets from the group's
// first word, else hybrid_value for each.
__device__ __forceinline__ void expand_group(const RunSlice& s, int r,
                                             int64_t i0,
                                             const uint8_t* __restrict__ packed,
                                             int64_t nb, int32_t* vals) {
  if (s.is_rle[r]) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) vals[j] = s.value[r];
    return;
  }
  const int64_t w = s.width[r];
  const int64_t bit0 = s.bit_base[r] + (i0 - s.start[r]) * w;
  if (w >= 0 && w <= 32 && bit0 >= 0
      && ((bit0 + (kPerThread - 1) * w) >> 3) + 3 <= nb - 1) {
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(packed) + (bit0 >> 5);
    const uint32_t off = (uint32_t)(bit0 & 31), wu = (uint32_t)w;
    const uint32_t mask = (uint32_t)((1ull << wu) - 1ull);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const uint32_t o = off + (uint32_t)j * wu;   // below 32 * kPerThread
      const uint32_t k = o >> 5;
      vals[j] = (int32_t)(__funnelshift_r(__ldg(words + k),
                                          __ldg(words + k + 1), o)
                          & (0xFFFFFFFFu >> (o & 7)) & mask);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      vals[j] = hybrid_value(s, r, i0 + j, packed, nb);
  }
}

// runs: int64 (5, R) row-major: out_start (ascending), is_rle, rle_value,
// bit_base, width. Output i takes run searchsorted(out_start, i, right) - 1,
// clamped to [0, R - 1].
__global__ void __launch_bounds__(kThreads) expand_hybrid_kernel(
    const int64_t* __restrict__ runs, int R,
    const uint8_t* __restrict__ packed, int64_t nb, int64_t cap,
    int32_t* __restrict__ out) {
  __shared__ RunSlice s;
  const int tid = threadIdx.x;
  const int64_t t0 = blockIdx.x * kTile;
  const int64_t t1 = t0 + kTile < cap ? t0 + kTile : cap;
  const int64_t* out_start = runs;

  // The tile's first run f lies in [lo, lo + span): each round probes 256
  // evenly spaced starts; those <= t0 are a prefix, so their count names
  // the stride that holds f. No start <= t0 (only at lo = 0): f clamps to 0.
  int64_t lo = 0, span = R;
  while (span > kWindow) {
    const int64_t stride = (span + kThreads - 1) / kThreads;
    const int64_t p = lo + tid * stride;
    const int c = __syncthreads_count(p < lo + span
                                      && __ldg(out_start + p) <= t0);
    if (c == 0) break;
    const int64_t nlo = lo + (c - 1) * stride;
    span = stride < lo + span - nlo ? stride : lo + span - nlo;
    lo = nlo;
  }

  // Slice after slice from run lo; this thread's outputs in [from, next)
  // belong to the runs of the slice (next: the start of the run after it).
  const int64_t i0 = t0 + (int64_t)tid * kPerThread;
  int32_t vals[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) vals[j] = 0;
  int64_t from = t0;
  for (int64_t base = lo;; base += kSlice) {
    const int n = R - base < kSlice ? (int)(R - base) : kSlice;
    int64_t start = 0;
    if (tid < n) {
      const int64_t g = base + tid;
      start = __ldg(out_start + g);
      s.start[tid] = start;
      s.is_rle[tid] = __ldg(runs + R + g) != 0;
      s.value[tid] = (int32_t)__ldg(runs + 2 * (int64_t)R + g);
      s.bit_base[tid] = __ldg(runs + 3 * (int64_t)R + g);
      s.width[tid] = __ldg(runs + 4 * (int64_t)R + g);
    }
    const int64_t next = base + kSlice < R ? __ldg(out_start + base + kSlice)
                                           : INT64_MAX;
    // the slice's runs that start before t1: a prefix of it
    int m = __syncthreads_count(tid < n && start < t1);
    m = m > 0 ? m : 1;
    const int64_t first = i0 > from ? i0 : from;
    int64_t stop = next < t1 ? next : t1;
    stop = stop < i0 + kPerThread ? stop : i0 + kPerThread;
    if (first < stop) {
      int a = 0, b = m;   // a: the slice's starts <= first
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (s.start[mid] <= first) a = mid + 1; else b = mid;
      }
      const int r0 = a > 0 ? a - 1 : 0;
      if (first == i0 && stop == i0 + kPerThread
          && (r0 + 1 >= m || s.start[r0 + 1] >= stop)) {
        expand_group(s, r0, i0, packed, nb, vals);
      } else {
        int r = r0;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int64_t i = i0 + j;
          if (i >= first && i < stop) {
            while (r + 1 < m && s.start[r + 1] <= i) ++r;
            vals[j] = hybrid_value(s, r, i, packed, nb);
          }
        }
      }
    }
    if (next >= t1) break;
    from = next;
    __syncthreads();   // every thread is done with the slice
  }

  if (i0 + kPerThread <= cap) {
    int4* dst = reinterpret_cast<int4*>(out + i0);
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q)
      dst[q] = make_int4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2],
                         vals[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (i0 + j < cap) out[i0 + j] = vals[j];
  }
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

// ---------------------------------------------------------------------------
// pq_gather_byte_array
// ---------------------------------------------------------------------------
constexpr int kRows = 4;   // rows a thread

// The bytes [0, n) of a word kept, the rest zero (n may be out of 0..4).
__device__ __forceinline__ uint32_t low_bytes(uint32_t v, int n) {
  return n >= 4 ? v : (n <= 0 ? 0u : v & ((1u << (8 * n)) - 1u));
}

// Bytes [off, off + keep) of the 32 bytes lo:hi (off < 16, keep <= 16) as
// a 16-byte granule, zero past keep: a word select and a funnel shift.
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int off,
                                         int keep) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = off >> 2;
  uint32_t u[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    u[k] = q == 0 ? w[k] : (q == 1 ? w[k + 1]
                            : (q == 2 ? w[k + 2] : w[k + 3]));
  const uint32_t sh = 8u * (uint32_t)(off & 3);
  return make_uint4(low_bytes(__funnelshift_r(u[0], u[1], sh), keep),
                    low_bytes(__funnelshift_r(u[1], u[2], sh), keep - 4),
                    low_bytes(__funnelshift_r(u[2], u[3], sh), keep - 8),
                    low_bytes(__funnelshift_r(u[3], u[4], sh), keep - 12));
}

// Bytes [s, s + keep) of blob byte by byte, each index clamped to
// [0, n_blob) as the plain version clamps it: a row reaching outside.
__device__ __noinline__ uint4 clamped_granule(const uint8_t* __restrict__ blob,
                                              int64_t n_blob, int64_t s,
                                              int keep) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
  if (n_blob > 0)
    for (int j = 0; j < keep; ++j)
      o[j >> 2] |= (uint32_t)__ldg(blob + clamp64(s + j, 0, n_blob - 1))
                   << (8 * (j & 3));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The first nbytes of a granule to dst = out + r * width + c0, in the
// widest stores the row's width keeps aligned.
__device__ __forceinline__ void store_granule(uint8_t* dst, uint4 g,
                                              int nbytes, int64_t width) {
  if (nbytes == 16 && (width & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = g;
  } else if ((width & 7) == 0) {   // nbytes is 8 or 16
    uint2* d = reinterpret_cast<uint2*>(dst);
    d[0] = make_uint2(g.x, g.y);
    if (nbytes == 16) d[1] = make_uint2(g.z, g.w);
  } else {
    const uint32_t w[4] = {g.x, g.y, g.z, g.w};
    if ((width & 3) == 0) {
      for (int k = 0; k < nbytes / 4; ++k)
        reinterpret_cast<uint32_t*>(dst)[k] = w[k];
    } else {
      for (int j = 0; j < nbytes; ++j)
        dst[j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// One thread: kRows rows from r0 and their granule at byte c0. The row's
// entry (-1 for a null or a padding row), then the granule's bytes of the
// entry, zero past its length; out_len from the thread of granule 0.
__global__ void __launch_bounds__(kThreads) gather_byte_array_kernel(
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ idx, int64_t nv,
    const int64_t* __restrict__ starts, const int32_t* __restrict__ lens,
    const uint8_t* __restrict__ blob, int64_t n_blob, int64_t n_dict,
    int64_t d_entries, int64_t d_rows, int64_t p_entries, int64_t p_rows,
    int64_t cap, int64_t width, int64_t granules,
    uint8_t* __restrict__ out, int32_t* __restrict__ out_len) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t groups = (cap + kRows - 1) / kRows;
  if (t >= groups * granules) return;
  const int64_t q = t / granules;
  const int64_t c0 = (t - q * granules) * 16;
  const int64_t r0 = q * kRows;
  const bool whole = r0 + kRows <= cap;

  // 1. validity and positions
  int32_t v[kRows], p[kRows];
  if (whole && ((uintptr_t)(valid + r0) & 3) == 0
      && ((uintptr_t)(pos + r0) & 15) == 0) {
    const uchar4 vv = __ldg(reinterpret_cast<const uchar4*>(valid + r0));
    const int4 pp = __ldg(reinterpret_cast<const int4*>(pos + r0));
    v[0] = vv.x; v[1] = vv.y; v[2] = vv.z; v[3] = vv.w;
    p[0] = pp.x; p[1] = pp.y; p[2] = pp.z; p[3] = pp.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const bool in = r0 + j < cap;
      v[j] = in ? __ldg(valid + r0 + j) : 0;
      p[j] = in ? __ldg(pos + r0 + j) : 0;
    }
  }
  // 2. the dictionary index of each row that takes one
  int64_t k[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    k[j] = (v[j] && p[j] < n_dict)
               ? (int64_t)__ldg(idx + clamp64(p[j], 0, nv - 1)) : 0;
  // 3. each row's entry, then its length and start
  int32_t len[kRows];
  int64_t start[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    int64_t e = -1;
    if (v[j]) {
      if (p[j] < n_dict) {
        const int64_t kk = clamp64(k[j], 0, d_rows - 1);
        if (kk < d_entries) e = kk;
      } else {
        const int64_t qq = clamp64((int64_t)p[j] - n_dict, 0, p_rows - 1);
        if (qq < p_entries) e = d_entries + qq;
      }
    }
    len[j] = e >= 0 ? __ldg(lens + e) : 0;
    start[j] = e >= 0 ? __ldg(starts + e) : 0;
  }
  // 4. each row's granule: bytes [src, src + keep) of blob. Inside
  // [0, n_blob) (blob 16-byte aligned, readable to round_up(n_blob, 16)):
  // the aligned 16-byte piece that holds src and, where the bytes cross
  // into it, the next one, loaded under predicates with no branch between
  // the rows, so every row's loads are in flight together; a row reaching
  // outside, byte by byte after.
  uint4 g[kRows];
  int keep[kRows];
  bool inside[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int64_t used = (len[j] < width ? len[j] : width) - c0;
    keep[j] = (int)(used < 0 ? 0 : (used > 16 ? 16 : used));
    const int64_t src = start[j] + c0;
    inside[j] = keep[j] > 0 && src >= 0 && src + keep[j] <= n_blob;
    const uint4* piece = reinterpret_cast<const uint4*>(
        blob + (inside[j] ? src & ~(int64_t)15 : 0));
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 lo = inside[j] ? __ldg(piece) : zero;
    const uint4 hi = inside[j] && (int)(src & 15) + keep[j] > 16
                         ? __ldg(piece + 1) : zero;
    g[j] = realign(lo, hi, (int)(src & 15), keep[j]);
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (keep[j] > 0 && !inside[j])
      g[j] = clamped_granule(blob, n_blob, start[j] + c0, keep[j]);
  // 5. stores
  if (c0 == 0) {
    if (whole) {
      *reinterpret_cast<int4*>(out_len + r0) =
          make_int4(len[0], len[1], len[2], len[3]);
    } else {
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < cap) out_len[r0 + j] = len[j];
    }
  }
  if (width == 8 && whole) {   // the 4 rows are 32 consecutive bytes
    uint4* dst = reinterpret_cast<uint4*>(out + r0 * 8);
    dst[0] = make_uint4(g[0].x, g[0].y, g[1].x, g[1].y);
    dst[1] = make_uint4(g[2].x, g[2].y, g[3].x, g[3].y);
    return;
  }
  const int nbytes = width - c0 < 16 ? (int)(width - c0) : 16;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (r0 + j < cap)
      store_granule(out + (r0 + j) * width + c0, g[j], nbytes, width);
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int srt_pq_expand_hybrid(const void* runs, int32_t R, const void* packed,
                         int64_t nb, int64_t cap, void* out, void* stream) {
  expand_hybrid_kernel<<<(unsigned)((cap + kTile - 1) / kTile), kThreads, 0,
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
                             int64_t n_blob, int64_t n_dict,
                             int64_t d_entries, int64_t d_rows,
                             int64_t p_entries, int64_t p_rows, int64_t cap,
                             int64_t width, void* out, void* out_len,
                             void* stream) {
  const int64_t granules = (width + 15) / 16;
  const int64_t threads = (cap + kRows - 1) / kRows * granules;
  gather_byte_array_kernel<<<blocks_for(threads), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)valid, (const int32_t*)pos, (const int32_t*)idx, nv,
      (const int64_t*)starts, (const int32_t*)lens, (const uint8_t*)blob,
      n_blob, n_dict, d_entries, d_rows, p_entries, p_rows, cap, width,
      granules, (uint8_t*)out, (int32_t*)out_len);
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
