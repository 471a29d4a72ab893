// The window functions' scan, frame-bound search and frame reduction, for
// sm_90a.
//
// Replaces the XLA code of spark_rapids_tpu/exec/window.py:
//   - seg_scan: _segmented_scan :41 (a lax.associative_scan) at every call:
//     the segment starts :88, the dense rank :210, the first row of a peer
//     group :213, the running min/max :498-505; and the running and
//     whole-partition float sums, which the JAX package takes as
//     differences of prefix sums over the whole sorted batch (:296), so
//     that one partition's large value wipes out the next one's sums;
//   - frame_bounds: _device_bsearch :414, the bounds of a bounded RANGE
//     frame (:368-371);
//   - frame_reduce: _device_range_minmax :431 (a sparse table of log2(n)
//     levels, n * 8 B a level) and the bounded-frame float sums of
//     reduce_frame :300-313.
// Plain versions and wrappers: exec/window_kernels.py.
//
// seg_scan: an inclusive scan of (flag, value) pairs under
// (fa, va) . (fb, vb) = (fa | fb, fb ? vb : op(va, vb)), so it restarts
// where a flag is set. op is add (integers wrap, as int64 does in torch),
// min or max; float min and max follow Spark's order (NaN above +inf,
// -0.0 below 0.0), through the bits' order key, and a NaN result is the
// canonical NaN. Three kernels over tiles of kTile = 2048 rows: (1) each
// block reduces its tile to a pair; (2) one block scans the tiles' pairs
// into each tile's carry-in; (3) each block scans its tile again from its
// carry-in and writes it. A tile's rows are
// staged through shared memory so every global access is coalesced; within
// a block a thread scans its kItems rows, the warps their threads' pairs
// (shuffles), warp 0 the warps' pairs. Identities (0, -0.0 for a float
// add, the type's extremes, NaN for a float min) make an empty prefix a
// no-op bit for bit. The order of the float adds is fixed by n alone, so
// the bits are the same every run.
//
// frame_bounds: a thread a row, a binary search of [lo, hi) for the first
// key >= its target (> when strict), the search of _device_bsearch.
//
// frame_reduce: a thread a row, the sum, min or max of the valid values of
// [lo, hi) and their count. A frame of at most kShort rows is read row by
// row; a longer one walks up and down three levels of block aggregates
// (32, 1024 and 32768 rows, one aggregate and one count each, about n / 31
// entries in all, built by one kernel a call): at most 31 rows, then 31
// aggregates of each level at each end, plus the 32768-row blocks between.
// Each frame is reduced in a fixed order, so the bits are the same every
// run; a float sum adds the frame's own values only, so NaN and +-inf
// propagate as in Spark and no value outside the frame enters it.
//
// Bound: memory. seg_scan reads its values and flags twice (the tile
// reduce, then the scan) and writes the values once; frame_bounds reads its
// key, target, lo and hi and writes its output (each binary search's reads
// beyond the row's own key hit lines its neighbours read); frame_reduce
// reads each row's value, flag, lo and hi and writes the value and the
// count (a short frame's other rows are its neighbours'), plus the tables.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int64_t kMaxBlocks = 132 * 16;

enum Op { kAdd = 0, kMin = 1, kMax = 2 };
enum Dtype { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3 };

// Spark's order of a double as a signed key: NaN above +inf, -0.0 below
// 0.0 (a negative's magnitude bits flipped).
__device__ __forceinline__ long long order_key(double x) {
  if (x != x) return LLONG_MAX;
  long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & LLONG_MAX);
}

template <typename T>
struct Arith {
  static constexpr bool kFloat = false;
};
template <>
struct Arith<float> {
  static constexpr bool kFloat = true;
};
template <>
struct Arith<double> {
  static constexpr bool kFloat = true;
};

template <typename T, int OP>
__device__ __forceinline__ T identity() {
  if (OP == kAdd) {
    if (Arith<T>::kFloat) return static_cast<T>(-0.0);
    return T(0);
  }
  if (Arith<T>::kFloat) {
    // NaN is the greatest under Spark's order: min's identity; -inf max's
    return OP == kMin ? static_cast<T>(__longlong_as_double(
                            0x7FF8000000000000LL))
                      : static_cast<T>(-__longlong_as_double(
                            0x7FF0000000000000LL));
  }
  if (sizeof(T) == 4) return OP == kMin ? T(INT_MAX) : T(INT_MIN);
  return OP == kMin ? T(LLONG_MAX) : T(LLONG_MIN);
}

template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {
  if (OP == kAdd) {
    if (Arith<T>::kFloat) return a + b;
    // two's complement wrap without signed overflow
    if (sizeof(T) == 4)
      return static_cast<T>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
    return static_cast<T>(static_cast<unsigned long long>(a) +
                          static_cast<unsigned long long>(b));
  }
  if (Arith<T>::kFloat) {
    long long ka = order_key(static_cast<double>(a));
    long long kb = order_key(static_cast<double>(b));
    if (OP == kMin) return kb < ka ? b : a;
    return kb > ka ? b : a;
  }
  if (OP == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

// A float min or max gives NaN as the one canonical NaN: NaNs tie under
// the order key, so which one's bits a reduction kept would depend on its
// grouping.
template <typename T, int OP>
__device__ __forceinline__ T finish(T v) {
  if (OP != kAdd && Arith<T>::kFloat && v != v) return identity<T, kMin>();
  return v;
}

// the segmented operator on (flag, value) pairs, a before b
template <typename T, int OP>
__device__ __forceinline__ void combine(bool fa, T va, bool& fb, T& vb) {
  vb = fb ? vb : apply<T, OP>(va, vb);
  fb = fa || fb;
}

template <typename T, int OP>
__device__ __forceinline__ void warp_inclusive(bool& f, T& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T ov = __shfl_up_sync(kFull, v, d);
    int of = __shfl_up_sync(kFull, static_cast<int>(f), d);
    if (lane >= d) combine<T, OP>(of != 0, ov, f, v);
  }
}

// Block-wide exclusive scan of the threads' pairs in thread order: each
// thread gets the pair of every thread before it (the identity for thread
// 0); *total, if given, the pair of the whole block.
template <typename T, int OP>
__device__ void block_exclusive(bool f, T v, bool& pf, T& pv, bool* tf,
                                T* tv) {
  __shared__ T s_v[kWarps];
  __shared__ bool s_f[kWarps];
  __shared__ T s_total_v;
  __shared__ bool s_total_f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_inclusive<T, OP>(f, v);
  T ev = __shfl_up_sync(kFull, v, 1);
  int ef = __shfl_up_sync(kFull, static_cast<int>(f), 1);
  if (lane == 0) {
    ev = identity<T, OP>();
    ef = 0;
  }
  if (lane == 31) {
    s_v[warp] = v;
    s_f[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    bool wf = lane < kWarps ? s_f[lane] : false;
    T wv = lane < kWarps ? s_v[lane] : identity<T, OP>();
    warp_inclusive<T, OP>(wf, wv);
    T xv = __shfl_up_sync(kFull, wv, 1);
    int xf = __shfl_up_sync(kFull, static_cast<int>(wf), 1);
    if (lane == kWarps - 1) {
      s_total_v = wv;
      s_total_f = wf;
    }
    if (lane == 0) {
      xv = identity<T, OP>();
      xf = 0;
    }
    __syncwarp();
    if (lane < kWarps) {
      s_v[lane] = xv;
      s_f[lane] = xf != 0;
    }
  }
  __syncthreads();
  pf = ef != 0;
  pv = ev;
  combine<T, OP>(s_f[warp], s_v[warp], pf, pv);
  if (tf != nullptr) {
    *tf = s_total_f;
    *tv = s_total_v;
  }
  __syncthreads();  // the shared pairs are reused by the next call
}

// A tile's rows into shared memory (striped, coalesced), then each thread's
// kItems consecutive rows out of it. Rows past n are flagged identities.
template <typename T, int OP>
__device__ void load_tile(const T* __restrict__ vals,
                          const uint8_t* __restrict__ flags, int64_t base,
                          int64_t n, T* sv, uint8_t* sf, T (&v)[kItems],
                          bool (&f)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const int64_t i = base + j;
    sv[j] = i < n ? vals[i] : identity<T, OP>();
    sf[j] = i < n ? flags[i] : 1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = sv[threadIdx.x * kItems + k];
    f[k] = sf[threadIdx.x * kItems + k] != 0;
  }
  __syncthreads();
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    seg_scan_tiles(const T* __restrict__ vals,
                   const uint8_t* __restrict__ flags, int64_t n,
                   T* __restrict__ tile_v, uint8_t* __restrict__ tile_f) {
  __shared__ T sv[kTile];
  __shared__ uint8_t sf[kTile];
  T v[kItems];
  bool f[kItems];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  load_tile<T, OP>(vals, flags, base, n, sv, sf, v, f);
  bool af = false;
  T av = identity<T, OP>();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    // rows past n are flagged: the tile's pair ends at its last real row
    if (base + threadIdx.x * kItems + k < n) {
      bool fk = f[k];
      T vk = v[k];
      combine<T, OP>(af, av, fk, vk);
      af = fk;
      av = vk;
    }
  }
  bool pf, tf;
  T pv, tv;
  block_exclusive<T, OP>(af, av, pf, pv, &tf, &tv);
  if (threadIdx.x == 0) {
    tile_v[blockIdx.x] = tv;
    tile_f[blockIdx.x] = tf;
  }
}

// One block: each tile's carry-in, the pair of every tile before it.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    seg_scan_carries(const T* __restrict__ tile_v,
                     const uint8_t* __restrict__ tile_f, int64_t tiles,
                     T* __restrict__ carry_v, uint8_t* __restrict__ carry_f) {
  bool rf = false;
  T rv = identity<T, OP>();
  for (int64_t base = 0; base < tiles; base += kTile) {
    T v[kItems];
    bool f[kItems];
    bool af = false;
    T av = identity<T, OP>();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + threadIdx.x * kItems + k;
      v[k] = i < tiles ? tile_v[i] : identity<T, OP>();
      f[k] = i < tiles ? tile_f[i] != 0 : false;
      bool fk = f[k];
      T vk = v[k];
      combine<T, OP>(af, av, fk, vk);
      af = fk;
      av = vk;
    }
    bool pf, tf;
    T pv, tv;
    block_exclusive<T, OP>(af, av, pf, pv, &tf, &tv);
    combine<T, OP>(rf, rv, pf, pv);  // the chunks before this one
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + threadIdx.x * kItems + k;
      if (i < tiles) {
        carry_v[i] = pv;
        carry_f[i] = pf;
      }
      combine<T, OP>(pf, pv, f[k], v[k]);
      pf = f[k];
      pv = v[k];
    }
    combine<T, OP>(rf, rv, tf, tv);
    rf = tf;
    rv = tv;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    seg_scan_write(const T* __restrict__ vals,
                   const uint8_t* __restrict__ flags, int64_t n,
                   const T* __restrict__ carry_v,
                   const uint8_t* __restrict__ carry_f, T* __restrict__ out) {
  __shared__ T sv[kTile];
  __shared__ uint8_t sf[kTile];
  T v[kItems];
  bool f[kItems];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  load_tile<T, OP>(vals, flags, base, n, sv, sf, v, f);
  // the thread's local inclusive scan
  bool af = false;
  T av = identity<T, OP>();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    bool fk = f[k];
    T vk = v[k];
    combine<T, OP>(af, av, fk, vk);
    af = fk;
    av = vk;
    f[k] = af;  // a flag at or before row k within the thread
    v[k] = av;
  }
  bool pf;
  T pv;
  block_exclusive<T, OP>(af, av, pf, pv, nullptr, nullptr);
  // the carry from the tiles before, then the threads before
  bool cf = carry_f[blockIdx.x] != 0;
  T cv = carry_v[blockIdx.x];
  combine<T, OP>(cf, cv, pf, pv);
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    sv[threadIdx.x * kItems + k] =
        finish<T, OP>(f[k] ? v[k] : apply<T, OP>(pv, v[k]));
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (base + j < n) out[base + j] = sv[j];
  }
}

template <typename T, int OP>
int seg_scan_run(const void* vals, const uint8_t* flags, int64_t n,
                 void* scratch, void* out, cudaStream_t s) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  T* tile_v = static_cast<T*>(scratch);
  T* carry_v = tile_v + tiles;
  uint8_t* tile_f = reinterpret_cast<uint8_t*>(carry_v + tiles);
  uint8_t* carry_f = tile_f + tiles;
  const T* v = static_cast<const T*>(vals);
  seg_scan_tiles<T, OP><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      v, flags, n, tile_v, tile_f);
  seg_scan_carries<T, OP><<<1, kThreads, 0, s>>>(tile_v, tile_f, tiles,
                                                 carry_v, carry_f);
  seg_scan_write<T, OP><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      v, flags, n, carry_v, carry_f, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int seg_scan_op(int op, const void* vals, const uint8_t* flags, int64_t n,
                void* scratch, void* out, cudaStream_t s) {
  switch (op) {
    case kAdd: return seg_scan_run<T, kAdd>(vals, flags, n, scratch, out, s);
    case kMin: return seg_scan_run<T, kMin>(vals, flags, n, scratch, out, s);
    case kMax: return seg_scan_run<T, kMax>(vals, flags, n, scratch, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// frame_bounds
// ---------------------------------------------------------------------------
template <typename K>
__global__ void frame_bounds_kernel(const K* __restrict__ key,
                                    const K* __restrict__ target,
                                    const int64_t* __restrict__ lo,
                                    const int64_t* __restrict__ hi,
                                    int64_t* __restrict__ out, int64_t n,
                                    int strict) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int64_t a = lo[i];
    int64_t b = hi[i];
    a = a < 0 ? 0 : (a > n ? n : a);
    b = b < 0 ? 0 : (b > n ? n : b);
    const K t = target[i];
    while (a < b) {
      const int64_t m = a + ((b - a) >> 1);
      const K x = key[m];
      const bool right = strict ? !(t < x) : (x < t);
      if (right)
        a = m + 1;
      else
        b = m;
    }
    out[i] = a;
  }
}

// ---------------------------------------------------------------------------
// frame_reduce
// ---------------------------------------------------------------------------
constexpr int kShort = 64;
constexpr int kL1 = 5, kL2 = 10, kL3 = 15;  // log2 of the block sizes
constexpr int kTableThreads = 1024;           // a block: one 32768-row chunk

struct Levels {
  int64_t n1, n2, n3;
};

__host__ __device__ inline Levels levels_of(int64_t n) {
  return {(n + 31) >> kL1, (n + 1023) >> kL2, (n + 32767) >> kL3};
}

// Warp reduce to lane 0 in a fixed order, then broadcast: every lane gets
// lane 0's bits.
template <typename T, int OP>
__device__ __forceinline__ void warp_reduce(T& v, int& c) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    T ov = __shfl_down_sync(kFull, v, d);
    int oc = __shfl_down_sync(kFull, c, d);
    v = apply<T, OP>(v, ov);
    c += oc;
  }
  v = __shfl_sync(kFull, v, 0);
  c = __shfl_sync(kFull, c, 0);
}

template <typename T, int OP>
__global__ void __launch_bounds__(kTableThreads)
    frame_tables(const T* __restrict__ vals,
                 const uint8_t* __restrict__ valid, int64_t n, T* t1,
                 int* c1, T* t2, int* c2, T* t3, int* c3) {
  __shared__ T s_v[32];
  __shared__ int s_c[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t wbase = (static_cast<int64_t>(blockIdx.x) << kL3) +
                        (static_cast<int64_t>(warp) << kL2);
  const Levels lv = levels_of(n);
  T mine_v = identity<T, OP>();
  int mine_c = 0;
  for (int s = 0; s < 32; ++s) {
    const int64_t i = wbase + (s << kL1) + lane;
    const bool ok = i < n && valid[i] != 0;
    T v = ok ? vals[i] : identity<T, OP>();
    int c = ok ? 1 : 0;
    warp_reduce<T, OP>(v, c);
    if (lane == s) {
      mine_v = v;
      mine_c = c;
    }
  }
  const int64_t j1 = (wbase >> kL1) + lane;
  if (j1 < lv.n1) {
    t1[j1] = mine_v;
    c1[j1] = mine_c;
  }
  warp_reduce<T, OP>(mine_v, mine_c);
  const int64_t j2 = wbase >> kL2;
  if (lane == 0) {
    if (j2 < lv.n2) {
      t2[j2] = mine_v;
      c2[j2] = mine_c;
    }
    s_v[warp] = mine_v;
    s_c[warp] = mine_c;
  }
  __syncthreads();
  if (warp == 0) {
    T v = s_v[lane];
    int c = s_c[lane];
    warp_reduce<T, OP>(v, c);
    if (lane == 0) {
      t3[blockIdx.x] = v;
      c3[blockIdx.x] = c;
    }
  }
}

template <typename T, int OP>
__global__ void frame_reduce_kernel(const T* __restrict__ vals,
                                    const uint8_t* __restrict__ valid,
                                    const int64_t* __restrict__ lo,
                                    const int64_t* __restrict__ hi, int64_t n,
                                    const T* __restrict__ t1,
                                    const int* __restrict__ c1,
                                    const T* __restrict__ t2,
                                    const int* __restrict__ c2,
                                    const T* __restrict__ t3,
                                    const int* __restrict__ c3,
                                    T* __restrict__ out,
                                    int64_t* __restrict__ count) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int64_t a = lo[i];
    int64_t b = hi[i];
    a = a < 0 ? 0 : (a > n ? n : a);
    b = b < 0 ? 0 : (b > n ? n : b);
    T acc = identity<T, OP>();
    int64_t cnt = 0;
    auto row = [&](int64_t j) {
      if (valid[j]) {
        acc = apply<T, OP>(acc, vals[j]);
        ++cnt;
      }
    };
    if (b - a <= kShort) {
      for (int64_t j = a; j < b; ++j) row(j);
    } else {
      constexpr int64_t B1 = 1LL << kL1, B2 = 1LL << kL2, B3 = 1LL << kL3;
      for (; a < b && (a & (B1 - 1)); ++a) row(a);
      for (; a + B1 <= b && (a & (B2 - 1)); a += B1) {
        acc = apply<T, OP>(acc, t1[a >> kL1]);
        cnt += c1[a >> kL1];
      }
      for (; a + B2 <= b && (a & (B3 - 1)); a += B2) {
        acc = apply<T, OP>(acc, t2[a >> kL2]);
        cnt += c2[a >> kL2];
      }
      for (; a + B3 <= b; a += B3) {
        acc = apply<T, OP>(acc, t3[a >> kL3]);
        cnt += c3[a >> kL3];
      }
      for (; a + B2 <= b; a += B2) {
        acc = apply<T, OP>(acc, t2[a >> kL2]);
        cnt += c2[a >> kL2];
      }
      for (; a + B1 <= b; a += B1) {
        acc = apply<T, OP>(acc, t1[a >> kL1]);
        cnt += c1[a >> kL1];
      }
      for (; a < b; ++a) row(a);
    }
    out[i] = finish<T, OP>(acc);
    count[i] = cnt;
  }
}

// scratch layout: t1, t2, t3 (8-byte values), then c1, c2, c3 (int32)
template <typename T, int OP>
int frame_reduce_run(const void* vals, const uint8_t* valid,
                     const int64_t* lo, const int64_t* hi, int64_t n,
                     void* scratch, void* out, int64_t* count,
                     cudaStream_t s) {
  const Levels lv = levels_of(n);
  T* t1 = static_cast<T*>(scratch);
  T* t2 = t1 + lv.n1;
  T* t3 = t2 + lv.n2;
  int* c1 = reinterpret_cast<int*>(t3 + lv.n3);
  int* c2 = c1 + lv.n1;
  int* c3 = c2 + lv.n2;
  const T* v = static_cast<const T*>(vals);
  frame_tables<T, OP><<<static_cast<unsigned>(lv.n3), kTableThreads, 0, s>>>(
      v, valid, n, t1, c1, t2, c2, t3, c3);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  frame_reduce_kernel<T, OP><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(v, valid, lo, hi, n, t1, c1, t2, c2, t3,
                                    c3, static_cast<T*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int frame_reduce_op(int op, const void* vals, const uint8_t* valid,
                    const int64_t* lo, const int64_t* hi, int64_t n,
                    void* scratch, void* out, int64_t* count,
                    cudaStream_t s) {
  switch (op) {
    case kAdd:
      return frame_reduce_run<T, kAdd>(vals, valid, lo, hi, n, scratch, out,
                                       count, s);
    case kMin:
      return frame_reduce_run<T, kMin>(vals, valid, lo, hi, n, scratch, out,
                                       count, s);
    case kMax:
      return frame_reduce_run<T, kMax>(vals, valid, lo, hi, n, scratch, out,
                                       count, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched); n must be > 0. dtype: 0 int32, 1 int64, 2 float32,
// 3 float64; op: 0 add, 1 min, 2 max.

extern "C" int64_t srt_seg_scan_scratch_bytes(int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  return tiles * (2 * 8 + 2);
}

extern "C" int srt_seg_scan(const void* vals, const uint8_t* flags,
                            int64_t n, int dtype, int op, void* scratch,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI32: return seg_scan_op<int>(op, vals, flags, n, scratch, out, s);
    case kI64:
      return seg_scan_op<long long>(op, vals, flags, n, scratch, out, s);
    case kF32: return seg_scan_op<float>(op, vals, flags, n, scratch, out, s);
    case kF64:
      return seg_scan_op<double>(op, vals, flags, n, scratch, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// key and target: int64 (is_float 0) or float64 (1)
extern "C" int srt_frame_bounds(const void* key, const void* target,
                                const int64_t* lo, const int64_t* hi,
                                int64_t* out, int64_t n, int is_float,
                                int strict, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (is_float)
    frame_bounds_kernel<double><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  s>>>(static_cast<const double*>(key),
                                       static_cast<const double*>(target),
                                       lo, hi, out, n, strict);
  else
    frame_bounds_kernel<long long><<<static_cast<unsigned>(blocks), kThreads,
                                     0, s>>>(
        static_cast<const long long*>(key),
        static_cast<const long long*>(target), lo, hi, out, n, strict);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t srt_frame_reduce_scratch_bytes(int64_t n) {
  const Levels lv = levels_of(n);
  return (lv.n1 + lv.n2 + lv.n3) * (8 + 4);
}

// vals: int64 (is_float 0) or float64 (1)
extern "C" int srt_frame_reduce(const void* vals, const uint8_t* valid,
                                const int64_t* lo, const int64_t* hi,
                                int64_t n, int is_float, int op,
                                void* scratch, void* out, int64_t* count,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float)
    return frame_reduce_op<double>(op, vals, valid, lo, hi, n, scratch, out,
                                   count, s);
  return frame_reduce_op<long long>(op, vals, valid, lo, hi, n, scratch, out,
                                    count, s);
}
