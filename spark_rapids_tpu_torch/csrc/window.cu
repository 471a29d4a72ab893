// The window functions' scan, frame-bound search and frame reduction, for
// sm_90a.
//
// Replaces the XLA code of spark_rapids_tpu/exec/window.py:
//   - seg_scan: _segmented_scan :41 (a lax.associative_scan) at every call:
//     the segment starts :88, the dense rank :210, the first row of a peer
//     group :213, the running min/max :498-505; and the running and
//     whole-partition float sums, which the JAX package takes as
//     differences of prefix sums over the whole sorted batch (:296), so
//     that one partition's large value wipes out the next one's sums; in
//     reverse, the reverse associative_scan of jnp.minimum that finds
//     segment ends (_seg_len :239) and peer-group ends (:341);
//   - frame_bounds: _device_bsearch :414, the bounds of a bounded RANGE
//     frame (:368-371);
//   - frame_reduce: _device_range_minmax :431 (a sparse table of log2(n)
//     levels, n * 8 B a level) and the bounded-frame float sums of
//     reduce_frame :300-313.
// Plain versions and wrappers: exec/window_kernels.py.
//
// seg_scan: an inclusive scan of (flag, value) pairs under
// (fa, va) . (fb, vb) = (fa | fb, fb ? vb : op(va, vb)), so it restarts
// where a flag is set; in reverse it runs from the last row to the first
// (row n - 1 - i is row i of the scan). op is add (integers wrap, as int64
// does in torch), min or max; float min and max follow Spark's order (NaN
// above +inf, -0.0 below 0.0), through the bits' order key, and a NaN
// result is the canonical NaN. Identities (0, -0.0 for a float add, the
// type's extremes, NaN for a float min) make an empty prefix a no-op bit
// for bit.
//
// One launch, one pass: each block takes the next tile of kTile = 4096
// rows from a counter (so every tile before it is running or done), reads
// the tile once (values striped through padded shared memory, a thread's
// sixteen flags in one 16-byte load), scans it (a thread its kItems rows,
// the warps their threads' pairs, warp 0 the warps'), publishes the tile's
// pair, finds its carry-in, and writes the tile. One memset a call clears
// the counter and the look-back's slots (16 bytes for each 4096 rows and a
// thirty-first more).
//
// The carry-in comes from aggregates only, never from a tile's published
// prefix, so its float adds are grouped by the tile's index alone and the
// bits are the same every run. Level 0 holds each tile's pair, level l + 1
// one pair for each 32 of level l, published by the tile that completes
// it (the last of its 32 at every level below). A tile's carry-in is the
// fold, from level 0 up to the first flag, of each level's warp scan of the
// pairs before it among its 32. A pair that carries a flag makes every pair
// before it a no-op bit for bit, so a level's warp waits only for its pairs
// from the nearest flagged one on: with segments of tens of rows the
// carry-in is the previous tile's pair. Warp l polls level l, all levels
// at once; a pair's status and value share one 16-byte slot, written and
// read in one access, so no fence stands between them. A tile waits only on
// the pairs of tiles before it, and publishes its own before it waits.
//
// frame_bounds: a thread a row, a binary search of [lo, hi) for the first
// key >= its target (> when strict), the search of _device_bsearch.
//
// frame_reduce: a thread a row, the sum, min or max of the valid values of
// [lo, hi) and their count. Where the caller knows every frame has at most
// kShort rows (a ROWS frame with both ends bounded), one kernel reads the
// frames row by row. Otherwise a frame of at most kShort rows is read row by
// row, and a longer one walks up and down three levels of block aggregates
// (32, 1024 and 32768 rows, one aggregate and one count each, about n / 31
// entries in all): at most 31 rows, then 31 aggregates of each level at
// each end, plus the 32768-row blocks between. One kernel builds the
// levels in one pass, a lane 32 rows (16-byte loads, folded in row order),
// a warp 1024, a block 8192, and the last of the four blocks of a
// 32768-row chunk its aggregate (a counter a chunk, cleared by a memset).
// Each frame and each aggregate is reduced in a fixed order, so the bits
// are the same every run; a float sum adds the frame's own values only, so
// NaN and +-inf propagate as in Spark and no value outside the frame
// enters it.
//
// Bound: memory. seg_scan reads its values and flags once and writes the
// values once; frame_bounds reads its key, target, lo and hi and writes its
// output (each binary search's reads beyond the row's own key hit lines its
// neighbours read); frame_reduce reads each row's value, flag, lo and hi
// and writes the value and the count (a short frame's other rows are its
// neighbours'), plus, when the levels are built, the values and flags once
// more.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
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

// ---------------------------------------------------------------------------
// seg_scan
// ---------------------------------------------------------------------------
// A look-back slot, 16 bytes: x its status (0 not yet published, else
// published, with or without a flag), y its pair's value bits. A slot is
// written and read in one 16-byte access, so its value comes with its
// status: no fence between them. Each poll reads L2 again.
constexpr unsigned long long kNotReady = 0, kReady = 1, kReadyFlagged = 2;
constexpr int kLevels = 8;  // look-back levels: tiles < 32^8

__device__ __forceinline__ ulonglong2 load_slot(const ulonglong2* p) {
  return __ldcv(p);
}

template <typename T>
__device__ __forceinline__ unsigned long long to_bits(T v) {
  if constexpr (sizeof(T) == 8) {
    if constexpr (Arith<T>::kFloat)
      return static_cast<unsigned long long>(__double_as_longlong(v));
    else
      return static_cast<unsigned long long>(v);
  } else {
    if constexpr (Arith<T>::kFloat)
      return __float_as_uint(v);
    else
      return static_cast<unsigned>(v);
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b) {
  if constexpr (sizeof(T) == 8) {
    if constexpr (Arith<T>::kFloat)
      return __longlong_as_double(static_cast<long long>(b));
    else
      return static_cast<T>(b);
  } else {
    if constexpr (Arith<T>::kFloat)
      return __uint_as_float(static_cast<unsigned>(b));
    else
      return static_cast<T>(static_cast<unsigned>(b));
  }
}

template <typename T>
__device__ __forceinline__ void publish(ulonglong2* slots, int64_t slot,
                                       bool f, T v) {
  __stcg(slots + slot,
         make_ulonglong2(f ? kReadyFlagged : kReady, to_bits(v)));
}

// The look-back's slots: level 0 one a tile, level l + 1 one for each 32
// of level l, while a level has 32 or more.
__host__ __device__ inline int64_t scan_slots(int64_t tiles) {
  int64_t total = tiles;
  for (int64_t s = tiles; s >= 32;) {
    s = (s + 31) >> 5;
    total += s;
  }
  return total;
}

// The flags of a thread's kItems rows from row r0 of the scan (none given:
// every flag clear); a forward thread's sixteen flags in one 16-byte load.
template <bool REV>
__device__ __forceinline__ void load_flags(const uint8_t* __restrict__ flags,
                                           int64_t n, int64_t r0,
                                           bool (&f)[kItems]) {
  if (flags == nullptr) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) f[k] = false;
    return;
  }
  if (!REV && kItems == 16 && r0 + 16 <= n &&
      (reinterpret_cast<uintptr_t>(flags + r0) & 15) == 0) {
    const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(flags + r0);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      f[k] = (((k < 8 ? w.x : w.y) >> (8 * (k & 7))) & 0xFF) != 0;
    return;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = r0 + k;
    f[k] = i < n && flags[REV ? n - 1 - i : i] != 0;
  }
}

// One warp, one level: the pair of the j slots at `group` (the slots
// before an index among its 32), a fixed warp tree over the lanes from the
// nearest flagged slot on (the ones before it are no-ops bit for bit, so
// their arrival is not waited for).
template <typename T, int OP>
__device__ void level_prefix(const ulonglong2* group, int j, bool& ef,
                             T& ev) {
  const int lane = threadIdx.x & 31;
  const bool poll = lane < j;
  ulonglong2 w = make_ulonglong2(kNotReady, 0);
  unsigned use;
  for (;;) {
    if (poll && w.x == kNotReady) w = load_slot(group + lane);
    const unsigned ready = __ballot_sync(kFull, !poll || w.x != kNotReady);
    const unsigned flagged = __ballot_sync(kFull, w.x == kReadyFlagged);
    use = flagged ? kFull << (31 - __clz(flagged)) : kFull;
    if ((ready & use) == use) break;
  }
  bool f = false;
  T v = identity<T, OP>();
  if (poll && ((use >> lane) & 1u)) {
    f = w.x == kReadyFlagged;
    v = from_bits<T>(w.y);
  }
  warp_inclusive<T, OP>(f, v);
  const int src = j > 0 ? j - 1 : 0;
  ev = __shfl_sync(kFull, v, src);
  ef = __shfl_sync(kFull, static_cast<int>(f), src) != 0;
  if (j == 0) {
    ev = identity<T, OP>();
    ef = false;
  }
}

// The whole block: publishes the tile's pair (tf, tv), finds each level's
// prefix (warp l the level l, l + kWarps, ...; level 0's warp publishes the
// pair of 32 tiles the tile completes as soon as it has it), then thread 0
// folds the carry-in from level 0 up to the first flag and publishes the
// higher pairs the tile completes. Leaves the carry-in in *cf, *cv.
template <typename T, int OP>
__device__ void look_back(int64_t tile, int64_t tiles, bool tf, T tv,
                          ulonglong2* slots, bool* cf, T* cv) {
  __shared__ T s_ev[kLevels];
  __shared__ bool s_ef[kLevels];
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) publish(slots, tile, tf, tv);
  int64_t off = 0, size = tiles, idx = tile;
  int levels = 0;
  for (; levels < kLevels && idx > 0; ++levels) {
    if (levels % kWarps == warp) {
      const int j = static_cast<int>(idx & 31);
      bool ef;
      T ev;
      level_prefix<T, OP>(slots + off + idx - j, j, ef, ev);
      if ((threadIdx.x & 31) == 0) {
        s_ef[levels] = ef;
        s_ev[levels] = ev;
        if (levels == 0 && j == 31) {
          bool f = tf;
          T v = tv;
          combine<T, OP>(ef, ev, f, v);
          publish(slots, off + size + (idx >> 5), f, v);
        }
      }
    }
    off += size;
    size = (size + 31) >> 5;
    idx >>= 5;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool af = false;
    T av = identity<T, OP>();
    for (int l = 0; l < levels && !af; ++l)
      combine<T, OP>(s_ef[l], s_ev[l], af, av);
    *cf = af;
    *cv = av;
    // the pairs of 32^(l + 1) tiles the tile completes, past level 1
    bool of = tf;
    T ov = tv;
    off = 0;
    size = tiles;
    idx = tile;
    for (int l = 0; (idx & 31) == 31; ++l) {
      combine<T, OP>(s_ef[l], s_ev[l], of, ov);
      if (l > 0) publish(slots, off + size + (idx >> 5), of, ov);
      off += size;
      size = (size + 31) >> 5;
      idx >>= 5;
    }
  }
  __syncthreads();
}

// slots[0].x is the tile counter; slots + 1 the look-back's slots. Three
// blocks an SM (80 registers a thread): 16 rows a thread and 4096 a tile
// keep more bytes in flight than 8 rows at four blocks.
template <typename T, int OP, bool REV>
__global__ void __launch_bounds__(kThreads, 3)
    seg_scan_kernel(const T* __restrict__ vals,
                    const uint8_t* __restrict__ flags, int64_t n,
                    int64_t tiles, ulonglong2* slots, T* __restrict__ out) {
  // one pad a 128-byte row of banks: a thread's kItems rows and a warp's
  // striped rows both fall on distinct banks
  constexpr int kShift = sizeof(T) == 8 ? 4 : 5;
  __shared__ T sv[kTile + (kTile >> kShift)];
  __shared__ unsigned s_tile;
  __shared__ T s_cv;
  __shared__ bool s_cf;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(slots), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTile;
  // rows past n: identities without a flag, no-ops bit for bit
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const int64_t i = base + j;
    sv[j + (j >> kShift)] =
        i < n ? vals[REV ? n - 1 - i : i] : identity<T, OP>();
  }
  bool f[kItems];
  load_flags<REV>(flags, n, base + threadIdx.x * kItems, f);
  __syncthreads();
  T v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    v[k] = sv[j + (j >> kShift)];
  }
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
  bool pf, tf;
  T pv, tv;
  block_exclusive<T, OP>(af, av, pf, pv, &tf, &tv);
  look_back<T, OP>(tile, tiles, tf, tv, slots + 1, &s_cf, &s_cv);
  // the carry from the tiles before, then the threads before
  bool cf = s_cf;
  T cv = s_cv;
  combine<T, OP>(cf, cv, pf, pv);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    sv[j + (j >> kShift)] =
        finish<T, OP>(f[k] ? v[k] : apply<T, OP>(pv, v[k]));
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const int64_t i = base + j;
    if (i < n) out[REV ? n - 1 - i : i] = sv[j + (j >> kShift)];
  }
}

// scratch: the counter's slot, then the look-back's, which one memset
// clears
template <typename T, int OP, bool REV>
int seg_scan_run(const void* vals, const uint8_t* flags, int64_t n,
                 void* scratch, void* out, cudaStream_t s) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t bytes = (scan_slots(tiles) + 1) * sizeof(ulonglong2);
  const int rc = static_cast<int>(cudaMemsetAsync(scratch, 0, bytes, s));
  if (rc != 0) return rc;
  seg_scan_kernel<T, OP, REV><<<static_cast<unsigned>(tiles), kThreads, 0,
                                s>>>(static_cast<const T*>(vals), flags, n,
                                     tiles, static_cast<ulonglong2*>(scratch),
                                     static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool REV>
int seg_scan_op(int op, const void* vals, const uint8_t* flags, int64_t n,
                void* scratch, void* out, cudaStream_t s) {
  switch (op) {
    case kAdd:
      return seg_scan_run<T, kAdd, REV>(vals, flags, n, scratch, out, s);
    case kMin:
      return seg_scan_run<T, kMin, REV>(vals, flags, n, scratch, out, s);
    case kMax:
      return seg_scan_run<T, kMax, REV>(vals, flags, n, scratch, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int seg_scan_dir(int op, int reverse, const void* vals, const uint8_t* flags,
                 int64_t n, void* scratch, void* out, cudaStream_t s) {
  if (reverse) return seg_scan_op<T, true>(op, vals, flags, n, scratch, out, s);
  return seg_scan_op<T, false>(op, vals, flags, n, scratch, out, s);
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
constexpr int kTableThreads = 256;           // a lane 32 rows, a block 8192
constexpr unsigned kChunkBlocks = (1u << kL3) / (kTableThreads << kL1);

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

// an 8-byte value from its two 32-bit halves
template <typename T>
__device__ __forceinline__ T from_words(unsigned lo, unsigned hi) {
  const long long b = static_cast<long long>(
      (static_cast<unsigned long long>(hi) << 32) | lo);
  if constexpr (Arith<T>::kFloat)
    return __longlong_as_double(b);
  else
    return b;
}

// The levels in one pass: a lane folds its 32 rows in order (sixteen
// 16-byte loads of values, two of flags, all issued first), a warp its
// lanes' (1024 rows), and the last of a 32768-row chunk's four blocks the
// chunk's 32 warps'. done: a counter a chunk, zeroed.
template <typename T, int OP>
__global__ void __launch_bounds__(kTableThreads)
    frame_tables(const T* __restrict__ vals,
                 const uint8_t* __restrict__ valid, int64_t n, T* t1,
                 int* c1, T* t2, int* c2, T* t3, int* c3, unsigned* done) {
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kTableThreads + threadIdx.x)
      << kL1;
  const Levels lv = levels_of(n);
  T acc = identity<T, OP>();
  int cnt = 0;
  if (r0 + 32 <= n && (reinterpret_cast<uintptr_t>(vals + r0) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(valid + r0) & 15) == 0) {
    const uint4* vp = reinterpret_cast<const uint4*>(valid + r0);
    const uint4* xp = reinterpret_cast<const uint4*>(vals + r0);
    const uint4 m0 = vp[0], m1 = vp[1];
    uint4 x[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) x[q] = xp[q];
    const unsigned m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const T a = from_words<T>(x[q].x, x[q].y);
      const T b = from_words<T>(x[q].z, x[q].w);
      const unsigned word = m[q >> 1];
      if ((word >> (16 * (q & 1))) & 0xFF) {
        acc = apply<T, OP>(acc, a);
        ++cnt;
      }
      if ((word >> (16 * (q & 1) + 8)) & 0xFF) {
        acc = apply<T, OP>(acc, b);
        ++cnt;
      }
    }
  } else {
    for (int r = 0; r < 32; ++r) {
      const int64_t i = r0 + r;
      if (i < n && valid[i]) {
        acc = apply<T, OP>(acc, vals[i]);
        ++cnt;
      }
    }
  }
  const int64_t j1 = r0 >> kL1;
  if (j1 < lv.n1) {
    t1[j1] = acc;
    c1[j1] = cnt;
  }
  warp_reduce<T, OP>(acc, cnt);
  const int64_t j2 = r0 >> kL2;
  if (lane == 0 && j2 < lv.n2) {
    t2[j2] = acc;
    c2[j2] = cnt;
    __threadfence();  // the warp's aggregate before the chunk's counter
  }
  __syncthreads();
  const unsigned chunk = blockIdx.x / kChunkBlocks;
  if (threadIdx.x == 0) {
    const unsigned left = gridDim.x - chunk * kChunkBlocks;
    const unsigned blocks = left < kChunkBlocks ? left : kChunkBlocks;
    s_last = atomicAdd(done + chunk, 1u) == blocks - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x < 32) {
    __threadfence();
    const int64_t k2 = (static_cast<int64_t>(chunk) << (kL3 - kL2)) + lane;
    T v = k2 < lv.n2 ? __ldcg(t2 + k2) : identity<T, OP>();
    int c = k2 < lv.n2 ? __ldcg(c2 + k2) : 0;
    warp_reduce<T, OP>(v, c);
    if (lane == 0) {
      t3[chunk] = v;
      c3[chunk] = c;
    }
  }
}

// kTables false: every frame read row by row, the levels not read
template <typename T, int OP, bool kTables>
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
    if (!kTables || b - a <= kShort) {
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

// Whether frames of at most max_len rows (< 0: not known) need the levels.
inline bool needs_tables(int64_t max_len) {
  return max_len < 0 || max_len > kShort;
}

// scratch layout: t1, t2, t3 (8-byte values), then c1, c2, c3 (int32),
// then the chunks' counters, which one memset clears
template <typename T, int OP, bool kTables>
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
  if (kTables) {
    unsigned* done = reinterpret_cast<unsigned*>(c3 + lv.n3);
    const int rc = static_cast<int>(
        cudaMemsetAsync(done, 0, lv.n3 * sizeof(unsigned), s));
    if (rc != 0) return rc;
    const int64_t blocks = (n + (kTableThreads << kL1) - 1) /
                           (kTableThreads << kL1);
    frame_tables<T, OP><<<static_cast<unsigned>(blocks), kTableThreads, 0,
                          s>>>(v, valid, n, t1, c1, t2, c2, t3, c3, done);
  }
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  frame_reduce_kernel<T, OP, kTables><<<static_cast<unsigned>(blocks),
                                        kThreads, 0, s>>>(
      v, valid, lo, hi, n, t1, c1, t2, c2, t3, c3, static_cast<T*>(out),
      count);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTables>
int frame_reduce_op(int op, const void* vals, const uint8_t* valid,
                    const int64_t* lo, const int64_t* hi, int64_t n,
                    void* scratch, void* out, int64_t* count,
                    cudaStream_t s) {
  switch (op) {
    case kAdd:
      return frame_reduce_run<T, kAdd, kTables>(vals, valid, lo, hi, n,
                                                scratch, out, count, s);
    case kMin:
      return frame_reduce_run<T, kMin, kTables>(vals, valid, lo, hi, n,
                                                scratch, out, count, s);
    case kMax:
      return frame_reduce_run<T, kMax, kTables>(vals, valid, lo, hi, n,
                                                scratch, out, count, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int frame_reduce_dtype(int op, int64_t max_len, const void* vals,
                       const uint8_t* valid, const int64_t* lo,
                       const int64_t* hi, int64_t n, void* scratch, void* out,
                       int64_t* count, cudaStream_t s) {
  if (needs_tables(max_len))
    return frame_reduce_op<T, true>(op, vals, valid, lo, hi, n, scratch, out,
                                    count, s);
  return frame_reduce_op<T, false>(op, vals, valid, lo, hi, n, scratch, out,
                                   count, s);
}

}  // namespace

// Each entry point launches on `stream` and returns the first CUDA error
// (0 = launched); n must be > 0. dtype: 0 int32, 1 int64, 2 float32,
// 3 float64; op: 0 add, 1 min, 2 max.

extern "C" int64_t srt_seg_scan_scratch_bytes(int64_t n) {
  return (scan_slots((n + kTile - 1) / kTile) + 1) * 16;
}

// flags: nullptr for one segment over the batch; reverse: scan from the
// last row to the first. One memset and one kernel.
extern "C" int srt_seg_scan(const void* vals, const uint8_t* flags,
                            int64_t n, int dtype, int op, int reverse,
                            void* scratch, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI32:
      return seg_scan_dir<int>(op, reverse, vals, flags, n, scratch, out, s);
    case kI64:
      return seg_scan_dir<long long>(op, reverse, vals, flags, n, scratch,
                                     out, s);
    case kF32:
      return seg_scan_dir<float>(op, reverse, vals, flags, n, scratch, out,
                                 s);
    case kF64:
      return seg_scan_dir<double>(op, reverse, vals, flags, n, scratch, out,
                                  s);
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

// 0 where frames of at most max_len rows (< 0: not known) skip the levels
extern "C" int64_t srt_frame_reduce_scratch_bytes(int64_t n,
                                                  int64_t max_len) {
  if (!needs_tables(max_len)) return 0;
  const Levels lv = levels_of(n);
  return (lv.n1 + lv.n2 + lv.n3) * (8 + 4) + lv.n3 * 4;
}

// vals: int64 (is_float 0) or float64 (1); max_len: the longest frame where
// the caller knows it, else -1. At most kShort: one kernel, every frame row
// by row (a longer frame too, only slower); else a memset, the levels'
// kernel and the frames' kernel.
extern "C" int srt_frame_reduce(const void* vals, const uint8_t* valid,
                                const int64_t* lo, const int64_t* hi,
                                int64_t n, int is_float, int op,
                                int64_t max_len, void* scratch, void* out,
                                int64_t* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float)
    return frame_reduce_dtype<double>(op, max_len, vals, valid, lo, hi, n,
                                      scratch, out, count, s);
  return frame_reduce_dtype<long long>(op, max_len, vals, valid, lo, hi, n,
                                       scratch, out, count, s);
}
