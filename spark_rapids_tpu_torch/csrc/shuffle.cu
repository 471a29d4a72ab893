// The shuffle write's two device steps, for sm_90a: the partition id of
// every row, and the stable order that groups the rows by that id.
//
// Neither replaces a Pallas kernel: the JAX package computes both as XLA
// code. partition_ids is spark_rapids_tpu/shuffle/manager.py:136
// device_partition_ids (with _column_key_hash :152, _string_key_hash :111
// and _fmix_device :101); counting_order is spark_rapids_tpu/columnar/
// device.py:219 stable_counting_order, reached through manager.py:87
// _partition_order and the order/start/k of shuffle/ici.py:124-134. The
// port's torch versions of both (shuffle/manager.py) are the plain versions
// the kernels are held against, bit for bit.
//
// partition_ids: one thread a row folds every key column's Murmur-style
// hash into h = (h ^ k) * 5 + 0xE6546B64 from the seed, in key order, and
// writes h % num_parts (a masked-off row gets num_parts, past the end).
// Bound: bytes. Each row reads its key planes once and writes 4 bytes; a
// string key reads its matrix row a byte at a time (the simple first
// version). The descriptors of up to kMaxKeys key columns ride in the
// kernel's parameters. With `normalize`, a float key hashes -0.0 as 0.0 and
// every NaN as one NaN, so equal SQL values meet on one shard; without it
// the float's bits hash as they are, as in the JAX package.
//
// counting_order: a counting sort of int32 ids in [0, nv), stable. It
// returns the permutation and each id's count, so a caller reads the counts
// and never the ids. Bound: bytes (the ids read twice by the kernel, once by
// the bound; the order written once).
//
// Up to kOnePassBins ids and below 2^30 rows (every id count of the main
// path: a mesh's shards + 1, the grace split's 65 at most, the executor
// tier's shuffle.partitions + 1), one memset of the counts and two launches
// over tiles of kCoTile rows:
//  1. co_tile_counts, a block a tile: counts the tile's ids in shared
//     memory (16-byte loads, all in flight before the first is counted),
//     writes each (id, tile) count as the look-back's word of that pair
//     (an aggregate; tile 0's inclusive), and adds its counts into
//     `counts` (one global atomic an id a tile).
//  2. co_rank_scatter, a block a tile: loads its ids and `counts`; loads
//     the first round of a decoupled look-back over the (id, tile) words
//     (a group of lanes an id, many words at once); ranks its rows stably
//     while those loads are in flight (a warp's 32 rows a step, in row
//     order, grouped by __match_any_sync up to 16 ids, else one ballot a
//     bit of the id, with warp-private counters in shared memory); sums
//     the look-back (further rounds until an inclusive word turns up) and
//     turns its own word inclusive; takes each id's prefix across the
//     warps, and one scan of (count, rows in the tile) pairs over the ids
//     gives each id's offset and its first slot in the tile; stages its
//     row numbers in shared memory in id order; and writes each id's run
//     of `order` with coalesced stores.
// Every aggregate is written by the first launch, before any tile looks
// back, so a look-back never waits: at 2^20 rows every tile is in flight at
// once, and tiles that each published their own aggregate would walk back
// one word a round trip behind one another. Nothing waiting, a tile needs
// no place in a queue: blockIdx is its number, and no counter's round trip
// delays its loads. A word holds its status in its top two bits and a
// count of rows below 2^30 in the rest. It is its own message, so it is
// read and written relaxed: an acquire would keep the window's other loads
// from starting until it returned, and a release would wait for the tile's
// id loads. The words lie id-major where a group of lanes reads one id's
// run of tiles (8 lanes or more: the run is contiguous), else tile-major
// (the groups of a warp read neighbouring ids of one tile).
//
// Past kOnePassBins ids or 2^30 rows, the first design's four launches:
// per-tile histograms (shared-memory atomics), an exclusive scan over (id,
// tile) in that order (one block an id), an exclusive scan over the ids'
// totals (one block), and a stable scatter in which one warp walks its tile
// in 32-row steps and ranks equal ids with __match_any_sync. Its histogram
// is nv x tiles ints, which the tile size keeps below the ids' own bytes
// for nv up to a few hundred.
#include <cstdint>
#include <cuda_runtime.h>

// One key column, as the wrapper describes it (ctypes mirrors this layout).
// Outside the anonymous namespace: the extern "C" entry takes it, and a
// type of internal linkage would make that entry internal too.
struct SrtKeyDesc {
  int32_t kind;
  int32_t width;
  const void* data;
  const uint8_t* valid;
  const int32_t* lengths;
};

namespace {

using KeyDesc = SrtKeyDesc;

constexpr int kMaxKeys = 16;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
// counting order: at most this many ids; the one-pass path's ids, rows,
// warps a block, rows a thread and look-back words a lane reads at once
constexpr int kMaxBins = 8192;
constexpr int kOnePassBins = 1024;
constexpr int64_t kOnePassRows = int64_t(1) << 30;
constexpr int kCoWarps = 16;
constexpr int kCoItems = 8;
constexpr int kCoThreads = 32 * kCoWarps;
constexpr int kCoTile = kCoThreads * kCoItems;
constexpr int kCoWindow = 4;
// the counting pass: 8 warps a tile, 16 rows a thread in 16-byte loads
constexpr int kCountWarps = 8;
constexpr int kCountThreads = 32 * kCountWarps;
constexpr int kCountItems = kCoTile / kCountThreads;
static_assert(kCountItems % 4 == 0, "a thread's rows: whole 16-byte loads");
constexpr int kMatchBins = 16;   // ids up to which __match_any_sync ranks
constexpr int kCountChunks = (kOnePassBins + kCoThreads - 1) / kCoThreads;
static_assert(kCoTile <= 65536, "a staged row's place in its tile: 16 bits");
static_assert(kOnePassBins < 32768, "a staged row's id: 15 bits");
// a look-back word: status in the top two bits, a count below 2^30
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;
constexpr uint32_t kCountMask = kAggregate - 1u;
// the first design's tiles: at most this many, rows a tile at least
constexpr int64_t kMaxTiles = 4096;
constexpr int64_t kMinTile = 2048;
constexpr int kScanThreads = 1024;

enum KeyKind : int32_t {
  kInt8 = 0,
  kInt16 = 1,
  kInt32 = 2,
  kInt64 = 3,
  kBool = 4,
  kFloat32 = 5,
  kFloat64 = 6,
  kDecimal128 = 7,  // (n, 2) int64 limbs, high limb first
  kString = 8,      // (n, width) uint8 matrix + int32 lengths
};

struct KeySet {
  KeyDesc k[kMaxKeys];
  int32_t n;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t fold64(uint64_t b) {
  return static_cast<uint32_t>(b) ^ static_cast<uint32_t>(b >> 32);
}

// The bits of a float widened to double as the host's conversion gives
// them: a NaN keeps its sign and payload with the quiet bit set.
__device__ __forceinline__ uint64_t f32_bits(float f, bool normalize) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7F800000u) == 0x7F800000u && (u & 0x007FFFFFu)) {
    if (normalize) return 0x7FF8000000000000ull;
    return (static_cast<uint64_t>(u >> 31) << 63) | 0x7FF8000000000000ull |
           (static_cast<uint64_t>(u & 0x007FFFFFu) << 29);
  }
  if (normalize && f == 0.0f) return 0;
  return static_cast<uint64_t>(__double_as_longlong(static_cast<double>(f)));
}

__device__ __forceinline__ uint64_t f64_bits(double d, bool normalize) {
  const uint64_t u = static_cast<uint64_t>(__double_as_longlong(d));
  if (normalize) {
    if (d != d) return 0x7FF8000000000000ull;
    if (d == 0.0) return 0;
  }
  return u;
}

// _string_key_hash: each 8-byte word (big-endian, zero padded past the
// matrix) that the length reaches into, mixed with its word number; then the
// length's own mix.
__device__ uint32_t string_hash(const uint8_t* row, int32_t width,
                                int32_t len) {
  uint32_t k = 0;
  const int32_t words = (width + 7) / 8;
  for (int32_t i = 0; i < words; ++i) {
    const int32_t start = 8 * i;
    if (len <= start) break;
    uint64_t w = 0;
    for (int32_t j = 0; j < 8; ++j) {
      const int32_t c = start + j;
      w = (w << 8) | (c < width ? row[c] : 0u);
    }
    k ^= fmix32(fold64(w) ^ static_cast<uint32_t>(start + 1));
  }
  return k ^ fmix32(static_cast<uint32_t>(len));
}

// _column_key_hash of row i: 0 for a null, else the finaliser of the
// column's 32-bit fold.
__device__ uint32_t key_hash(const KeyDesc& d, int64_t i, bool normalize) {
  if (!d.valid[i]) return 0;
  uint32_t k = 0;
  switch (d.kind) {
    case kInt8:
      k = fold64(static_cast<uint64_t>(
          static_cast<int64_t>(static_cast<const int8_t*>(d.data)[i])));
      break;
    case kInt16:
      k = fold64(static_cast<uint64_t>(
          static_cast<int64_t>(static_cast<const int16_t*>(d.data)[i])));
      break;
    case kInt32:
      k = fold64(static_cast<uint64_t>(
          static_cast<int64_t>(static_cast<const int32_t*>(d.data)[i])));
      break;
    case kInt64:
      k = fold64(static_cast<uint64_t>(static_cast<const int64_t*>(d.data)[i]));
      break;
    case kBool:
      k = static_cast<const uint8_t*>(d.data)[i] ? 1u : 0u;
      break;
    case kFloat32:
      k = fold64(f32_bits(static_cast<const float*>(d.data)[i], normalize));
      break;
    case kFloat64:
      k = fold64(f64_bits(static_cast<const double*>(d.data)[i], normalize));
      break;
    case kDecimal128: {
      const int64_t* p = static_cast<const int64_t*>(d.data) + 2 * i;
      const uint64_t hi = static_cast<uint64_t>(p[0]);
      const uint64_t lo = static_cast<uint64_t>(p[1]);
      k = fold64(hi ^ (lo * 0x9E3779B97F4A7C15ull));
      break;
    }
    case kString:
      k = string_hash(static_cast<const uint8_t*>(d.data) + i * d.width,
                      d.width, d.lengths[i]);
      break;
    default:
      break;
  }
  return fmix32(k);
}

__global__ void partition_ids_kernel(const KeySet keys, int64_t n,
                                     uint32_t seed, int32_t num_parts,
                                     int32_t normalize,
                                     const uint8_t* __restrict__ row_mask,
                                     int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (row_mask != nullptr && !row_mask[i]) {
      out[i] = num_parts;
      continue;
    }
    uint32_t h = seed;
    for (int32_t j = 0; j < keys.n; ++j) {
      h = (h ^ key_hash(keys.k[j], i, normalize != 0)) * 5u + 0xE6546B64u;
    }
    out[i] = static_cast<int32_t>(h % static_cast<uint32_t>(num_parts));
  }
}

__device__ __forceinline__ int32_t clamp_id(int32_t id, int32_t nv) {
  return id < 0 ? 0 : (id >= nv ? nv - 1 : id);
}

// Inclusive scan of one value a thread over the block (blockDim a multiple
// of 32); `total` gets the block's sum. Every thread must call it.
template <typename T>
__device__ T block_inclusive_scan(T x, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T v = x;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T s = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  const T out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[nw - 1];
  __syncthreads();
  return out;
}

// ---- the first design's four launches (past kOnePassBins ids or 2^30
// rows) -------------------------------------------------------------

// 1. hist[v * n_tiles + t] = rows of tile t with id v.
__global__ void co_histogram(const int32_t* __restrict__ ids, int64_t n,
                             int64_t tile, int32_t nv, int32_t n_tiles,
                             int32_t* __restrict__ hist) {
  extern __shared__ int32_t bins[];
  for (int32_t v = threadIdx.x; v < nv; v += blockDim.x) bins[v] = 0;
  __syncthreads();
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t hi = lo + tile < n ? lo + tile : n;
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    atomicAdd(&bins[clamp_id(ids[i], nv)], 1);
  }
  __syncthreads();
  for (int32_t v = threadIdx.x; v < nv; v += blockDim.x) {
    hist[static_cast<int64_t>(v) * n_tiles + blockIdx.x] = bins[v];
  }
}

// 2. Block v: exclusive scan of id v's row of hist over the tiles, in
//    place; counts[v] = the row's total.
__global__ void co_scan_tiles(int32_t* __restrict__ hist, int32_t n_tiles,
                              int32_t* __restrict__ counts) {
  __shared__ int32_t warp_sums[32];
  int32_t* row = hist + static_cast<int64_t>(blockIdx.x) * n_tiles;
  int32_t carry = 0;
  for (int32_t base = 0; base < n_tiles; base += blockDim.x) {
    const int32_t t = base + threadIdx.x;
    const int32_t x = t < n_tiles ? row[t] : 0;
    int32_t total;
    const int32_t incl = block_inclusive_scan(x, warp_sums, &total);
    if (t < n_tiles) row[t] = carry + incl - x;
    carry += total;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

// 3. One block: idoff[v] = rows of every id below v.
__global__ void co_scan_ids(const int32_t* __restrict__ counts, int32_t nv,
                            int32_t* __restrict__ idoff) {
  __shared__ int32_t warp_sums[32];
  int32_t carry = 0;
  for (int32_t base = 0; base < nv; base += blockDim.x) {
    const int32_t v = base + threadIdx.x;
    const int32_t x = v < nv ? counts[v] : 0;
    int32_t total;
    const int32_t incl = block_inclusive_scan(x, warp_sums, &total);
    if (v < nv) idoff[v] = carry + incl - x;
    carry += total;
  }
}

// 4. One warp a tile: walk it in 32-row steps; the rows of one id in a step
//    take consecutive slots in row order after the id's running base.
__global__ void co_scatter(const int32_t* __restrict__ ids, int64_t n,
                           int64_t tile, int32_t nv, int32_t n_tiles,
                           const int32_t* __restrict__ hist,
                           const int32_t* __restrict__ idoff,
                           int32_t* __restrict__ order) {
  extern __shared__ int32_t base[];
  const int lane = threadIdx.x;
  for (int32_t v = lane; v < nv; v += 32) {
    base[v] = idoff[v] + hist[static_cast<int64_t>(v) * n_tiles + blockIdx.x];
  }
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t hi = lo + tile < n ? lo + tile : n;
  for (int64_t s = lo; s < hi; s += 32) {
    const int64_t i = s + lane;
    const bool ok = i < hi;
    const int32_t id = ok ? clamp_id(ids[i], nv) : -1;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, id);
    if (ok) order[base[id] + __popc(peers & lower)] = static_cast<int32_t>(i);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) base[id] += __popc(peers);
    __syncwarp();
  }
}

int64_t tile_rows(int64_t n) {
  int64_t tile = (n + kMaxTiles - 1) / kMaxTiles;
  tile = (tile + 31) / 32 * 32;
  return tile < kMinTile ? kMinTile : tile;
}

// ---- the one-pass path -------------------------------------------------

// The lanes of the warp whose label equals this lane's, for labels 0..nv
// below 2^bits: __match_any_sync up to kMatchBins ids (it costs a step a
// distinct label), else one ballot a bit (CUB's MatchAny); every lane
// takes part.
__device__ __forceinline__ unsigned peers_of(int32_t label, int32_t nv,
                                             int bits) {
  if (nv <= kMatchBins) return __match_any_sync(kFull, label);
  unsigned m = kFull;
  for (int b = 0; b < bits; ++b) {
    const bool set = (label >> b) & 1;
    const unsigned vote = __ballot_sync(kFull, set);
    m &= set ? vote : ~vote;
  }
  return m;
}

// A look-back word, read and written relaxed: it is its own message.
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
  uint32_t w;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void publish_word(uint32_t* p, uint32_t w) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(w) : "memory");
}

// The lanes of a look-back group: the most, up to 32, that give each of
// the nv ids of a round a group of the block.
__device__ __forceinline__ int look_back_lanes(int32_t nv) {
  int lanes = 32;
  while (lanes > 1 && kCoThreads / lanes < nv) lanes >>= 1;
  return lanes;
}

// Word (v, t) of the look-back: id-major where a group of 8 lanes or more
// reads id v's tiles, else tile-major.
struct WordLayout {
  int64_t id_stride, tile_stride;
  __device__ WordLayout(int32_t nv, int32_t tiles)
      : id_stride(look_back_lanes(nv) >= 8 ? tiles : 1),
        tile_stride(look_back_lanes(nv) >= 8 ? 1 : nv) {}
};

// A thread's rows of the tile, warp-striped: a warp's 32 * kCoItems rows,
// 32 consecutive rows a step. Rows past n get the label nv.
__device__ __forceinline__ void load_tile_ids(const int32_t* __restrict__ ids,
                                              int64_t n, int32_t nv,
                                              int64_t tile, int local0,
                                              int32_t (&id)[kCoItems]) {
#pragma unroll
  for (int k = 0; k < kCoItems; ++k) {
    const int64_t i = tile * kCoTile + local0 + 32 * k;
    id[k] = i < n ? clamp_id(ids[i], nv) : nv;
  }
}

// 1. Block t: tile t's count of each id v (shared-memory atomics) into
//    word (v, t) of the look-back, an aggregate (tile 0's inclusive: no
//    tile is before it), and into counts[v]. Its rows come in 16-byte
//    loads, all issued before the first is counted.
__global__ void __launch_bounds__(kCountThreads)
    co_tile_counts(const int32_t* __restrict__ ids, int64_t n, int32_t nv,
                   int32_t tiles, uint32_t* __restrict__ words,
                   int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  for (int32_t v = threadIdx.x; v < nv; v += kCountThreads) hist[v] = 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  int32_t id[kCountItems];
#pragma unroll
  for (int k = 0; k < kCountItems / 4; ++k) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kCoTile +
                      4 * (threadIdx.x + k * kCountThreads);
    if (aligned && i + 3 < n) {
      const int4 q = *reinterpret_cast<const int4*>(ids + i);
      id[4 * k] = clamp_id(q.x, nv);
      id[4 * k + 1] = clamp_id(q.y, nv);
      id[4 * k + 2] = clamp_id(q.z, nv);
      id[4 * k + 3] = clamp_id(q.w, nv);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        id[4 * k + j] = i + j < n ? clamp_id(ids[i + j], nv) : nv;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCountItems; ++k) {
    if (id[k] < nv) atomicAdd(&hist[id[k]], 1);
  }
  __syncthreads();
  const uint32_t status = blockIdx.x == 0 ? kInclusive : kAggregate;
  const WordLayout at(nv, tiles);
  for (int32_t v = threadIdx.x; v < nv; v += kCountThreads) {
    const int32_t c = hist[v];
    words[v * at.id_stride + blockIdx.x * at.tile_stride] =
        status | static_cast<uint32_t>(c);
    if (c) atomicAdd(&counts[v], c);
  }
}

// Each id v's rows in the tiles before `tile` (> 0): the words (v, tile -
// 1), (v, tile - 2), ... summed up to and including the first inclusive
// one, into delta[v]; then word (v, tile) becomes inclusive. A group of
// look_back_lanes(nv) lanes takes an id, each lane kCoWindow words a
// round, so a round has lanes * kCoWindow words in flight, and the tile's
// own word with them. begin() takes the ids v0 + threadIdx.x / lanes and
// loads their first round; finish() sums it (and loads further rounds
// until an inclusive word turns up), then publishes. The tile's rank runs
// between the two while the loads are in flight. Every lane of the block
// must call both.
struct LookBack {
  uint32_t* words;
  WordLayout at;
  int64_t tile;
  int L, q, first;
  unsigned group_lanes;
  int32_t v;
  bool done;
  uint32_t own, sum;
  int64_t nearest;  // the nearest word not yet summed
  uint32_t w[kCoWindow];

  __device__ LookBack(uint32_t* words_, int64_t tile_, int32_t tiles,
                      int32_t nv)
      : words(words_), at(nv, tiles), tile(tile_), L(look_back_lanes(nv)) {
    const int lane = threadIdx.x & 31;
    q = lane & (L - 1);
    first = lane - q;  // the group's first lane
    group_lanes = (L == 32 ? kFull : (1u << L) - 1u) << first;
  }

  __device__ uint32_t* row() const { return words + v * at.id_stride; }

  // word nearest - q - L * k in w[k]: by distance, round k, then lane
  __device__ void load_round() {
#pragma unroll
    for (int k = 0; k < kCoWindow; ++k) {
      const int64_t j = nearest - q - static_cast<int64_t>(L) * k;
      w[k] = !done && j >= 0 ? load_word(row() + j * at.tile_stride)
                             : kInclusive;
    }
  }

  __device__ void begin(int32_t v0, int32_t nv) {
    v = v0 + static_cast<int32_t>(threadIdx.x) / L;
    done = v >= nv;
    if (done) v = 0;
    own = !done && q == 0 ? load_word(row() + tile * at.tile_stride) : 0u;
    sum = 0;
    nearest = tile - 1;
    load_round();
  }

  __device__ void finish(int32_t* delta) {
    const bool active = !done;
    for (;;) {
      int kfirst = kCoWindow;
      unsigned hit = 0;
#pragma unroll
      for (int k = 0; k < kCoWindow; ++k) {
        const unsigned b =
            __ballot_sync(kFull, (w[k] & kInclusive) != 0u) & group_lanes;
        if (kfirst == kCoWindow && b) {
          kfirst = k;
          hit = b;
        }
      }
      const int qfirst = hit ? __ffs(hit) - 1 - first : L;
      uint32_t s = 0;
#pragma unroll
      for (int k = 0; k < kCoWindow; ++k)
        if (k < kfirst || (k == kfirst && q <= qfirst)) s += w[k] & kCountMask;
      for (int o = 1; o < L; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
      if (!done) {
        sum += s;
        done = kfirst < kCoWindow;
        nearest -= static_cast<int64_t>(L) * kCoWindow;
      }
      if (!__any_sync(kFull, !done)) break;
      load_round();
    }
    if (active && q == 0) {
      publish_word(row() + tile * at.tile_stride,
                   kInclusive | (sum + (own & kCountMask)));
      delta[v] = static_cast<int32_t>(sum);
    }
  }
};

// 2. Block t: each row's place in `order` is its id's offset, plus the
//    id's rows in the tiles before (the look-back, first, so that the tile
//    publishes early), plus its rank among the id's rows of tile t. Shared
//    memory: the staged rows (kCoTile), delta and first (nv each), the
//    warps' counters (kCoWarps x nv).
__global__ void __launch_bounds__(kCoThreads, 2)
    co_rank_scatter(const int32_t* __restrict__ ids, int64_t n, int32_t nv,
                    int32_t tiles, const int32_t* __restrict__ counts,
                    uint32_t* __restrict__ words,
                    int32_t* __restrict__ order) {
  extern __shared__ int32_t smem[];
  int32_t* stage = smem;              // (id << 16) | row in the tile, by slot
  int32_t* delta = stage + kCoTile;   // an id's place in order, less its slot
  int32_t* first = delta + nv;        // an id's first slot in the tile
  int32_t* warp_bins = first + nv;    // a warp's rows of each id
  const int64_t tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int local0 = warp * (32 * kCoItems) + lane;
  // loads in flight through the look-back: the ids, and the counts of ids
  // threadIdx.x, + kCoThreads, ...
  int32_t id[kCoItems];
  load_tile_ids(ids, n, nv, tile, local0, id);
  int32_t c[kCountChunks];
#pragma unroll
  for (int k = 0; k < kCountChunks; ++k) {
    const int32_t v = threadIdx.x + k * kCoThreads;
    c[k] = v < nv ? counts[v] : 0;
  }
  for (int32_t v = threadIdx.x; v < nv; v += kCoThreads) delta[v] = 0;
  for (int32_t i = threadIdx.x; i < kCoWarps * nv; i += kCoThreads)
    warp_bins[i] = 0;
  __syncthreads();
  LookBack back(words, tile, tiles, nv);
  if (tile > 0) back.begin(0, nv);
  // a warp's rows, 32 a step in row order: the rank among the warp's rows
  // of the id so far
  const int bits = 32 - __clz(nv);
  const unsigned lower = (1u << lane) - 1u;
  int32_t* mine = warp_bins + warp * nv;
  int32_t rank[kCoItems];
#pragma unroll
  for (int k = 0; k < kCoItems; ++k) {
    const unsigned peers = peers_of(id[k], nv, bits);
    const bool ok = id[k] < nv;
    const int32_t before = ok ? mine[id[k]] : 0;
    rank[k] = before + __popc(peers & lower);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) mine[id[k]] = before + __popc(peers);
    __syncwarp();
  }
  if (tile > 0) {
    back.finish(delta);
    const int groups = kCoThreads / back.L;
    for (int32_t v0 = groups; v0 < nv; v0 += groups) {
      back.begin(v0, nv);
      back.finish(delta);
    }
  }
  __syncthreads();
  // each id's warps before (in place) and rows in the tile; then one scan
  // of (count, rows in the tile) pairs gives the id's offset and its first
  // slot in the tile
  __shared__ unsigned long long pair_sums[32];
  unsigned long long carry = 0;
#pragma unroll
  for (int k = 0; k < kCountChunks; ++k) {
    const int32_t v = threadIdx.x + k * kCoThreads;
    if (k * kCoThreads < nv) {
      int32_t run = 0;
      if (v < nv) {
        for (int w = 0; w < kCoWarps; ++w) {
          const int32_t c = warp_bins[w * nv + v];
          warp_bins[w * nv + v] = run;
          run += c;
        }
      }
      const unsigned long long x =
          (static_cast<unsigned long long>(c[k]) << 32) |
          static_cast<uint32_t>(run);
      unsigned long long total;
      const unsigned long long e =
          carry + block_inclusive_scan(x, pair_sums, &total) - x;
      if (v < nv) {
        const int32_t slot = static_cast<int32_t>(e & 0xFFFFFFFFu);
        first[v] = slot;
        delta[v] += static_cast<int32_t>(e >> 32) - slot;
      }
      carry += total;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCoItems; ++k) {
    if (id[k] < nv) {
      stage[first[id[k]] + mine[id[k]] + rank[k]] =
          (id[k] << 16) | (local0 + 32 * k);
    }
  }
  __syncthreads();
  const int64_t left = n - tile * kCoTile;
  const int32_t rows = left < kCoTile ? static_cast<int32_t>(left) : kCoTile;
  const int32_t row0 = static_cast<int32_t>(tile * kCoTile);
  for (int32_t slot = threadIdx.x; slot < rows; slot += kCoThreads) {
    const int32_t st = stage[slot];
    order[delta[st >> 16] + slot] = row0 + (st & 0xFFFF);
  }
}

bool one_pass(int64_t n, int32_t nv) {
  return nv <= kOnePassBins && n < kOnePassRows;
}

int64_t co_tiles(int64_t n) { return (n + kCoTile - 1) / kCoTile; }

}  // namespace

// Partition ids of n rows over `n_keys` key columns described by the host
// array `keys`; a row whose `row_mask` byte is 0 gets num_parts (row_mask
// may be null). Launches on `stream`; returns cudaGetLastError().
extern "C" int srt_partition_ids(const SrtKeyDesc* keys, int32_t n_keys,
                                 int64_t n, uint32_t seed,
                                 int32_t num_parts,
                                 int32_t normalize, const uint8_t* row_mask,
                                 int32_t* out, void* stream) {
  if (n_keys < 0 || n_keys > kMaxKeys || num_parts < 1 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KeySet ks;
  ks.n = n_keys;
  for (int32_t j = 0; j < n_keys; ++j) ks.k[j] = keys[j];
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  partition_ids_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ks, n, seed, num_parts, normalize, row_mask, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int32_t srt_partition_ids_max_keys() { return kMaxKeys; }

extern "C" int32_t srt_counting_order_max_bins() { return kMaxBins; }

// int32 words of scratch srt_counting_order needs for n ids in [0, nv).
extern "C" int64_t srt_counting_order_scratch(int64_t n, int32_t nv) {
  if (one_pass(n, nv)) return static_cast<int64_t>(nv) * co_tiles(n);
  const int64_t tile = tile_rows(n);
  const int64_t n_tiles = (n + tile - 1) / tile;
  return static_cast<int64_t>(nv) * n_tiles + nv;
}

// Stable order grouping n int32 ids in [0, nv) ascending -> order (n
// int32 row numbers) and counts (nv int32). n > 0, nv <= kMaxBins. On
// `stream`: one memset and two launches (nv <= kOnePassBins, n < 2^30),
// else four launches; returns the first error (0 = launched).
extern "C" int srt_counting_order(const int32_t* ids, int64_t n, int32_t nv,
                                  int32_t* scratch, int32_t* order,
                                  int32_t* counts, void* stream) {
  if (n <= 0 || nv < 1 || nv > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (one_pass(n, nv)) {
    const int32_t tiles = static_cast<int32_t>(co_tiles(n));
    uint32_t* words = reinterpret_cast<uint32_t*>(scratch);
    int rc = static_cast<int>(
        cudaMemsetAsync(counts, 0, sizeof(int32_t) * nv, s));
    if (rc != 0) return rc;
    co_tile_counts<<<tiles, kCountThreads, sizeof(int32_t) * nv, s>>>(
        ids, n, nv, tiles, words, counts);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const size_t shmem =
        sizeof(int32_t) * (kCoTile + static_cast<size_t>(kCoWarps + 2) * nv);
    if (shmem > 48 * 1024) {
      rc = static_cast<int>(cudaFuncSetAttribute(
          co_rank_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem)));
      if (rc != 0) return rc;
    }
    co_rank_scatter<<<tiles, kCoThreads, shmem, s>>>(ids, n, nv, tiles,
                                                     counts, words, order);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tile = tile_rows(n);
  const int32_t n_tiles = static_cast<int32_t>((n + tile - 1) / tile);
  int32_t* hist = scratch;
  int32_t* idoff = scratch + static_cast<int64_t>(nv) * n_tiles;
  const size_t shmem = static_cast<size_t>(nv) * sizeof(int32_t);
  co_histogram<<<n_tiles, kThreads, shmem, s>>>(ids, n, tile, nv, n_tiles,
                                                hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  co_scan_tiles<<<nv, kScanThreads, 0, s>>>(hist, n_tiles, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  co_scan_ids<<<1, kScanThreads, 0, s>>>(counts, nv, idoff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  co_scatter<<<n_tiles, 32, shmem, s>>>(ids, n, tile, nv, n_tiles, hist,
                                        idoff, order);
  return static_cast<int>(cudaGetLastError());
}
