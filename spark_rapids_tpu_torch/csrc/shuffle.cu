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
// counting_order: a counting sort of int32 ids in [0, nv), stable, in four
// launches: per-tile histograms (shared-memory atomics), an exclusive scan
// over (id, tile) in that order (one block an id), an exclusive scan over
// the ids' totals (one block), and a stable scatter in which one warp walks
// its tile in 32-row steps and ranks equal ids with __match_any_sync. It
// returns the permutation and each id's count, so a caller reads the counts
// and never the ids. Bound: bytes (the ids read twice by the kernel, once by
// the bound; the order written once). The histogram is nv x tiles ints,
// which the tile size keeps below the ids' own bytes for nv up to a few
// hundred.
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
// counting order: at most this many ids, tiles and rows a tile at least
constexpr int kMaxBins = 8192;
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
__device__ int32_t block_inclusive_scan(int32_t x, int32_t* warp_sums,
                                        int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t v = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int32_t s = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  const int32_t out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[nw - 1];
  __syncthreads();
  return out;
}

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
  const int64_t tile = tile_rows(n);
  const int64_t n_tiles = (n + tile - 1) / tile;
  return static_cast<int64_t>(nv) * n_tiles + nv;
}

// Stable order grouping n int32 ids in [0, nv) ascending -> order (n
// int32 row numbers) and counts (nv int32). n > 0, nv <= kMaxBins. Four
// launches on `stream`; returns the first launch error (0 = launched).
extern "C" int srt_counting_order(const int32_t* ids, int64_t n, int32_t nv,
                                  int32_t* scratch, int32_t* order,
                                  int32_t* counts, void* stream) {
  if (n <= 0 || nv < 1 || nv > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
