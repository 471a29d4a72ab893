// The host-runtime native library of the PyTorch/CUDA port, built with g++
// at first use (spark_rapids_tpu_torch/host_native.py) and reached through
// ctypes. The device work lives in the CUDA kernels of this directory
// (*.cu, built by nvcc); this library is host code:
//   - LZ4 block-format codec        (the shuffle codec "lz4"; role of nvcomp
//                                    LZ4, reference
//                                    NvcompLZ4CompressionCodec.scala)
//   - xxhash64 / murmur3 kernels    (reference HashFunctions.scala)
//   - hash_partition counting sort  (reference GpuPartitioning contiguous
//                                    split: one pass pid assignment + stable
//                                    row order so each partition is one slice)
//   - hashed priority queue         (reference HashedPriorityQueue.java, spill
//                                    priority maintenance with O(log n) update)
//   - host arena allocator          (reference RMM ARENA mode / bounce-buffer
//                                    AddressSpaceAllocator.scala: offset-based
//                                    first-fit with coalescing free)
//
// The same C ABI and the same bytes as the JAX package's
// spark_rapids_tpu/native/srtpu_native.cpp, of which this is a copy (the
// Parquet BYTE_ARRAY walk is left out: the port's is srt_ba_walk in
// parquet_decode.cu). Implemented from the public LZ4 block & xxHash format
// specifications.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <limits>
#include <map>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// LZ4 block format
// ---------------------------------------------------------------------------

int64_t srtpu_lz4_compress_bound(int64_t n) {
  return n + n / 255 + 16;
}

// Greedy LZ4 block compressor: 16-bit hash chain over 4-byte windows.
int64_t srtpu_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap) {
  if (n < 0 || cap < srtpu_lz4_compress_bound(n)) return -1;
  uint8_t* op = dst;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  const uint8_t* anchor = src;
  // matches may not extend into the final 12 bytes; final 5 must be literals
  const uint8_t* const mflimit = (n >= 13) ? iend - 12 : src;

  auto read32 = [](const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
  };
  auto hash4 = [&](const uint8_t* p) {
    return (read32(p) * 2654435761u) >> 16;
  };

  std::vector<int64_t> table(1 << 16, -1);

  auto emit = [&](const uint8_t* lit_start, int64_t lit_len, int64_t mlen,
                  int64_t offset) {
    int64_t ml_token = (mlen > 0) ? mlen - 4 : 0;
    uint8_t token = (uint8_t)(((lit_len >= 15 ? 15 : lit_len) << 4)
                              | (mlen > 0 ? (ml_token >= 15 ? 15 : ml_token) : 0));
    *op++ = token;
    if (lit_len >= 15) {
      int64_t rest = lit_len - 15;
      while (rest >= 255) { *op++ = 255; rest -= 255; }
      *op++ = (uint8_t)rest;
    }
    std::memcpy(op, lit_start, lit_len);
    op += lit_len;
    if (mlen > 0) {
      *op++ = (uint8_t)(offset & 0xff);
      *op++ = (uint8_t)((offset >> 8) & 0xff);
      if (ml_token >= 15) {
        int64_t rest = ml_token - 15;
        while (rest >= 255) { *op++ = 255; rest -= 255; }
        *op++ = (uint8_t)rest;
      }
    }
  };

  ip = src;
  while (ip < mflimit) {
    uint32_t h = hash4(ip);
    int64_t cand = table[h];
    table[h] = ip - src;
    if (cand >= 0 && (ip - src) - cand <= 65535 &&
        read32(src + cand) == read32(ip)) {
      // extend match forward
      const uint8_t* m = src + cand;
      const uint8_t* p = ip + 4;
      const uint8_t* q = m + 4;
      const uint8_t* match_limit = iend - 5;
      while (p < match_limit && *p == *q) { ++p; ++q; }
      int64_t mlen = p - ip;
      emit(anchor, ip - anchor, mlen, ip - m);
      ip += mlen;
      anchor = ip;
    } else {
      ++ip;
    }
  }
  // trailing literals
  emit(anchor, iend - anchor, 0, 0);
  return op - dst;
}

int64_t srtpu_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  while (ip < iend) {
    uint8_t token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence has no match
    if (ip + 2 > iend) return -1;
    int64_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t mlen = (token & 0xf) + 4;
    if ((token & 0xf) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > oend) return -1;
    const uint8_t* m = op - offset;
    for (int64_t i = 0; i < mlen; ++i) op[i] = m[i];  // overlap-safe
    op += mlen;
  }
  return op - dst;
}

// ---------------------------------------------------------------------------
// xxHash64 (one hash per variable-length record via offsets, or whole buffer)
// ---------------------------------------------------------------------------

static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      uint64_t k;
      std::memcpy(&k, p, 8); v1 = rotl64(v1 + k * P2, 31) * P1; p += 8;
      std::memcpy(&k, p, 8); v2 = rotl64(v2 + k * P2, 31) * P1; p += 8;
      std::memcpy(&k, p, 8); v3 = rotl64(v3 + k * P2, 31) * P1; p += 8;
      std::memcpy(&k, p, 8); v4 = rotl64(v4 + k * P2, 31) * P1; p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    uint64_t vs[4] = {v1, v2, v3, v4};
    for (uint64_t v : vs) {
      h ^= rotl64(v * P2, 31) * P1;
      h = h * P1 + P4;
    }
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    h ^= rotl64(k * P2, 31) * P1;
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t k;
    std::memcpy(&k, p, 4);
    h ^= (uint64_t)k * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl64(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

uint64_t srtpu_xxhash64_buffer(const uint8_t* data, int64_t n, uint64_t seed) {
  return xxh64(data, (size_t)n, seed);
}

void srtpu_xxhash64_records(const uint8_t* blob, const int32_t* offsets,
                            int64_t n, uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = xxh64(blob + offsets[i], (size_t)(offsets[i + 1] - offsets[i]),
                   seed);
  }
}

// ---------------------------------------------------------------------------
// Murmur3 x86_32 (Spark flavor: per-value chained hash, seed in/out)
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}
static inline uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1b873593u;
  return k1;
}
static inline uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5 + 0xe6546b64u;
}
static inline uint32_t fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  h1 ^= h1 >> 16;
  return h1;
}

void srtpu_murmur3_int(const int32_t* v, int64_t n, uint32_t* inout) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t h1 = mix_h1(inout[i], mix_k1((uint32_t)v[i]));
    inout[i] = fmix(h1, 4);
  }
}

void srtpu_murmur3_long(const int64_t* v, int64_t n, uint32_t* inout) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t lo = (uint32_t)(uint64_t)v[i];
    uint32_t hi = (uint32_t)((uint64_t)v[i] >> 32);
    uint32_t h1 = mix_h1(inout[i], mix_k1(lo));
    h1 = mix_h1(h1, mix_k1(hi));
    inout[i] = fmix(h1, 8);
  }
}

void srtpu_murmur3_double(const double* v, int64_t n, uint32_t* inout) {
  for (int64_t i = 0; i < n; ++i) {
    // normalize -0.0 and NaN bit patterns (Spark rule; must match the
    // device path's _normalize_float in expr/hashing.py bit-for-bit)
    double d = (v[i] == 0.0) ? 0.0 : v[i];
    if (d != d) d = std::numeric_limits<double>::quiet_NaN();
    int64_t bits;
    std::memcpy(&bits, &d, 8);
    uint32_t lo = (uint32_t)(uint64_t)bits;
    uint32_t hi = (uint32_t)((uint64_t)bits >> 32);
    uint32_t h1 = mix_h1(inout[i], mix_k1(lo));
    h1 = mix_h1(h1, mix_k1(hi));
    inout[i] = fmix(h1, 8);
  }
}

// Spark hashUnsafeBytes: 4-byte little-endian blocks then per-byte tail.
void srtpu_murmur3_bytes(const uint8_t* blob, const int32_t* offsets,
                         int64_t n, uint32_t* inout) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = blob + offsets[i];
    uint32_t len = (uint32_t)(offsets[i + 1] - offsets[i]);
    uint32_t h1 = inout[i];
    uint32_t nblocks = len / 4;
    for (uint32_t b = 0; b < nblocks; ++b) {
      uint32_t k;
      std::memcpy(&k, p + b * 4, 4);
      h1 = mix_h1(h1, mix_k1(k));
    }
    for (uint32_t j = nblocks * 4; j < len; ++j) {
      h1 = mix_h1(h1, mix_k1((uint32_t)(int32_t)(int8_t)p[j]));
    }
    inout[i] = fmix(h1, len);
  }
}

// ---------------------------------------------------------------------------
// Hash partition assignment + stable counting-sort row order
// ---------------------------------------------------------------------------

// pids[i] = hashes[i] mod p (non-negative); counts[k] = rows in partition k;
// order = row indices stably grouped by partition so each output partition is
// one contiguous slice of a single gather (reference: contiguous_split).
void srtpu_hash_partition(const uint32_t* hashes, int64_t n, int32_t p,
                          int32_t* pids, int64_t* counts, int64_t* order) {
  for (int32_t k = 0; k < p; ++k) counts[k] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t pid = (int32_t)((int32_t)hashes[i] % p);
    if (pid < 0) pid += p;
    pids[i] = pid;
    counts[pid]++;
  }
  std::vector<int64_t> cursor(p, 0);
  int64_t acc = 0;
  for (int32_t k = 0; k < p; ++k) {
    cursor[k] = acc;
    acc += counts[k];
  }
  for (int64_t i = 0; i < n; ++i) {
    order[cursor[pids[i]]++] = i;
  }
}

// ---------------------------------------------------------------------------
// Hashed priority queue (reference HashedPriorityQueue.java):
// pop-lowest-priority with O(log n) priority update by handle.
// ---------------------------------------------------------------------------

struct SrtpuPQ {
  // multimap priority -> (handle, payload); handle -> iterator for O(log n)
  // removal. Ties pop in insertion order (handle order).
  std::multimap<std::pair<int64_t, int64_t>, int64_t> heap;
  std::unordered_map<int64_t,
      std::multimap<std::pair<int64_t, int64_t>, int64_t>::iterator> index;
  int64_t next_handle = 1;
};

void* srtpu_pq_create() { return new SrtpuPQ(); }
void srtpu_pq_destroy(void* q) { delete (SrtpuPQ*)q; }

int64_t srtpu_pq_push(void* qp, int64_t priority, int64_t payload) {
  SrtpuPQ* q = (SrtpuPQ*)qp;
  int64_t h = q->next_handle++;
  auto it = q->heap.emplace(std::make_pair(priority, h), payload);
  q->index[h] = it;
  return h;
}

int srtpu_pq_update(void* qp, int64_t handle, int64_t priority) {
  SrtpuPQ* q = (SrtpuPQ*)qp;
  auto f = q->index.find(handle);
  if (f == q->index.end()) return 0;
  int64_t payload = f->second->second;
  q->heap.erase(f->second);
  auto it = q->heap.emplace(std::make_pair(priority, handle), payload);
  f->second = it;
  return 1;
}

int srtpu_pq_remove(void* qp, int64_t handle) {
  SrtpuPQ* q = (SrtpuPQ*)qp;
  auto f = q->index.find(handle);
  if (f == q->index.end()) return 0;
  q->heap.erase(f->second);
  q->index.erase(f);
  return 1;
}

int srtpu_pq_pop(void* qp, int64_t* payload_out, int64_t* priority_out) {
  SrtpuPQ* q = (SrtpuPQ*)qp;
  if (q->heap.empty()) return 0;
  auto it = q->heap.begin();
  *priority_out = it->first.first;
  *payload_out = it->second;
  q->index.erase(it->first.second);
  q->heap.erase(it);
  return 1;
}

int64_t srtpu_pq_size(void* qp) {
  return (int64_t)((SrtpuPQ*)qp)->heap.size();
}

// ---------------------------------------------------------------------------
// Host arena allocator (offset-based first-fit, coalescing free — the spill
// staging pool; reference: RMM ARENA mode + AddressSpaceAllocator.scala)
// ---------------------------------------------------------------------------

struct SrtpuArena {
  uint8_t* base;
  int64_t capacity;
  int64_t used = 0;
  std::map<int64_t, int64_t> free_blocks;   // offset -> size
  std::unordered_map<int64_t, int64_t> allocs;  // offset -> size
};

static const int64_t kAlign = 64;

void* srtpu_arena_create(int64_t capacity) {
  SrtpuArena* a = new SrtpuArena();
  capacity = (capacity + kAlign - 1) / kAlign * kAlign;
  a->base = (uint8_t*)std::malloc((size_t)capacity);
  if (!a->base) {
    delete a;
    return nullptr;
  }
  a->capacity = capacity;
  a->free_blocks[0] = capacity;
  return a;
}

void srtpu_arena_destroy(void* ap) {
  SrtpuArena* a = (SrtpuArena*)ap;
  std::free(a->base);
  delete a;
}

int64_t srtpu_arena_alloc(void* ap, int64_t size) {
  SrtpuArena* a = (SrtpuArena*)ap;
  if (size <= 0) size = kAlign;
  size = (size + kAlign - 1) / kAlign * kAlign;
  for (auto it = a->free_blocks.begin(); it != a->free_blocks.end(); ++it) {
    if (it->second >= size) {
      int64_t off = it->first;
      int64_t remaining = it->second - size;
      a->free_blocks.erase(it);
      if (remaining > 0) a->free_blocks[off + size] = remaining;
      a->allocs[off] = size;
      a->used += size;
      return off;
    }
  }
  return -1;  // caller spills and retries (DeviceMemoryEventHandler pattern)
}

int srtpu_arena_free(void* ap, int64_t offset) {
  SrtpuArena* a = (SrtpuArena*)ap;
  auto f = a->allocs.find(offset);
  if (f == a->allocs.end()) return 0;
  int64_t size = f->second;
  a->allocs.erase(f);
  a->used -= size;
  // insert and coalesce with neighbors
  auto it = a->free_blocks.emplace(offset, size).first;
  if (it != a->free_blocks.begin()) {
    auto prev = std::prev(it);
    if (prev->first + prev->second == it->first) {
      prev->second += it->second;
      a->free_blocks.erase(it);
      it = prev;
    }
  }
  auto next = std::next(it);
  if (next != a->free_blocks.end() && it->first + it->second == next->first) {
    it->second += next->second;
    a->free_blocks.erase(next);
  }
  return 1;
}

int64_t srtpu_arena_used(void* ap) { return ((SrtpuArena*)ap)->used; }
int64_t srtpu_arena_capacity(void* ap) { return ((SrtpuArena*)ap)->capacity; }
uint8_t* srtpu_arena_base(void* ap) { return ((SrtpuArena*)ap)->base; }

}  // extern "C"
