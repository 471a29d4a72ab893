// Java's find() loop over a padded string matrix, for sm_90a: the match
// spans of regexp_replace, replace and regexp_extract, and substring_index's
// delimiter scan.
//
// Replaces XLA loops of the JAX package, none of them a Pallas kernel:
// - regex_replace: spark_rapids_tpu/expr/regex.py:419 DeviceNfa.match_ends
//   (a lax.scan over the byte columns holding an (n, w) state set per
//   start), :695 literal_match_ends, :623 select_leftmost_spans, :643
//   replace_by_spans and :887 replace_by_template (scans over the columns
//   writing one byte a row a step), with the capture-group walk of :846
//   _greedy_walk_bounds / :873 group_bounds_all_starts;
// - regex_extract: :679 extract_first_span and :945 extract_group_span (with
//   :419 and :846);
// - delim_select: the lax.scan of spark_rapids_tpu/expr/strings.py:416
//   (SubstringIndex._eval_device), the left-to-right overlap resolution of
//   a delimiter's occurrences.
// Each is held bit-equal to its plain torch version (expr/regex_kernels.py
// regex_replace_reference, regex_extract_reference, delim_select_reference,
// themselves the JAX functions' column loops).
//
// Design: one thread a row runs find() directly. At each start j at or past
// the end of the last match it steps the matcher from j until its state set
// empties (or the row ends) and keeps the last accepting end, which is
// match_ends[j]; a match writes the replacement and jumps to its end, no
// match copies byte j. That is select_leftmost_spans(match_ends(...)) without
// the (n, w) int32 ends matrix (512 B a row at width 128) or the (n, w)
// state sets, and it steps a start only as far as its match can reach.
// - The matcher is a program the host builds once per pattern
//   (regex_kernels.py regex_program), copied into shared memory by each
//   block: a literal search, or the NFA as its byte classes (256 bytes) and
//   successor sets succ[class][state] (at most 256 x 32 words), so one step
//   ORs the successor sets of the active states (one or two for the span
//   subset's patterns); and the bytes that can begin a match (256 bits),
//   so a start whose byte cannot is copied without stepping. Plus the
//   capture-group plan's items (a 256-bit charset, lo, hi), the groups'
//   item ranges and the template's segments with their literal bytes.
// - A $n group's bounds come from the greedy walk of the plan's items from
//   the selected start only, as JAX's: each item takes the run of member
//   bytes within the length, capped at hi; lo is never checked.
// - Rows are read in 16-byte aligned pieces, two cached in registers (the
//   main position and the look-ahead of a match), so a row of any stride or
//   alignment (a broadcast row, a view) costs one vector load a piece; a
//   piece may hold bytes of another row, never bytes outside the 16-byte
//   granule of a byte this row owns.
// - Output bytes are gathered in registers and stored 16 (or 8) at a time;
//   as in the JAX package, a byte at or past out_w - 1 lands on out_w - 1
//   (the last such byte stays) and the length counts every byte.
//
// Bound: the bytes each row must read (its first `len` bytes, by the whole
// 32-byte sectors holding them), its length, its output row and length,
// over the card's memory rate. One thread a row means a warp waits for its
// longest row and its longest chain of steps: a cost in time, not in
// correctness (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int64_t kMaxBlocks = 132 * 32;

// regex_kernels.py REGEX_HEADER: the program's header words
enum Header : int {
  kKind = 0,      // 0: a literal search, 1: an NFA
  kFlags = 1,     // bit 0: anchored at the start; bit 1: at the end
  kStates = 2,    // NFA states (a literal: the search's length)
  kStart = 3,     // the start state's bits
  kAccept = 4,    // the accepting states' bits
  kItems = 5,     // capture-group plan items
  kSegs = 6,      // template segments
  kGroups = 7,    // capture groups
  kClassAt = 8,   // word offset of the byte classes (256 bytes)
  kSuccAt = 9,    // ... of succ[class * states + state]
  kItemAt = 10,   // ... of the items, 10 words each (charset, lo, hi)
  kGroupAt = 11,  // ... of (first item, end item) per group, 0 first
  kSegAt = 12,    // ... of the segments, 3 words each (kind, a, b)
  kPoolAt = 13,   // ... of the byte pool (the search, the literals)
  kWords = 14,    // the program's length in words
  kFirstAt = 15,  // ... of the bytes that can start a match (256 bits)
};
constexpr uint32_t kNoHi = 0xFFFFFFFFu;

__device__ __forceinline__ uint4 load16(uintptr_t a) {
  return *reinterpret_cast<const uint4*>(a);
}

__device__ __forceinline__ uint32_t byte_of(uint4 v, uint32_t i) {
  const uint32_t w = i < 8 ? (i < 4 ? v.x : v.y) : (i < 12 ? v.z : v.w);
  return (w >> ((i & 3) * 8)) & 0xFF;
}

// A row's bytes through two cached 16-byte aligned pieces.
struct Reader {
  uintptr_t base;
  uintptr_t tag0 = ~uintptr_t{0}, tag1 = ~uintptr_t{0};
  uint4 p0{}, p1{};
  bool next1 = false;

  __device__ explicit Reader(const uint8_t* row)
      : base(reinterpret_cast<uintptr_t>(row)) {}

  __device__ __forceinline__ uint32_t at(int p) {
    const uintptr_t a = base + static_cast<uintptr_t>(p);
    const uintptr_t t = a >> 4;
    if (t == tag0) return byte_of(p0, a & 15);
    if (t == tag1) return byte_of(p1, a & 15);
    const uint4 v = load16(a & ~uintptr_t{15});
    if (next1) {
      p1 = v;
      tag1 = t;
    } else {
      p0 = v;
      tag0 = t;
    }
    next1 = !next1;
    return byte_of(v, a & 15);
  }
};

// An output row written in W-byte words (W = 16, 8 or 1). A byte at or past
// out_w - 1 lands on out_w - 1; finish() zeroes the rest of the row.
template <int W>
struct Writer {
  uint8_t* row;
  int out_w;
  int c = 0;
  uint64_t lo = 0, hi = 0;
  uint32_t clip = 0;

  __device__ Writer(uint8_t* r, int w) : row(r), out_w(w) {}

  __device__ __forceinline__ void store(int chunk, uint64_t a,
                                        uint64_t b) {
    if (W == 16) {
      *reinterpret_cast<uint4*>(row + chunk * 16) =
          make_uint4(static_cast<uint32_t>(a), static_cast<uint32_t>(a >> 32),
                     static_cast<uint32_t>(b), static_cast<uint32_t>(b >> 32));
    } else if (W == 8) {
      *reinterpret_cast<uint2*>(row + chunk * 8) =
          make_uint2(static_cast<uint32_t>(a), static_cast<uint32_t>(a >> 32));
    } else {
      row[chunk] = static_cast<uint8_t>(a);
    }
  }

  __device__ __forceinline__ void put(uint32_t b) {
    if (c < out_w - 1) {
      const int k = c & (W - 1);
      if (k < 8) {
        lo |= static_cast<uint64_t>(b) << (8 * k);
      } else {
        hi |= static_cast<uint64_t>(b) << (8 * (k - 8));
      }
      if (k == W - 1) {  // never the last word: it ends at out_w - 1
        store(c / W, lo, hi);
        lo = hi = 0;
      }
    } else {
      clip = b;
    }
    ++c;
  }

  __device__ void finish() {
    const int cc = c < out_w - 1 ? c : out_w - 1;
    const int words = out_w / W;
    for (int k = cc / W; k < words; ++k) {
      uint64_t a = k == cc / W ? lo : 0;
      uint64_t b = k == cc / W ? hi : 0;
      if (k == words - 1) {  // the word of out_w - 1: its last byte
        if (W == 16) {
          b = (b & 0x00FFFFFFFFFFFFFFull) | static_cast<uint64_t>(clip) << 56;
        } else if (W == 8) {
          a = (a & 0x00FFFFFFFFFFFFFFull) | static_cast<uint64_t>(clip) << 56;
        } else {
          a = clip;
        }
      }
      store(k, a, b);
    }
  }
};

// A block's copy of the program, its header read into registers once.
struct Program {
  uint32_t kind, flags, states, start, accept, segs;
  const uint8_t* cls;
  const uint32_t* succ;
  const uint32_t* first;
  const uint32_t* items;
  const uint32_t* groups;
  const uint32_t* seg;
  const uint8_t* pool;

  __device__ explicit Program(const uint32_t* w)
      : kind(w[kKind]),
        flags(w[kFlags]),
        states(w[kStates]),
        start(w[kStart]),
        accept(w[kAccept]),
        segs(w[kSegs]),
        cls(reinterpret_cast<const uint8_t*>(w + w[kClassAt])),
        succ(w + w[kSuccAt]),
        first(w + w[kFirstAt]),
        items(w + w[kItemAt]),
        groups(w + w[kGroupAt]),
        seg(w + w[kSegAt]),
        pool(reinterpret_cast<const uint8_t*>(w + w[kPoolAt])) {}

  // whether byte b can begin a match: most starts end here
  __device__ __forceinline__ bool may_start(uint32_t b) const {
    return ((first[b >> 5] >> (b & 31)) & 1) != 0;
  }

  // The end (exclusive) of the longest match from start j, or -1; byte j
  // passed may_start (a literal's first byte is its search's).
  __device__ int longest_from(Reader& rd, int j, int len) const {
    if (kind == 0) {
      const int n = static_cast<int>(states);
      if (j + n > len) return -1;
      for (int k = 1; k < n; ++k)
        if (rd.at(j + k) != pool[k]) return -1;
      return j + n;
    }
    const bool end = (flags & 2) != 0;
    uint32_t active = start;
    int e = -1;
    for (int p = j; p < len && active != 0; ++p) {
      const uint32_t* row = succ + cls[rd.at(p)] * states;
      uint32_t next = 0;
      for (uint32_t a = active; a != 0; a &= a - 1) next |= row[__ffs(a) - 1];
      active = next;
      if ((active & accept) != 0 && (!end || p == len - 1)) e = p + 1;
    }
    return e;
  }

  // Group g's bounds for a match from `at`: the greedy walk of the plan's
  // items up to the group's end item.
  __device__ void group_bounds(Reader& rd, int len, int at, int g, int* gs,
                               int* ge) const {
    const int lo = static_cast<int>(groups[2 * g]);
    const int hi_item = static_cast<int>(groups[2 * g + 1]);
    int pos = at;
    *gs = at;
    for (int i = 0; i < hi_item; ++i) {
      if (i == lo) *gs = pos;
      const uint32_t* it = items + 10 * i;
      const uint32_t hi = it[9];
      int take = 0;
      while (pos + take < len && (hi == kNoHi || take < static_cast<int>(hi))) {
        const uint32_t b = rd.at(pos + take);
        if (((it[b >> 5] >> (b & 31)) & 1) == 0) break;
        ++take;
      }
      pos += take;
    }
    if (lo == hi_item) *gs = pos;
    *ge = pos;
  }

  // The template for the match [j, e) of a row.
  template <int W>
  __device__ void emit(Reader& rd, Writer<W>& wr, int j, int e, int width,
                       int len) const {
    const uint32_t* sg = seg;
    for (uint32_t s = 0; s < segs; ++s, sg += 3) {
      if (sg[0] == 0) {
        for (uint32_t k = 0; k < sg[2]; ++k) wr.put(pool[sg[1] + k]);
        continue;
      }
      int gs = j, ge = e;
      if (sg[1] != 0)
        group_bounds(rd, len, j, static_cast<int>(sg[1]), &gs, &ge);
      for (int p = gs; p < ge; ++p) wr.put(rd.at(p < width ? p : width - 1));
    }
  }
};

__device__ __forceinline__ void load_program(uint32_t* smem,
                                             const uint32_t* prog, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = prog[i];
  __syncthreads();
}

__device__ __forceinline__ int row_length(const int32_t* lengths, int64_t r,
                                          int width) {
  const int len = lengths[r];
  return len < 0 ? 0 : (len > width ? width : len);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    regex_replace_kernel(const uint8_t* __restrict__ data, int64_t stride,
                         int width, const int32_t* __restrict__ lengths,
                         int64_t n, const uint32_t* __restrict__ prog_g,
                         int words, int64_t out_w, uint8_t* __restrict__ out,
                         int32_t* __restrict__ out_len) {
  extern __shared__ uint32_t prog_s[];
  load_program(prog_s, prog_g, words);
  const Program prog(prog_s);
  const bool anchored = (prog.flags & 1) != 0;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int len = row_length(lengths, r, width);
    Reader rd(data + r * stride);
    Writer<W> wr(out + r * out_w, out_w);
    int j = 0;
    while (j < len) {
      const uint32_t b = rd.at(j);
      const int e = (!anchored || j == 0) && prog.may_start(b)
                        ? prog.longest_from(rd, j, len)
                        : -1;
      if (e >= 0) {
        prog.emit(rd, wr, j, e, width, len);
        j = e;
      } else {
        wr.put(b);
        ++j;
      }
    }
    wr.finish();
    out_len[r] = static_cast<int32_t>(wr.c);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    regex_extract_kernel(const uint8_t* __restrict__ data, int64_t stride,
                         int width, const int32_t* __restrict__ lengths,
                         int64_t n, const uint32_t* __restrict__ prog_g,
                         int words, int group, uint8_t* __restrict__ out,
                         int32_t* __restrict__ out_len) {
  extern __shared__ uint32_t prog_s[];
  load_program(prog_s, prog_g, words);
  const Program prog(prog_s);
  const int starts = (prog.flags & 1) != 0 ? 1 : width;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int len = row_length(lengths, r, width);
    Reader rd(data + r * stride);
    Writer<W> wr(out + r * static_cast<int64_t>(width), width);
    int gs = 0, ge = 0;
    for (int j = 0; j < len && j < starts; ++j) {
      if (!prog.may_start(rd.at(j))) continue;
      const int e = prog.longest_from(rd, j, len);
      if (e >= 0) {
        gs = j;
        ge = e;
        if (group != 0) prog.group_bounds(rd, len, j, group, &gs, &ge);
        break;
      }
    }
    for (int p = gs; p < ge; ++p) wr.put(rd.at(p < width ? p : width - 1));
    wr.finish();
    out_len[r] = ge > gs ? ge - gs : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    delim_select_kernel(const uint8_t* __restrict__ data, int64_t stride,
                        int width, const int32_t* __restrict__ lengths,
                        int64_t n, const uint8_t* __restrict__ delim, int dlen,
                        int count, int32_t* __restrict__ cut) {
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int len = row_length(lengths, r, width);
    Reader rd(data + r * stride);
    const uint32_t d0 = delim[0];
    // the kept occurrences left to right: an occurrence at j is kept when
    // it starts at or past the end of the last kept one
    auto kept = [&](int want, int* at) {
      int seen = 0, next_ok = 0;
      for (int j = 0; j + dlen <= len; ++j) {
        if (j < next_ok || rd.at(j) != d0) continue;
        int k = 1;
        while (k < dlen && rd.at(j + k) == delim[k]) ++k;
        if (k < dlen) continue;
        next_ok = j + dlen;
        if (++seen == want) {
          *at = j;
          break;
        }
      }
      return seen;
    };
    int at = 0;
    if (count > 0) {
      cut[r] = kept(count, &at) == count ? at : lengths[r];
    } else {
      const int total = kept(0, &at);
      const int k = -count;
      cut[r] = total >= k && kept(total - k + 1, &at) > 0 ? at + dlen : 0;
    }
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// the widest word the output rows take: 16 or 8 bytes when the width and
// the base allow it, else bytes
int word_of(const void* out, int64_t out_w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  if (out_w % 16 == 0 && a % 16 == 0) return 16;
  if (out_w % 8 == 0 && a % 8 == 0) return 8;
  return 1;
}

template <class K>
int shared_for(K kernel, int words) {
  const int bytes = words * 4;
  if (bytes > 227 * 1024) return -1;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return -1;
  return bytes;
}

template <int W>
int launch_replace(const uint8_t* data, int64_t stride, int32_t width,
                   const int32_t* lengths, int64_t n, const uint32_t* prog,
                   int32_t words, int32_t out_w, uint8_t* out,
                   int32_t* out_len, cudaStream_t stream) {
  const int smem = shared_for(regex_replace_kernel<W>, words);
  if (smem < 0) return cudaErrorInvalidValue;
  regex_replace_kernel<W><<<blocks_for(n), kThreads, smem, stream>>>(
      data, stride, width, lengths, n, prog, words, out_w, out, out_len);
  return cudaGetLastError();
}

template <int W>
int launch_extract(const uint8_t* data, int64_t stride, int32_t width,
                   const int32_t* lengths, int64_t n, const uint32_t* prog,
                   int32_t words, int32_t group, uint8_t* out,
                   int32_t* out_len, cudaStream_t stream) {
  const int smem = shared_for(regex_extract_kernel<W>, words);
  if (smem < 0) return cudaErrorInvalidValue;
  regex_extract_kernel<W><<<blocks_for(n), kThreads, smem, stream>>>(
      data, stride, width, lengths, n, prog, words, group, out, out_len);
  return cudaGetLastError();
}

bool program_ok(const uint32_t* prog, int32_t words) {
  return prog != nullptr && words >= 16;
}

}  // namespace

extern "C" {

// regexp_replace / replace: `data` rows `stride` bytes apart (0: one
// broadcast row), `width` bytes each, byte `lengths`; `prog` the program of
// regex_kernels.py regex_program (`words` uint32) in device memory; `out`
// (n, out_w) uint8 and `out_len` int32 (n,).
int srt_regex_replace(const uint8_t* data, int64_t stride, int32_t width,
                      const int32_t* lengths, int64_t n, const uint32_t* prog,
                      int32_t words, int32_t out_w, uint8_t* out,
                      int32_t* out_len, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (width <= 0 || out_w <= 0 || !program_ok(prog, words))
    return cudaErrorInvalidValue;
  switch (word_of(out, out_w)) {
    case 16:
      return launch_replace<16>(data, stride, width, lengths, n, prog, words,
                                out_w, out, out_len, stream);
    case 8:
      return launch_replace<8>(data, stride, width, lengths, n, prog, words,
                               out_w, out, out_len, stream);
    default:
      return launch_replace<1>(data, stride, width, lengths, n, prog, words,
                               out_w, out, out_len, stream);
  }
}

// regexp_extract: the first match's span (group 0) or capture group `group`
// of it moved to byte 0 of an (n, width) uint8 `out`, the rest zero.
int srt_regex_extract(const uint8_t* data, int64_t stride, int32_t width,
                      const int32_t* lengths, int64_t n, const uint32_t* prog,
                      int32_t words, int32_t group, uint8_t* out,
                      int32_t* out_len, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (width <= 0 || group < 0 || !program_ok(prog, words))
    return cudaErrorInvalidValue;
  switch (word_of(out, width)) {
    case 16:
      return launch_extract<16>(data, stride, width, lengths, n, prog, words,
                                group, out, out_len, stream);
    case 8:
      return launch_extract<8>(data, stride, width, lengths, n, prog, words,
                               group, out, out_len, stream);
    default:
      return launch_extract<1>(data, stride, width, lengths, n, prog, words,
                               group, out, out_len, stream);
  }
}

// substring_index: for count > 0 the start of the count-th kept occurrence
// of `delim` (`dlen` >= 1 bytes, device memory), or the row's length when
// there are fewer; for count < 0 the end of the (-count)-th kept
// occurrence from the right, or 0. -> `cut` int32 (n,).
int srt_delim_select(const uint8_t* data, int64_t stride, int32_t width,
                     const int32_t* lengths, int64_t n, const uint8_t* delim,
                     int32_t dlen, int32_t count, int32_t* cut,
                     cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (width <= 0 || dlen <= 0 || count == 0 || delim == nullptr)
    return cudaErrorInvalidValue;
  delim_select_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      data, stride, width, lengths, n, delim, dlen, count, cut);
  return cudaGetLastError();
}

}  // extern "C"
