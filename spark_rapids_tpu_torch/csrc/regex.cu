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
// Bound. Each kernel must read the bytes within each row's length (by the
// whole 32-byte sectors holding them: chip_smoke.py _parse_bound_bytes), its
// length, and write its output row and length; over the card's memory rate
// that is 0.0676 ms at 2^20 rows of width 128. The matching itself is a
// chain of dependent shared-memory lookups a byte, so what bounds it in
// practice is how many such chains are in flight, and how many of the
// instructions a warp issues do work for a row.
//
// The matcher, in both span kernels: the pattern's span DFA
// (regex_kernels.py regex_program, udf/kernels.py span_dfa: the subset
// construction of a match from one start, minimised, the set from which no
// accept is reachable a dead state 0), stepped from start j until the dead
// state or the row's end, keeping the last accepting position:
// match_ends[j]. A step is two shared lookups (the byte's class, the next
// state); accepting states are numbered last, so an accept is a compare.
// A pattern whose DFA passes 256 states steps the NFA's successor sets
// instead (one or two active states for the span subset). A regex `$`
// also accepts just before a final '\n' (kFlagEndNewline).
//
// regex_replace: one thread a row runs find() directly (a warp a row was
// slower at every width the main path launches it at: PERF.md §6).
// At each start at or past the end of the last match whose byte can begin
// a match it steps the matcher; a match writes the template and jumps to
// its end, no match copies the byte. Rows are read in 16-byte aligned
// pieces, two cached in registers (the main position and a match's
// look-ahead), so a row of any stride or alignment (a broadcast row, a
// view) costs one vector load a piece; output bytes are gathered in
// registers and stored 16 (or 8) at a time. Only the program lies in
// shared memory, so every width runs.
//
// regex_extract: a warp a row, a start a lane, in chunks of 32 starts;
// where the matrix is at most 16, 32 or 64 bytes wide, a group of 4, 8 or
// 16 lanes a row (8, 4 or 2 rows a warp), 4 starts a lane, so a short row
// is one chunk.
// - Reads. The group loads its row's 16-byte pieces (those holding a byte
//   within the length) into a shared staging row, neighbouring lanes on
//   neighbouring pieces, so the loads coalesce; the row keeps its offset
//   within a piece, so a row of any stride, alignment or a broadcast row
//   reads only the granules of its own bytes. Where a row and its output
//   do not fit shared memory beside the program (rows past about 116 KB),
//   the same kernel reads the row where it lies and stores bytes.
// - The first match. Each lane steps the matcher from its starts in the
//   chunk whose byte can begin a match, up to its first match; a ballot
//   and __ffs pick the lowest lane with one (start 0 alone, anchored),
//   whose lane walks the capture group (the greedy walk of the plan's
//   items) and broadcasts its bounds (__shfl_sync).
// - The output. The group copies the span to a staged output row and
//   stores it in 16-byte (or 8-byte, or byte) words with its length. The
//   clip is the JAX package's: where the span counts c >= width bytes,
//   the byte at width - 1 is byte c - 1 of it and the length counts all c.
// The three costs of the thread-a-row design it replaces: a warp's loads
// land in one row, not in 32 rows 128 B apart; a warp runs one row (or
// 2-8 short ones), so its lanes do not wait for the longest of 32 rows;
// and no lane copies bytes while another steps a match.
//
// delim_select keeps its thread-a-row design (Reader, kept occurrences
// left to right).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int kMaxWarps = 8;             // warps a block, regex_extract
constexpr int kStageBudget = 64 * 1024;  // its staging rows a block
constexpr int kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

// regex_kernels.py REGEX_HEADER: the program's header words
enum Header : int {
  kKind = 0,      // 0: a literal search, 1: an NFA
  kFlags = 1,     // kFlagStart | kFlagEnd | kFlagEndNewline
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
  kClasses = 16,  // byte classes
  kDfaStates = 17,  // span DFA states (0: none, the NFA's sets step)
  kDfaInit = 18,    // its start
  kDfaAccept = 19,  // its first accepting state (they are numbered last)
  kDfaAt = 20,      // ... of its transitions, uint8 [state * classes + class]
  kHeaderWords = 24,
};
constexpr uint32_t kFlagStart = 1;       // anchored at the start
constexpr uint32_t kFlagEnd = 2;         // anchored at the end
constexpr uint32_t kFlagEndNewline = 4;  // ... or just before a final '\n'
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

// A row's byte p: through a Reader, or where the row lies (staged in
// shared memory, or in global memory when it is too wide to stage).
__device__ __forceinline__ uint32_t byte_at(Reader& rd, int p) {
  return rd.at(p);
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* row, int p) {
  return row[p];
}

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

// A block's copy of the program, its header read into registers once. A
// row argument is a Reader or a pointer to the row's bytes (byte_at).
struct Program {
  uint32_t kind, flags, states, start, accept, segs, classes;
  uint32_t dfa_states, dfa_init, dfa_accept;
  const uint8_t* cls;
  const uint32_t* succ;
  const uint32_t* first;
  const uint32_t* items;
  const uint32_t* groups;
  const uint32_t* seg;
  const uint8_t* pool;
  const uint8_t* dfa;

  __device__ explicit Program(const uint32_t* w)
      : kind(w[kKind]),
        flags(w[kFlags]),
        states(w[kStates]),
        start(w[kStart]),
        accept(w[kAccept]),
        segs(w[kSegs]),
        classes(w[kClasses]),
        dfa_states(w[kDfaStates]),
        dfa_init(w[kDfaInit]),
        dfa_accept(w[kDfaAccept]),
        cls(reinterpret_cast<const uint8_t*>(w + w[kClassAt])),
        succ(w + w[kSuccAt]),
        first(w + w[kFirstAt]),
        items(w + w[kItemAt]),
        groups(w + w[kGroupAt]),
        seg(w + w[kSegAt]),
        pool(reinterpret_cast<const uint8_t*>(w + w[kPoolAt])),
        dfa(reinterpret_cast<const uint8_t*>(w + w[kDfaAt])) {}

  // whether byte b can begin a match: most starts end here
  __device__ __forceinline__ bool may_start(uint32_t b) const {
    return ((first[b >> 5] >> (b & 31)) & 1) != 0;
  }

  // Where else than the row's end an end-anchored match may stop: before
  // a final '\n' under a regex `$`, else -1.
  template <class Row>
  __device__ __forceinline__ int alt_end(Row& row, int len) const {
    return (flags & kFlagEndNewline) != 0 && len > 0 &&
                   byte_at(row, len - 1) == '\n'
               ? len - 1
               : -1;
  }

  // The end (exclusive) of the longest match from start j, or -1; byte j
  // passed may_start (a literal's first byte is its search's); `alt` as
  // alt_end gives it.
  template <class Row>
  __device__ int longest_from(Row& row, int j, int len, int alt) const {
    if (kind == 0) {
      const int n = static_cast<int>(states);
      if (j + n > len) return -1;
      for (int k = 1; k < n; ++k)
        if (byte_at(row, j + k) != pool[k]) return -1;
      return j + n;
    }
    const bool end = (flags & kFlagEnd) != 0;
    int e = -1;
    if (dfa_states != 0) {
      uint32_t s = dfa_init;
      for (int p = j; p < len; ++p) {
        s = dfa[s * classes + cls[byte_at(row, p)]];
        if (s == 0) break;
        if (s >= dfa_accept && (!end || p + 1 == len || p + 1 == alt))
          e = p + 1;
      }
      return e;
    }
    uint32_t active = start;
    for (int p = j; p < len && active != 0; ++p) {
      const uint32_t* next_of = succ + cls[byte_at(row, p)] * states;
      uint32_t next = 0;
      for (uint32_t a = active; a != 0; a &= a - 1)
        next |= next_of[__ffs(a) - 1];
      active = next;
      if ((active & accept) != 0 && (!end || p + 1 == len || p + 1 == alt))
        e = p + 1;
    }
    return e;
  }

  // Group g's bounds for a match from `at`: the greedy walk of the plan's
  // items up to the group's end item (each item takes the run of member
  // bytes within the length, capped at hi; lo is never checked, as in the
  // JAX package).
  template <class Row>
  __device__ void group_bounds(Row& row, int len, int at, int g, int* gs,
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
      while (pos + take < len &&
             (hi == kNoHi || take < static_cast<int>(hi))) {
        const uint32_t b = byte_at(row, pos + take);
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
  __device__ void emit(Reader& rd, Writer<W>& wr, int j, int e,
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
      for (int p = gs; p < ge; ++p) wr.put(rd.at(p));
    }
  }
};

__device__ __forceinline__ int program_words_aligned(int words) {
  return (words + 3) & ~3;
}

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
  extern __shared__ __align__(16) uint32_t smem[];
  load_program(smem, prog_g, words);
  const Program prog(smem);
  const bool anchored = (prog.flags & kFlagStart) != 0;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int len = row_length(lengths, r, width);
    Reader rd(data + r * stride);
    Writer<W> wr(out + r * out_w, static_cast<int>(out_w));
    const int alt = prog.alt_end(rd, len);
    int j = 0;
    while (j < len) {
      const uint32_t b = rd.at(j);
      const int e = (!anchored || j == 0) && prog.may_start(b)
                        ? prog.longest_from(rd, j, len, alt)
                        : -1;
      if (e >= 0) {
        prog.emit(rd, wr, j, e, len);
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

// One group of G lanes (lane gl of it) copies the 16-byte pieces holding
// the first `len` bytes of `row` into `stage` (16-byte aligned), the row
// keeping its offset within a piece; -> the staged row's byte 0.
template <int G>
__device__ __forceinline__ const uint8_t* stage_row(uint8_t* stage,
                                                    const uint8_t* row,
                                                    int len, int gl) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  const int m = static_cast<int>(a & 15);
  const int pieces = len > 0 ? (m + len + 15) >> 4 : 0;
  for (int q = gl; q < pieces; q += G) {
    *reinterpret_cast<uint4*>(stage + 16 * q) =
        load16((a & ~uintptr_t{15}) + 16 * static_cast<uintptr_t>(q));
  }
  return stage + m;
}

// The largest v over the warp's groups (a group of 32: its own).
template <int G>
__device__ __forceinline__ int warp_max(int v) {
  for (int o = G; o < 32; o <<= 1) {
    const int u = __shfl_xor_sync(kFull, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// x with its bytes at or past k (0..4) made 0
__device__ __forceinline__ uint32_t keep_low(uint32_t x, int k) {
  return k <= 0 ? 0u : k >= 4 ? x : x & ((1u << (8 * k)) - 1);
}

// The group stores a row of out_w bytes in W-byte words: bytes [0, keep)
// from `src` (a staged row for W > 1), zero up to out_w - 1, `top` at
// out_w - 1.
template <int G, int W>
__device__ __forceinline__ void store_row(const uint8_t* src, uint8_t* dst,
                                          int out_w, int keep, uint32_t top,
                                          int gl) {
  if (W == 16) {
    for (int q = gl; q < out_w / 16; q += G) {
      uint4 v = *reinterpret_cast<const uint4*>(src + 16 * q);
      const int k = keep - 16 * q;
      v.x = keep_low(v.x, k);
      v.y = keep_low(v.y, k - 4);
      v.z = keep_low(v.z, k - 8);
      v.w = keep_low(v.w, k - 12);
      if (16 * q + 16 == out_w) v.w = (v.w & 0x00FFFFFFu) | top << 24;
      *reinterpret_cast<uint4*>(dst + 16 * q) = v;
    }
  } else if (W == 8) {
    for (int q = gl; q < out_w / 8; q += G) {
      uint2 v = *reinterpret_cast<const uint2*>(src + 8 * q);
      const int k = keep - 8 * q;
      v.x = keep_low(v.x, k);
      v.y = keep_low(v.y, k - 4);
      if (8 * q + 8 == out_w) v.y = (v.y & 0x00FFFFFFu) | top << 24;
      *reinterpret_cast<uint2*>(dst + 8 * q) = v;
    }
  } else {
    for (int i = gl; i < out_w; i += G) {
      dst[i] = static_cast<uint8_t>(i < keep ? src[i]
                                    : i == out_w - 1 ? top : 0u);
    }
  }
}

// The starts a lane owns in a chunk: 4 in a narrow group (a short row in
// one chunk), 1 in a warp a row (a chunk of 32 starts stops near the first
// match; measured in PERF.md).
template <int G>
constexpr int kStartsALane = G < 32 ? 4 : 1;

// Where a group's staging rows lie: after the program, (in_slot +
// out_slot) bytes a group, the groups of a warp side by side.
struct Staging {
  uint8_t* in;
  uint8_t* out;
};

template <int G>
__device__ __forceinline__ Staging staging(uint32_t* smem, int words,
                                           int in_slot, int out_slot) {
  constexpr int R = 32 / G;
  const int slot = (threadIdx.x >> 5) * R + (threadIdx.x & 31) / G;
  uint8_t* base =
      reinterpret_cast<uint8_t*>(smem + program_words_aligned(words)) +
      static_cast<int64_t>(slot) * (in_slot + out_slot);
  return {base, base + in_slot};
}

// kStage: the group's row and output staged in shared memory; else the
// row read where it lies and the output stored a byte at a time (W = 1).
template <int G, int W, bool kStage>
__global__ void __launch_bounds__(32 * kMaxWarps)
    regex_extract_kernel(const uint8_t* __restrict__ data, int64_t stride,
                         int width, const int32_t* __restrict__ lengths,
                         int64_t n, const uint32_t* __restrict__ prog_g,
                         int words, int group, uint8_t* __restrict__ out,
                         int32_t* __restrict__ out_len, int in_slot,
                         int out_slot) {
  extern __shared__ __align__(16) uint32_t smem[];
  load_program(smem, prog_g, words);
  const Program prog(smem);
  constexpr int R = 32 / G;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, gl = lane % G;
  const unsigned gmask = (G == 32 ? kFull : (1u << G) - 1) << (grp * G);
  const Staging st = staging<G>(smem, words, in_slot, out_slot);
  const int starts = (prog.flags & kFlagStart) != 0 ? 1 : width;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t r0 = (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5)) * R;
       r0 < n; r0 += warps * R) {
    const int64_t r = r0 + grp;
    const bool live = r < n;
    const int len = live ? row_length(lengths, r, width) : 0;
    const uint8_t* src = data + (live ? r : r0) * stride;
    const uint8_t* row = kStage ? stage_row<G>(st.in, src, len, gl) : src;
    __syncwarp();
    const int alt = prog.alt_end(row, len);
    const int ends = len < starts ? len : starts;   // starts to try
    const int longest = warp_max<G>(ends);
    constexpr int spl = kStartsALane<G>;
    int gs = 0, ge = 0;
    bool done = false;
    for (int base = 0; base < longest; base += spl * G) {
      // this lane's first start with a match
      int first = -1, fe = -1;
      if (!done) {
        const int p0 = base + spl * gl;
        for (int j = p0; j < p0 + spl && j < ends && first < 0; ++j) {
          if (!prog.may_start(row[j])) continue;
          const int e = prog.longest_from(row, j, len, alt);
          if (e >= 0) {
            first = j;
            fe = e;
          }
        }
      }
      const unsigned mine = __ballot_sync(kFull, first >= 0) & gmask;
      const int s = mine != 0 ? __ffs(mine) - 1 - grp * G : 0;
      int my_gs = first, my_ge = fe;
      if (mine != 0 && gl == s && group != 0)
        prog.group_bounds(row, len, first, group, &my_gs, &my_ge);
      const int sel_gs = __shfl_sync(kFull, my_gs, s, G);
      const int sel_ge = __shfl_sync(kFull, my_ge, s, G);
      if (mine != 0) {
        gs = sel_gs;
        ge = sel_ge;
        done = true;
      }
      if (__ballot_sync(kFull, !done) == 0) break;
    }
    const int glen = ge > gs ? ge - gs : 0;
    if (kStage) {
      for (int k = gl; k < glen; k += G) st.out[k] = row[gs + k];
      __syncwarp();
    }
    if (live) {
      const int keep = glen < width - 1 ? glen : width - 1;
      const uint32_t top = glen >= width ? row[gs + glen - 1] : 0u;
      uint8_t* dst = out + r * static_cast<int64_t>(width);
      if (kStage) {
        store_row<G, W>(st.out, dst, width, keep, top, gl);
      } else {
        store_row<G, 1>(row + gs, dst, width, keep, top, gl);
      }
      if (gl == 0) out_len[r] = glen;
    }
    __syncwarp();
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

// the blocks of a grid-stride loop over n rows, `rows` a block
int blocks_of(int64_t n, int64_t rows) {
  const int64_t b = (n + rows - 1) / rows;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

int blocks_for(int64_t n) { return blocks_of(n, kThreads); }

// the widest word the output rows take: 16 or 8 bytes when the width and
// the base allow it, else bytes
int word_of(const void* out, int64_t out_w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  if (out_w % 16 == 0 && a % 16 == 0) return 16;
  if (out_w % 8 == 0 && a % 8 == 0) return 8;
  return 1;
}

// The dynamic shared memory of a kernel: `bytes`, -1 past what a block
// may have.
template <class K>
int shared_for(K kernel, int64_t bytes) {
  if (bytes > kSmemMax) return -1;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess)
    return -1;
  return static_cast<int>(bytes);
}

int64_t program_bytes(int32_t words) {
  return 4 * static_cast<int64_t>((words + 3) & ~3);
}

template <int W>
int launch_replace(const uint8_t* data, int64_t stride, int32_t width,
                   const int32_t* lengths, int64_t n, const uint32_t* prog,
                   int32_t words, int32_t out_w, uint8_t* out,
                   int32_t* out_len, cudaStream_t stream) {
  const int smem = shared_for(regex_replace_kernel<W>, program_bytes(words));
  if (smem < 0) return cudaErrorInvalidValue;
  regex_replace_kernel<W><<<blocks_for(n), kThreads, smem, stream>>>(
      data, stride, width, lengths, n, prog, words, out_w, out, out_len);
  return cudaGetLastError();
}

// regex_extract with G lanes a row: staged where a warp's rows and outputs
// fit shared memory beside the program (as many warps as kStageBudget
// holds, at most kMaxWarps), else (only a warp a row: a row past about
// 116 KB) read where they lie.
template <int G, int W>
int launch_extract(const uint8_t* data, int64_t stride, int32_t width,
                   const int32_t* lengths, int64_t n, const uint32_t* prog,
                   int32_t words, int32_t group, uint8_t* out,
                   int32_t* out_len, cudaStream_t stream) {
  constexpr int R = 32 / G;
  const int in_slot = (width + 30) & ~15;  // a row at any offset in a piece
  const int out_slot = (width + 15) & ~15;
  const int64_t warp_bytes = static_cast<int64_t>(R) * (in_slot + out_slot);
  int64_t warps = kStageBudget / warp_bytes;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int64_t staged = program_bytes(words) + warps * warp_bytes;
  if constexpr (G == 32) {
    if (staged > kSmemMax) {
      const int blocks = blocks_of(n, kMaxWarps);
      const int smem = shared_for(regex_extract_kernel<32, 1, false>,
                                  program_bytes(words));
      if (smem < 0) return cudaErrorInvalidValue;
      regex_extract_kernel<32, 1, false><<<blocks, 32 * kMaxWarps, smem,
                                           stream>>>(
          data, stride, width, lengths, n, prog, words, group, out, out_len,
          0, 0);
      return cudaGetLastError();
    }
  }
  const int blocks = blocks_of(n, warps * R);
  const int smem = shared_for(regex_extract_kernel<G, W, true>, staged);
  if (smem < 0) return cudaErrorInvalidValue;
  regex_extract_kernel<G, W, true><<<blocks, 32 * static_cast<int>(warps),
                                     smem, stream>>>(
      data, stride, width, lengths, n, prog, words, group, out, out_len,
      in_slot, out_slot);
  return cudaGetLastError();
}

// The lanes a row: a group of 4, 8 or 16 lanes for a matrix of at most
// 16, 32 or 64 bytes (8, 4 or 2 rows a warp, 4 starts a lane), else the
// warp (a start a lane).
template <int W>
int extract_for_word(const uint8_t* data, int64_t stride, int32_t width,
                     const int32_t* lengths, int64_t n, const uint32_t* prog,
                     int32_t words, int32_t group, uint8_t* out,
                     int32_t* out_len, cudaStream_t stream) {
  if (width <= 16)
    return launch_extract<4, W>(data, stride, width, lengths, n, prog, words,
                                group, out, out_len, stream);
  if (width <= 32)
    return launch_extract<8, W>(data, stride, width, lengths, n, prog, words,
                                group, out, out_len, stream);
  if (width <= 64)
    return launch_extract<16, W>(data, stride, width, lengths, n, prog,
                                 words, group, out, out_len, stream);
  return launch_extract<32, W>(data, stride, width, lengths, n, prog, words,
                               group, out, out_len, stream);
}

bool program_ok(const uint32_t* prog, int32_t words) {
  return prog != nullptr && words >= kHeaderWords;
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
      return extract_for_word<16>(data, stride, width, lengths, n, prog,
                                  words, group, out, out_len, stream);
    case 8:
      return extract_for_word<8>(data, stride, width, lengths, n, prog, words,
                                 group, out, out_len, stream);
    default:
      return extract_for_word<1>(data, stride, width, lengths, n, prog, words,
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
