// find() of a byte-class NFA over a padded string matrix, for sm_90a.
//
// Replaces the XLA scan of spark_rapids_tpu/expr/regex.py:459
// DeviceNfa.matches (a lax.scan over the byte columns of the (rows, width)
// string matrix, all rows in step). It is not a Pallas kernel: the JAX
// package leaves this loop to XLA, and as a loop of torch ops it would be
// one launch per byte column per batch.
//
// Semantics, exactly those of DeviceNfa.matches (Java Matcher.find()), held
// bit-equal to nfa_match_reference (udf/kernels.py):
// - one step per UTF-8 character: continuation bytes (b & 0xC0) == 0x80
//   and bytes at or past the row's length leave the state untouched;
// - the start state is re-added on each step unless the pattern is
//   anchored at the start;
// - unanchored at the end, a row matches once an accepting state is active
//   after any character; anchored at the end, only after its last
//   character, which is the state after its last byte, since continuation
//   bytes change nothing;
// - an empty row matches iff the pattern is nullable; a non-empty one
//   before any character iff it is nullable and not anchored at the end;
// - a regex `$` (flag end_newline, never LIKE's end) also matches just
//   before a final '\n' that is the row's last character: the state before
//   that character accepts (or, nullable, the row is that '\n' alone).
//   The DFA path's tables tell such a row apart in their states (the
//   newline has a class of its own there); the NFA path carries the flag
//   `nl` beside its set.
//
// The host builds the tables once per pattern (nfa_kernel_tables in
// udf/kernels.py) and the kernel takes one of two paths:
// - DFA path (the subset construction, minimised, has at most
//   DFA_MAX_STATES = 64 states): a uint8 table T[state * 256 + byte] of the
//   next state, 256 bytes a state. Continuation bytes map every state to
//   itself, so the walk has no branch on UTF-8. A find() match (pattern
//   unanchored at the end) and the empty set (anchored at the start) are
//   sink states numbered last, so "the answer is settled" is one compare.
//   One step is two instructions: a byte permute (PRMT) that puts the byte
//   and the state side by side as the index state * 256 + byte, and one
//   shared-memory load (LDS.U8). Per 16 bytes add one LDS.128 of the row,
//   the sink compare and the loop; the first and last piece of a row are
//   masked. So about 2.3 instructions a byte, one of them a lookup. No
//   loop over NFA states remains.
// - NFA path (a larger DFA): the active set stays a uint32 and one step is
//   next = OR_k S[c][k][(active >> k * bits) & mask] over the 8-bit (or,
//   for tables past 64 KiB, 4-bit) chunks of the set, with c the byte's
//   class (continuation bytes in an identity class, the start bit folded
//   into chunk 0). Per byte: a permute and a load for the class, then per
//   chunk a shift, a mask, an index and a load, OR-ed together: 2 + 5 *
//   chunks instructions, 17 for 19 states.
//
// Staging. A block of 256 threads takes 256 consecutive rows, one thread a
// row: one flat byte range of the matrix. It copies into shared memory only
// the 16-byte pieces that each row's first `len` bytes touch, with
// cp.async.cg (16 bytes, L1 bypassed), consecutive threads on consecutive
// pieces of a row, so the loads coalesce. cp.async rather than TMA: a
// tensor map cannot describe a row stride that is not a multiple of 16
// bytes (w = 8) or a base that is not 16-byte aligned (a view), and a TMA
// box copies whole rows where a row needs only its length. Each row keeps
// its offset within a 16-byte piece (the view's alignment, or w = 8): the
// walk reads aligned pieces and turns the bytes outside the row into 0x80,
// a continuation byte, which steps nothing. A piece may hold bytes before
// the row or past the tensor's last byte; it never leaves the 16-byte
// granule of a byte the row owns. Threads take the block's rows longest
// first (a counting sort on the pieces), so that a warp, which walks until
// its longest row is done, holds rows of about one length. Only a row's
// first and last piece are masked; the pieces between are walked as read.
//
// Rows are read in chunks of C bytes (C = 32, 64 or 128 by the width).
// When the width exceeds C (up to 4096 and beyond) the chunks stream
// through a ring of two buffers: the copy of chunk k + 1 is in flight
// while chunk k is walked. A row whose answer is settled (a sink) asks for
// no chunk after the one already in flight.
//
// Bank conflicts: a row's slot in a buffer is C + 16 bytes (an odd number
// of 16-byte units), so the 8 threads of an LDS.128 phase, reading piece q
// of 8 rows in a row, hit 8 distinct 16-byte bank groups.
//
// Shared memory a block: the tables (DFA: 257 bytes a state, 4.4 KiB for
// Q13's LIKE with 17 states, 16.4 KiB at the cap; NFA: 0.5 KiB + classes *
// chunks KiB), 512 bytes of piece counts, 1.3 KiB of sort arrays, and
// buffers * 256 * (C + 16) bytes of rows: 36 KiB at w = 128 (one buffer),
// 20 KiB at w = 64, 72 KiB for w > 128 (two). Occupancy on the H100 (228
// KiB and 64K registers an SM): the launch bounds hold a thread to 48
// registers, so 5 blocks of 256 fit; Q13's LIKE at w = 128 takes 43 KiB a
// block, 5 blocks or 40 warps an SM, as at w = 64; a DFA at the cap at w =
// 128, 55 KiB, 4 blocks; past w = 128, 78 KiB, 2 blocks, 16 warps. Each
// character is a chain of dependent lookups, so these warps in flight are
// what hides the shared-memory latency.
//
// Bound: the bytes each row must read (its first `len` bytes, up to where
// its answer is settled), its length and its answer, over the card's
// memory rate; the lookups, one a byte on the shared-memory pipe (32 lanes
// a clock an SM), come to about a quarter of that at Q13's rows. Measured
// (PERF.md, nfa_match_limits.py), neither bounds it: the staging alone and
// the walk alone each take about twice and one and a half times the byte
// bound, and overlap only in part; a block's chain of latencies (lengths,
// sort, copy) against the warps an SM holds is what limits it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;               // rows, and threads, a block
constexpr int kFlagAnchoredStart = 1;
constexpr int kFlagAnchoredEnd = 2;
constexpr int kFlagNullable = 4;
constexpr int kFlagEndNewline = 8;

template <int C>
struct Chunk {
  static_assert(C % 16 == 0, "chunks are whole 16-byte pieces");
  // C + 16 bytes, plus 16 if that is an even number of 16-byte units
  static constexpr int kSlot = C + 16 + ((C / 16) % 2 == 1 ? 16 : 0);
  // pieces a chunk of a row touches at any alignment
  static constexpr int kPieces = C / 16 + 1;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes i of x with lo <= i < hi are kept; the others become 0x80, a UTF-8
// continuation byte, which leaves every state as it is.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t x, int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 4);
  uint32_t keep = 0;
  if (hi > lo) keep = (0xFFFFFFFFu >> (32 - 8 * (hi - lo))) << (8 * lo);
  return (x & keep) | (0x80808080u & ~keep);
}

// The 16 bytes of the piece at `p`, those outside [lo, hi) made 0x80.
__device__ __forceinline__ uint4 load_piece(const uint8_t* p, int lo,
                                            int hi) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  if (lo > 0 || hi < 16) {
    v.x = keep_bytes(v.x, lo, hi);
    v.y = keep_bytes(v.y, lo - 4, hi - 4);
    v.z = keep_bytes(v.z, lo - 8, hi - 8);
    v.w = keep_bytes(v.w, lo - 12, hi - 12);
  }
  return v;
}

// Four DFA steps: PRMT builds state * 256 + byte (state < 256), LDS.U8.
__device__ __forceinline__ uint32_t dfa_word(const uint8_t* tbl, uint32_t x,
                                             uint32_t s) {
  s = tbl[__byte_perm(x, s, 0x5540)];
  s = tbl[__byte_perm(x, s, 0x5541)];
  s = tbl[__byte_perm(x, s, 0x5542)];
  s = tbl[__byte_perm(x, s, 0x5543)];
  return s;
}

struct NfaState {
  uint32_t active;  // the state set
  uint32_t seen;    // every state active after some byte so far
  // end_newline: the last character was a '\n' read where the set before
  // accepted; at0: no character read yet (a nullable pattern's empty match)
  bool nl;
  bool at0;
};

// One NFA step on byte `sel` of x (sel = 0x4440 + byte index).
__device__ __forceinline__ void nfa_byte(const uint16_t* cls,
                                         const uint32_t* succ, uint32_t x,
                                         uint32_t sel, int bits, int chunks,
                                         uint32_t accept, bool end_nl,
                                         NfaState& st) {
  const uint32_t b = __byte_perm(x, 0, sel);
  const uint32_t c = cls[b];
  const uint32_t* t = succ + ((c * chunks) << bits);
  const uint32_t vmask = (1u << bits) - 1;
  uint32_t nxt = 0;
  for (int k = 0; k < chunks; ++k) {
    nxt |= t[(k << bits) + ((st.active >> (k * bits)) & vmask)];
  }
  if (end_nl && (b & 0xC0) != 0x80) {
    st.nl = b == '\n' && ((st.active & accept) != 0 || st.at0);
    st.at0 = false;
  }
  st.active = nxt;
  st.seen |= nxt;
}

__device__ __forceinline__ void nfa_word(const uint16_t* cls,
                                         const uint32_t* succ, uint32_t x,
                                         int bits, int chunks,
                                         uint32_t accept, bool end_nl,
                                         NfaState& st) {
  nfa_byte(cls, succ, x, 0x4440, bits, chunks, accept, end_nl, st);
  nfa_byte(cls, succ, x, 0x4441, bits, chunks, accept, end_nl, st);
  nfa_byte(cls, succ, x, 0x4442, bits, chunks, accept, end_nl, st);
  nfa_byte(cls, succ, x, 0x4443, bits, chunks, accept, end_nl, st);
}

struct Params {
  const uint8_t* values;
  const int32_t* lengths;
  int64_t n;
  int32_t w;
  const uint8_t* blob;
  int32_t blob_bytes;     // a multiple of 16
  // DFA path: the state; the accept flags, one a state, at accept_off
  uint32_t init_state;
  uint32_t sink_lo;
  int32_t accept_off;
  int32_t chunk_bits;     // NFA path
  int32_t n_chunks;
  uint32_t start_bits;
  uint32_t accept_bits;
  int32_t flags;
  bool* out;
};

// Issues the cp.async copies of chunk k of the block's rows into `buf`:
// counts[r] pieces of row r (0: none).
template <int C>
__device__ __forceinline__ void copy_chunk(uint8_t* buf, const Params& p,
                                           int64_t row0, int k,
                                           const uint8_t* counts) {
  constexpr int G = Chunk<C>::kPieces;
  for (int i = threadIdx.x; i < kRows * G; i += kRows) {
    const int r = i / G;
    const int q = i - r * G;
    if (q < counts[r]) {
      const uint8_t* src = p.values + (row0 + r) * static_cast<int64_t>(p.w) +
                           static_cast<int64_t>(k) * C;
      src -= reinterpret_cast<uintptr_t>(src) & 15;
      cp_async16(buf + r * Chunk<C>::kSlot + 16 * q, src + 16 * q);
    }
  }
}

template <int C, bool kDfa>
__global__ void __launch_bounds__(kRows, 5)
    nfa_match_kernel(const Params p, int n_buffers) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* counts = smem + p.blob_bytes;            // [2][kRows]
  uint8_t* rows = counts + 2 * kRows;               // [n_buffers][kRows][slot]
  constexpr int kBuf = kRows * Chunk<C>::kSlot;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  // Threads take the block's rows longest first, so that the 32 rows of a
  // warp need about as many 16-byte pieces each: a warp walks until its
  // longest row is done. A counting sort on the pieces (16 buckets).
  __shared__ int32_t s_len[kRows];
  __shared__ int32_t s_bucket[16];
  __shared__ uint8_t s_row[kRows];
  if (threadIdx.x < 16) s_bucket[threadIdx.x] = 0;
  {
    const int64_t mine = row0 + threadIdx.x;
    const int32_t l = mine < p.n ? min(max(p.lengths[mine], 0), p.w) : 0;
    s_len[threadIdx.x] = l;
    __syncthreads();
    const int off = static_cast<int>(
        reinterpret_cast<uintptr_t>(p.values + mine * p.w) & 15);
    const int key = 15 - min((off + l + 15) >> 4, 15);   // longest first
    const int at = atomicAdd(&s_bucket[key], 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int b = 0; b < 16; ++b) {
        const int c = s_bucket[b];
        s_bucket[b] = sum;
        sum += c;
      }
    }
    __syncthreads();
    s_row[s_bucket[key] + at] = static_cast<uint8_t>(threadIdx.x);
    __syncthreads();
  }
  const int r = s_row[threadIdx.x];                 // this thread's row
  const int64_t row = row0 + r;
  const int32_t len = s_len[r];
  const int m = static_cast<int>(
      reinterpret_cast<uintptr_t>(p.values + row * p.w) & 15);
  const bool anchored_start = p.flags & kFlagAnchoredStart;
  const bool anchored_end = p.flags & kFlagAnchoredEnd;
  const bool nullable = p.flags & kFlagNullable;
  const bool end_nl = p.flags & kFlagEndNewline;

  uint32_t s = p.init_state;                        // DFA path
  NfaState st{p.start_bits, 0u, false, nullable};   // NFA path
  // a non-empty row whose answer is known before its first byte reads none
  bool active = len > 0 && (kDfa ? s < p.sink_lo : !nullable || anchored_end);

  // the pieces of chunk k this row needs (0 once settled)
  auto pieces = [&](int k) -> int {
    const int lo = k * C;
    if (!active || len <= lo) return 0;
    return (m + min(C, len - lo) + 15) / 16;
  };

  for (int i = threadIdx.x; i < p.blob_bytes / 16; i += kRows) {
    cp_async16(smem + 16 * i, p.blob + 16 * i);
  }
  counts[r] = static_cast<uint8_t>(pieces(0));
  __syncthreads();
  copy_chunk<C>(rows, p, row0, 0, counts);
  cp_async_commit();

  const uint16_t* cls = reinterpret_cast<const uint16_t*>(smem);
  const uint32_t* succ = reinterpret_cast<const uint32_t*>(smem + 512);
  for (int k = 0;; ++k) {
    int next = 0;
    if (n_buffers == 2) {
      next = pieces(k + 1);
      counts[((k + 1) & 1) * kRows + r] = static_cast<uint8_t>(next);
    }
    // also the barrier after which buffer (k + 1) & 1, walked as chunk
    // k - 1, may be overwritten
    const bool any_next = __syncthreads_or(next > 0);
    if (any_next) {
      copy_chunk<C>(rows + ((k + 1) & 1) * kBuf, p, row0, k + 1,
                    counts + ((k + 1) & 1) * kRows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int lo = k * C;
    if (active && len > lo) {
      const uint8_t* slot =
          rows + (k & (n_buffers - 1)) * kBuf + r * Chunk<C>::kSlot;
      const int span = m + min(C, len - lo);        // row bytes: [m, span)
      // the first and the last piece are masked; the others are walked
      // as they are
      auto walk = [&](const uint4 v) -> bool {
        if (kDfa) {
          s = dfa_word(smem, v.x, s);
          s = dfa_word(smem, v.y, s);
          s = dfa_word(smem, v.z, s);
          s = dfa_word(smem, v.w, s);
          return s >= p.sink_lo;
        }
        nfa_word(cls, succ, v.x, p.chunk_bits, p.n_chunks, p.accept_bits,
                 end_nl, st);
        nfa_word(cls, succ, v.y, p.chunk_bits, p.n_chunks, p.accept_bits,
                 end_nl, st);
        nfa_word(cls, succ, v.z, p.chunk_bits, p.n_chunks, p.accept_bits,
                 end_nl, st);
        nfa_word(cls, succ, v.w, p.chunk_bits, p.n_chunks, p.accept_bits,
                 end_nl, st);
        return (!anchored_end && (st.seen & p.accept_bits)) ||
               (anchored_start && st.active == 0 && !st.nl);
      };
      const int last = (span - 1) >> 4;
      bool settled = walk(load_piece(slot, m, span));
      for (int q = 1; q < last && !settled; ++q) {
        settled = walk(*reinterpret_cast<const uint4*>(slot + 16 * q));
      }
      if (last > 0 && !settled) {
        settled = walk(load_piece(slot + 16 * last, m - 16 * last,
                                  span - 16 * last));
      }
      if (settled) active = false;
    }
    if (!any_next) break;
  }

  if (row >= p.n) return;
  bool matched;
  if (len == 0) {
    matched = nullable;
  } else if (kDfa) {
    matched = smem[p.accept_off + s] != 0;
  } else if (anchored_end) {
    matched = (st.active & p.accept_bits) != 0 || st.nl;
  } else {
    matched = nullable || (st.seen & p.accept_bits) != 0;
  }
  p.out[row] = matched;
}

template <int C, bool kDfa>
int launch(const Params& p, cudaStream_t stream) {
  // once a process: let the dynamic shared memory grow to the device's
  // opt-in limit (227 KiB on the H100) less the static arrays
  static const cudaError_t configured = [] {
    auto fn = nfa_match_kernel<C, kDfa>;
    int device = 0, optin = 0;
    cudaFuncAttributes attr{};
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(attr.sharedSizeBytes));
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int n_buffers = p.w > C ? 2 : 1;
  const size_t smem = static_cast<size_t>(p.blob_bytes) + 2 * kRows +
                      static_cast<size_t>(n_buffers) * kRows *
                          Chunk<C>::kSlot;
  const int64_t blocks = (p.n + kRows - 1) / kRows;
  nfa_match_kernel<C, kDfa>
      <<<static_cast<unsigned int>(blocks), kRows, smem, stream>>>(
          p, n_buffers);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDfa>
int launch_width(const Params& p, cudaStream_t stream) {
  if (p.w <= 32) return launch<32, kDfa>(p, stream);
  if (p.w <= 64) return launch<64, kDfa>(p, stream);
  return launch<128, kDfa>(p, stream);
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 = launched). n > 0;
// `blob` (blob_bytes, a multiple of 16, 16-byte aligned) holds the tables
// of nfa_kernel_tables: dfa != 0 for the DFA path (init_state, sink_lo,
// accept_off), else the NFA path (chunk_bits, n_chunks).
extern "C" int srt_nfa_match(const uint8_t* values, const int32_t* lengths,
                             int64_t n, int32_t w, const uint8_t* blob,
                             int32_t blob_bytes, int32_t dfa,
                             uint32_t init_state, uint32_t sink_lo,
                             int32_t accept_off, int32_t chunk_bits,
                             int32_t n_chunks, uint32_t start_bits,
                             uint32_t accept_bits, int32_t flags, bool* out,
                             void* stream) {
  const Params p{values,     lengths,     n,          w,
                 blob,       blob_bytes,  init_state, sink_lo,
                 accept_off, chunk_bits,  n_chunks,   start_bits,
                 accept_bits, flags,      out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dfa ? launch_width<true>(p, s) : launch_width<false>(p, s);
}
