// Bit-parallel NFA match over a padded string matrix, for sm_90a.
//
// Replaces the XLA scan of spark_rapids_tpu/expr/regex.py:459
// DeviceNfa.matches (a lax.scan over the byte columns of the (rows, width)
// string matrix, all rows in step). It is not a Pallas kernel: the JAX
// package leaves this loop to XLA, and as a loop of torch ops it would be
// one launch per byte column per batch. Here one thread walks one row.
//
// Semantics, exactly those of DeviceNfa.matches (Java Matcher.find()):
// - the state set of a row is a uint32 bitmask (state 0 = start); one step
//   per UTF-8 character: continuation bytes (b & 0xC0) == 0x80 and bytes at
//   or past the row's length leave it untouched;
// - step: next[t] = (active & masks[class_of_byte[b]][t]) != 0, plus the
//   start bit unless the pattern is anchored at the start;
// - unanchored at the end, a row matches once an accepting state is active
//   after any character; anchored at the end, only after its last
//   character (the lead byte with the largest index);
// - before any character a row matches iff the pattern is nullable (and,
//   for a non-empty row, not anchored at the end).
// A row stops early once its answer cannot change; the result is the same.
//
// Bound: memory. Each row reads its bytes once (w bytes of the matrix plus
// its 4-byte length) and writes one byte; the work per character is one
// table lookup and S AND/compare steps on a register, far below the card's
// integer rate. This first version is simple: one thread per row walks its
// row with byte loads, so a warp's loads are 32 rows apart (uncoalesced;
// the L1 cache serves the rest of each row's line). Tiling rows through
// shared memory so that a warp reads contiguous bytes is later work.
//
// The class table (256 int32) and the transition masks (classes x states
// uint32, at most 256 x 32) are staged in shared memory by each block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFlagAnchoredStart = 1;
constexpr int kFlagAnchoredEnd = 2;
constexpr int kFlagNullable = 4;

__global__ void nfa_match_kernel(const uint8_t* __restrict__ values,
                                 const int32_t* __restrict__ lengths,
                                 int64_t n, int32_t w,
                                 const int32_t* __restrict__ class_of_byte,
                                 const uint32_t* __restrict__ masks,
                                 int32_t n_classes, int32_t n_states,
                                 uint32_t start_bits, uint32_t accept_bits,
                                 int32_t flags, bool* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  int32_t* s_class = reinterpret_cast<int32_t*>(smem);   // 256
  uint32_t* s_masks = smem + 256;                        // classes * states
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_class[i] = class_of_byte[i];
  }
  const int n_masks = n_classes * n_states;
  for (int i = threadIdx.x; i < n_masks; i += blockDim.x) {
    s_masks[i] = masks[i];
  }
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;
  const bool anchored_start = flags & kFlagAnchoredStart;
  const bool anchored_end = flags & kFlagAnchoredEnd;
  const bool nullable = flags & kFlagNullable;
  const uint8_t* v = values + row * static_cast<int64_t>(w);
  int32_t len = lengths[row];
  if (len > w) len = w;
  if (len < 0) len = 0;

  bool matched = len == 0 ? nullable : (nullable && !anchored_end);
  // the lead byte of the row's last character (-1: none)
  int32_t last_lead = -1;
  if (anchored_end) {
    for (int32_t j = len - 1; j >= 0; --j) {
      if ((v[j] & 0xC0) != 0x80) {
        last_lead = j;
        break;
      }
    }
  }
  uint32_t active = start_bits;
  for (int32_t j = 0; j < len; ++j) {
    const uint8_t b = v[j];
    if ((b & 0xC0) == 0x80) continue;
    const uint32_t* m = s_masks + s_class[b] * n_states;
    uint32_t nxt = 0;
    for (int32_t t = 0; t < n_states; ++t) {
      nxt |= static_cast<uint32_t>((active & m[t]) != 0) << t;
    }
    if (!anchored_start) nxt |= start_bits;
    active = nxt;
    const bool done = (active & accept_bits) != 0;
    if (anchored_end) {
      if (j == last_lead) matched = matched || done;
    } else if (done) {
      matched = true;
      break;               // find(): the answer cannot change any more
    }
    if (anchored_start && active == 0) break;   // dead: nothing can match
  }
  out[row] = matched;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// n must be > 0; masks is (n_classes, n_states) row-major, n_states <= 32,
// n_classes <= 256.
extern "C" int srt_nfa_match(const uint8_t* values, const int32_t* lengths,
                             int64_t n, int32_t w,
                             const int32_t* class_of_byte,
                             const uint32_t* masks, int32_t n_classes,
                             int32_t n_states, uint32_t start_bits,
                             uint32_t accept_bits, int32_t flags, bool* out,
                             void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (256 + static_cast<size_t>(n_classes) * n_states) *
                      sizeof(uint32_t);
  nfa_match_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      values, lengths, n, w, class_of_byte, masks, n_classes, n_states,
      start_bits, accept_bits, flags, out);
  return static_cast<int>(cudaGetLastError());
}
