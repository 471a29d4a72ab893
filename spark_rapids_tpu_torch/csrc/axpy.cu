// Elementwise out[i] = a[i] * x[i] + y[i] over float32, for sm_90a.
//
// Replaces the Pallas kernel spark_rapids_tpu/udf/examples.py:101
// _axpy_kernel (launched by _pallas_axpy_device, wrapped as the pallas_axpy
// columnar UDF). On the TPU it is one block over the whole batch; here a
// grid-stride loop of scalar loads covers any n.
//
// Bound: memory. Each element reads three floats and writes one, 16 bytes
// for 2 flops, far below the card's ~20 flop/byte balance point, so the
// least time is 16 * n bytes over the 3.35 TB/s of device memory. This is
// the simple first version: coalesced 4-byte accesses, no vector loads.
//
// The explicit round-to-nearest intrinsics forbid contracting the multiply
// and add into one FMA, so the result matches the plain version (two torch
// ops, each rounded) and the host engine's numpy twin bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// enough resident blocks to cover the card's 132 SMs several times over;
// the grid-stride loop takes whatever is left
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void axpy_f32_kernel(const float* __restrict__ a,
                                const float* __restrict__ x,
                                const float* __restrict__ y,
                                float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = __fadd_rn(__fmul_rn(a[i], x[i]), y[i]);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// n must be > 0: a grid of 0 blocks is an invalid launch configuration.
extern "C" int srt_axpy_f32(const float* a, const float* x, const float* y,
                            float* out, int64_t n, void* stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  axpy_f32_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, x, y, out, n);
  return static_cast<int>(cudaGetLastError());
}
