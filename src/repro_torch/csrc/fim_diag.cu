// Fused diagonal-Fisher update: out[d] = ema*old[d] + (1-ema) * mean_b g[b,d]^2.
//
// Replaces the TPU kernel src/repro/kernels/fim_diag.py:fim_diag (_kernel),
// which tiles (B_BLK, D_BLK) through VMEM and reduces the batch over a
// sequential grid axis.
//
// Bound on the H100: device-memory bandwidth.  The function reads the
// (B, D) gradient matrix once and does 2 flops per element read (0.5 flop
// per byte in f32), far below the card's ~20 flops/byte balance point in
// f32; at the main path's (600, 200704) f32 the read is ~0.48 GB, ~0.14 ms
// at 3.35 TB/s.
//
// Design: a block owns kCols neighbouring columns and splits the batch
// over kRows row-slices: thread (x, y) sums g[b, d]^2 for b = y, y+kRows,
// ... of column d = blockIdx.x*kCols + x.  A warp is one row-slice over 32
// neighbouring columns, so each of its loads is one coalesced 128-byte line
// (f32); four independent loads per iteration keep bytes in flight.
// Splitting the batch keeps narrow leaves (D = 10..4608 on the main path)
// from running as one warp walking all B rows serially.  The kRows partial
// sums of a column are then added in a fixed order through shared memory,
// so the result is deterministic and needs no atomics or second launch.
// bf16 inputs are widened with __bfloat162float.  The TPU kernel's
// sequential batch grid axis becomes the in-block row split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns per block (one warp wide)
constexpr int kRows = 16;   // row-slices per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void fim_diag_kernel(const T* __restrict__ g, const float* __restrict__ old,
                                float* __restrict__ out, int64_t B, int64_t D, float ema) {
  __shared__ float part[kRows][kCols + 1];
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x;
  float acc = 0.f;
  if (d < D) {
    const T* col = g + d;
    int64_t b = threadIdx.y;
    for (; b + 3 * kRows < B; b += 4 * kRows) {
      const float v0 = to_f32(col[(b + 0 * kRows) * D]);
      const float v1 = to_f32(col[(b + 1 * kRows) * D]);
      const float v2 = to_f32(col[(b + 2 * kRows) * D]);
      const float v3 = to_f32(col[(b + 3 * kRows) * D]);
      acc += v0 * v0;
      acc += v1 * v1;
      acc += v2 * v2;
      acc += v3 * v3;
    }
    for (; b < B; b += kRows) {
      const float v = to_f32(col[b * D]);
      acc += v * v;
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && d < D) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += part[r][threadIdx.x];
    out[d] = ema * old[d] + (1.f - ema) * (s / static_cast<float>(B));
  }
}

template <typename T>
int launch(const void* g, const void* old, void* out, int64_t B, int64_t D, float ema,
           void* stream) {
  const int64_t blocks = (D + kCols - 1) / kCols;
  fim_diag_kernel<T><<<static_cast<unsigned int>(blocks), dim3(kCols, kRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const float*>(old), static_cast<float*>(out), B, D,
      ema);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fim_diag_f32(const void* g, const void* old, void* out, int64_t B, int64_t D,
                            float ema, void* stream) {
  return launch<float>(g, old, out, B, D, ema, stream);
}

extern "C" int fim_diag_bf16(const void* g, const void* old, void* out, int64_t B, int64_t D,
                             float ema, void* stream) {
  return launch<__nv_bfloat16>(g, old, out, B, D, ema, stream);
}
