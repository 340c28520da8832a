// VL-BFGS Gram matrix: out = basis * basis^T for an (n, D) f32 basis
// [s_0..s_{m-1}, y_0..y_{m-1}, g], n = 2m+1 <= 64.
//
// Replaces the TPU kernel src/repro/kernels/vlbfgs.py:gram (_kernel), which
// walks D over a sequential grid and rank-updates one (n, n) accumulator on
// the MXU.
//
// Bound on the H100: device-memory bandwidth.  The function reads the
// basis once (n*D*4 bytes, ~17.4 MB at the main path's n = 21,
// D = 206,922: ~5 us at 3.35 TB/s) and does n(n+1)/2 * 2 flops per column
// (~96 MFLOP, ~1.4 us at the 67 TFLOP/s f32 rate outside the tensor cores).
//
// Design: a CUDA grid runs its blocks in parallel, so the TPU kernel's
// sequential accumulator becomes two stages.  Stage 1 splits D into
// chunks, one per block, with at least as many blocks as SMs wherever D
// has that many tiles.  A block stages (n, TILE) slabs of its chunk in
// shared memory (rows padded by one float so that threads reading
// neighbouring rows hit different banks) and each thread keeps the dot
// products of up to PAIRS_PER_THREAD upper-triangle pairs (i <= j) in
// registers across the chunk; the block writes its n(n+1)/2 partials.
// Stage 2 gives each pair one warp: lane l sums that pair's partials of
// blocks l, l+32, ... in order, a fixed shuffle tree adds the 32 lane sums,
// and lane 0 writes both mirrored entries.  No atomics, so the result is
// deterministic.  Partials are stored pair-major, so a warp's loads are
// coalesced.  Plain f32 FMAs on the CUDA cores, no TF32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GRAM_THREADS = 256;
constexpr int GRAM_TILE = 64;   // columns per staged slab (vlbfgs.py TILE)
constexpr int GRAM_MAX_N = 64;  // rows the kernel takes (vlbfgs.py MAX_N)
constexpr int GRAM_MAX_PAIRS = GRAM_MAX_N * (GRAM_MAX_N + 1) / 2;
constexpr int PAIRS_PER_THREAD = (GRAM_MAX_PAIRS + GRAM_THREADS - 1) / GRAM_THREADS;

// pair p of the row-major upper triangle of an n x n matrix -> (i, j), i <= j
__device__ __forceinline__ void pair_of(int p, int n, int* i, int* j) {
  int row = 0;
  while (p >= n - row) {
    p -= n - row;
    ++row;
  }
  *i = row;
  *j = row + p;
}

__global__ void gram_partial_kernel(const float* __restrict__ basis, float* __restrict__ partial,
                                    int n, int64_t D, int64_t chunk) {
  __shared__ float slab[GRAM_MAX_N][GRAM_TILE + 1];
  const int npairs = n * (n + 1) / 2;
  int pi[PAIRS_PER_THREAD], pj[PAIRS_PER_THREAD];
  float acc[PAIRS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < PAIRS_PER_THREAD; ++k) {
    const int p = threadIdx.x + k * GRAM_THREADS;
    pi[k] = 0;
    pj[k] = 0;
    if (p < npairs) pair_of(p, n, &pi[k], &pj[k]);
    acc[k] = 0.f;
  }
  const int64_t d_begin = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t d_end = d_begin + chunk < D ? d_begin + chunk : D;
  for (int64_t t0 = d_begin; t0 < d_end; t0 += GRAM_TILE) {
    const int64_t width = d_end - t0 < GRAM_TILE ? d_end - t0 : GRAM_TILE;
    for (int idx = threadIdx.x; idx < n * GRAM_TILE; idx += GRAM_THREADS) {
      const int r = idx / GRAM_TILE;
      const int c = idx % GRAM_TILE;
      slab[r][c] = c < width ? basis[static_cast<int64_t>(r) * D + t0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PAIRS_PER_THREAD; ++k) {
      if (threadIdx.x + k * GRAM_THREADS < npairs) {
        const float* a = slab[pi[k]];
        const float* b = slab[pj[k]];
        float s = 0.f;
#pragma unroll 8
        for (int c = 0; c < GRAM_TILE; ++c) s += a[c] * b[c];
        acc[k] += s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PAIRS_PER_THREAD; ++k) {
    const int p = threadIdx.x + k * GRAM_THREADS;
    if (p < npairs) partial[static_cast<int64_t>(p) * gridDim.x + blockIdx.x] = acc[k];
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int n, int64_t blocks) {
  const int npairs = n * (n + 1) / 2;
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= npairs) return;  // uniform across the warp
  const float* row = partial + static_cast<int64_t>(pair) * blocks;
  float s = 0.f;
  for (int64_t b = lane; b < blocks; b += 32) s += row[b];
  for (int offset = 16; offset > 0; offset >>= 1) s += __shfl_down_sync(0xffffffffu, s, offset);
  if (lane == 0) {
    int i, j;
    pair_of(pair, n, &i, &j);
    out[i * n + j] = s;
    out[j * n + i] = s;
  }
}

}  // namespace

extern "C" int vlbfgs_gram(const void* basis, void* partial, void* out, int64_t n, int64_t D,
                           int64_t chunk, int64_t blocks, void* stream) {
  if (n < 1 || n > GRAM_MAX_N || chunk % GRAM_TILE != 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n);
  gram_partial_kernel<<<static_cast<unsigned int>(blocks), GRAM_THREADS, 0, s>>>(
      static_cast<const float*>(basis), static_cast<float*>(partial), ni, D, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int npairs = ni * (ni + 1) / 2;
  const int reduce_blocks = (npairs * 32 + GRAM_THREADS - 1) / GRAM_THREADS;
  gram_reduce_kernel<<<reduce_blocks, GRAM_THREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), ni, blocks);
  return static_cast<int>(cudaGetLastError());
}
