// Int8 stochastic-rounding round-trip of every leaf of one payload:
//   s = max(max|x|, 1e-12) / 127                      (per leaf)
//   q = x / s;  lo = floor(q);  out = clip(lo + (u < q - lo), -127, 127) * s
//
// Replaces the TPU kernel src/repro/kernels/codec_ops.py:int8_roundtrip
// (_int8_kernel) and the per-tensor scale its caller computes
// (repro/kernels/ref.py:int8_scale).  The uniforms u are drawn by the
// caller, one torch.rand a leaf (repro_torch.kernels.ops.int8_uniforms).
//
// Bound on the H100: device-memory bandwidth.  It reads x and u and writes
// out once, 12 bytes per element for ~8 flops: a (g, Gamma) payload of the
// F-MNIST CNN (16 leaves, 413,844 elements) moves 5.0 MB, ~1.5 us at
// 3.35 TB/s.  A launch a leaf, with the scale from five more small ops a
// leaf, made the payload launch-bound instead.
//
// Design: all leaves of a payload in two launches.  The leaves' x, u and
// out pointers, their sizes and each leaf's first block travel as a table in
// the kernel parameters (a __grid_constant__ LeafTable filled from host
// arrays), so no copy of the table to the device precedes the launch.  A
// leaf of size n takes ceil(n / kBlockElems) blocks; a block finds its leaf
// by a binary search of the table.
//   1. int8_amax: each block writes the maximum of |x| over its elements as
//      a uint32 bit pattern.  Non-negative floats order like their bits, so
//      the maximum is exact whatever the order; a NaN (bits above +inf's)
//      wins, as torch.amax propagates it.
//   2. int8_apply: each block reduces its leaf's partials, takes the scale
//      as ref.int8_scale does (a NaN maximum stays NaN), writes out for its
//      elements, and the leaf's first block writes the scale.
// The result must be bit-identical to the plain PyTorch version given the
// same x and u, so every step is correctly rounded: __fdiv_rn for the
// scale and the quotient (not a multiply by the reciprocal), floorf, a
// plain compare, the _rn intrinsics for the add, subtract and final
// multiply, and a clip that lets NaN through as torch.clamp does; the file
// is also compiled with -fmad=false so nothing is contracted into an FMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kBlockElems = kThreads * kItems;  // INT8_BLOCK (kernels/codec_ops.py)
constexpr int kMaxLeaves = 64;                  // INT8_MAX_LEAVES
constexpr unsigned int kAbs = 0x7fffffffu;

struct LeafTable {
  const float* x[kMaxLeaves];
  const float* u[kMaxLeaves];
  float* out[kMaxLeaves];
  int64_t size[kMaxLeaves];
  int first[kMaxLeaves + 1];  // each leaf's first block; first[n_leaves] = the grid
  int n_leaves;
};

__device__ __forceinline__ int leaf_of(const LeafTable& t, int block) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= block)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// the block's maximum, in every thread; contains __syncthreads
__device__ __forceinline__ unsigned int block_max(unsigned int v) {
  __shared__ unsigned int warp_max[kThreads / 32];
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned int m = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
  return m;
}

__global__ void __launch_bounds__(kThreads)
    int8_amax(const __grid_constant__ LeafTable t, unsigned int* __restrict__ partial) {
  const int l = leaf_of(t, blockIdx.x);
  const float* __restrict__ x = t.x[l];
  const int64_t n = t.size[l];
  const int64_t base = static_cast<int64_t>(blockIdx.x - t.first[l]) * kBlockElems + threadIdx.x;
  unsigned int m = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads;
    if (i < n) m = max(m, __float_as_uint(x[i]) & kAbs);
  }
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__global__ void __launch_bounds__(kThreads)
    int8_apply(const __grid_constant__ LeafTable t, const unsigned int* __restrict__ partial,
               float* __restrict__ scales) {
  const int l = leaf_of(t, blockIdx.x);
  const int first = t.first[l];
  unsigned int m = 0;
  for (int p = first + threadIdx.x; p < t.first[l + 1]; p += kThreads) m = max(m, partial[p]);
  const float amax = __uint_as_float(block_max(m));
  // ref.int8_scale: clamp_min(amax, 1e-12) / 127, NaN kept
  const float s = amax != amax ? amax : __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
  if (blockIdx.x == first && threadIdx.x == 0) scales[l] = s;
  const float* __restrict__ x = t.x[l];
  const float* __restrict__ u = t.u[l];
  float* __restrict__ out = t.out[l];
  const int64_t n = t.size[l];
  const int64_t base = static_cast<int64_t>(blockIdx.x - first) * kBlockElems + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads;
    if (i >= n) break;
    const float q = __fdiv_rn(x[i], s);
    const float lo = floorf(q);
    const float up = u[i] < __fsub_rn(q, lo) ? 1.f : 0.f;
    const float r = __fadd_rn(lo, up);
    const float rnd = r != r ? r : fminf(fmaxf(r, -127.f), 127.f);
    out[i] = __fmul_rn(rnd, s);
  }
}

}  // namespace

// One launch pair over n_leaves (1..64) leaves.  x, u, out: n_leaves device
// addresses of contiguous f32 leaves, sizes[i] >= 1 elements each; first:
// n_leaves + 1 ints, first[0] = 0 and first[i + 1] = first[i] +
// ceil(sizes[i] / kBlockElems) (kernels/codec_ops.py: int8_leaf_table);
// partial: first[n_leaves] uint32 of device scratch; scales: n_leaves f32 on
// the device.  Returns a cudaError_t code.
extern "C" int int8_roundtrip_leaves(const int64_t* x, const int64_t* u, const int64_t* out,
                                     const int64_t* sizes, const int* first, int n_leaves,
                                     void* partial, void* scales, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || first[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable t = {};
  t.n_leaves = n_leaves;
  for (int i = 0; i < n_leaves; ++i) {
    if (sizes[i] < 1 ||
        first[i + 1] - first[i] != (sizes[i] + kBlockElems - 1) / kBlockElems)
      return static_cast<int>(cudaErrorInvalidValue);
    t.x[i] = reinterpret_cast<const float*>(x[i]);
    t.u[i] = reinterpret_cast<const float*>(u[i]);
    t.out[i] = reinterpret_cast<float*>(out[i]);
    t.size[i] = sizes[i];
    t.first[i] = first[i];
  }
  t.first[n_leaves] = first[n_leaves];
  const unsigned int grid = static_cast<unsigned int>(first[n_leaves]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* p = static_cast<unsigned int*>(partial);
  int8_amax<<<grid, kThreads, 0, s>>>(t, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_apply<<<grid, kThreads, 0, s>>>(t, p, static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}
