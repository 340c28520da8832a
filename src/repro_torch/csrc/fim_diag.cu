// Fused diagonal-Fisher update of every leaf of one client in one launch:
//   out_i[d] = ema*old_i[d] + (1-ema) * mean_b g_i[b,d]^2   for each (B, D_i) leaf i,
// with old_i = 0 (and then out_i = (1-ema) * mean_b g_i^2) where a leaf has no old.
//
// Replaces the TPU kernel src/repro/kernels/fim_diag.py:fim_diag (_kernel),
// which tiles one (B, D) matrix (B_BLK, D_BLK) through VMEM and reduces the
// batch over a sequential grid axis; its callers run it once a leaf.
//
// Bound on the H100: device-memory bandwidth.  The function reads each
// gradient matrix once and does 2 flops per element read (0.5 flop per byte
// in f32), far below the card's ~20 flops/byte balance point in f32; a client
// of the F-MNIST CNN at B = 600 reads 600 x 206,922 f32 (496.6 MB), ~0.148 ms
// at 3.35 TB/s.  A launch a leaf made its 7 narrow leaves (D = 10 .. 4,608)
// launch-bound at ~4.5 us each, for ~0.3 us of bytes.
//
// Design: all leaves of a client in one launch.  The leaves' gradient, old and
// out pointers, their widths, each leaf's first block and its block shape
// travel as a table in the kernel parameters (a __grid_constant__ LeafTable
// filled from host arrays, as csrc/codec_ops.cu does), so no copy of the table
// precedes the launch; a block finds its leaf by a binary search of the first
// blocks.  The host lists the leaves widest first, so the narrow leaves' blocks
// fill the SMs that the wide leaf's last wave leaves idle.
//   A block of 256 threads owns 2^shift column groups of kVec columns (kVec =
// 16 bytes: 4 f32 or 8 bf16) and splits the batch over 256 >> shift row
// slices: thread (slice, group) sums g[b, c..c+kVec)^2 over b = slice,
// slice + rows, ... in increasing b.  A narrow leaf takes few groups and many
// slices, the wide leaf 16 groups (64 f32 columns) and 16 slices, so a warp
// reads two 256-byte row segments a load and the wide leaf gets 3,136 blocks
// (~24 an SM).  Where every row of a thread's columns starts on a 16-byte
// boundary (the leaf's base and its row stride D * sizeof(T) both multiples of
// 16) it issues 16-byte streaming loads, four rows in flight; elsewhere it
// checks each row's address and falls back to scalar loads at a misaligned row
// start (a (B, 10) f32 leaf's odd rows start 8 bytes off), so no alignment is
// assumed for a leaf.  The slices' partial sums of a column are then added in
// slice order through shared memory: a fixed order, no atomics, so the result
// is deterministic.  The TPU kernel's sequential batch axis becomes the in-block
// row split; bf16 is widened exactly (a shift into the high half of an f32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // THREADS (kernels/fim_diag.py)
constexpr int kMaxLeaves = 64;  // MAX_LEAVES (kernels/fim_diag.py)

struct LeafTable {
  const void* g[kMaxLeaves];     // (B, cols) row-major, T
  const float* old[kMaxLeaves];  // (cols,) or nullptr for zeros
  float* out[kMaxLeaves];        // (cols,)
  int64_t cols[kMaxLeaves];
  int first[kMaxLeaves + 1];  // each leaf's first block; first[n_leaves] = the grid
  int shift[kMaxLeaves];      // log2 of the column groups a block of the leaf
  int n_leaves;
};

// 16 bytes of T: the vector a thread loads from one row
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[kN]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[kN]) {
    const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half (little-endian)
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// row[c0 .. c0+kN) as f32, zeros past D: one 16-byte load where the address
// is 16-byte aligned and the group is whole, else scalar loads
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ row, int64_t c0, int64_t D,
                                           float (&v)[Vec<T>::kN]) {
  constexpr int N = Vec<T>::kN;
  const T* p = row + c0;
  if (c0 + N <= D && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    Vec<T>::unpack(__ldcs(reinterpret_cast<const typename Vec<T>::Raw*>(p)), v);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = c0 + k < D ? to_f32(p[k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fim_diag_leaves_kernel(const __grid_constant__ LeafTable t, int64_t B, float ema) {
  constexpr int N = Vec<T>::kN;
  __shared__ float part[kThreads * N];
  const int l = leaf_of(t, blockIdx.x);
  const int shift = t.shift[l];
  const int groups = 1 << shift;       // column groups a block
  const int rows = kThreads >> shift;  // row slices
  const int width = groups * N;        // columns a block
  const int slice = threadIdx.x >> shift;
  const int64_t D = t.cols[l];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x - t.first[l]) * width;
  const int64_t c0 = tile0 + (threadIdx.x & (groups - 1)) * N;
  const T* __restrict__ g = static_cast<const T*>(t.g[l]);
  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
  if (c0 < D) {
    int64_t b = slice;
    const bool aligned_rows =
        c0 + N <= D &&
        ((reinterpret_cast<uintptr_t>(g + c0) | static_cast<uintptr_t>(D * sizeof(T))) & 15) == 0;
    if (aligned_rows) {
      using Raw = typename Vec<T>::Raw;
      const Raw* col = reinterpret_cast<const Raw*>(g + c0);
      const int64_t stride = D / N;  // Raw elements a row
      for (; b + 3 * rows < B; b += 4 * rows) {
        Raw r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) r[u] = __ldcs(col + (b + u * rows) * stride);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float v[N];
          Vec<T>::unpack(r[u], v);
#pragma unroll
          for (int k = 0; k < N; ++k) acc[k] += v[k] * v[k];
        }
      }
      for (; b < B; b += rows) {
        float v[N];
        Vec<T>::unpack(__ldcs(col + b * stride), v);
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] += v[k] * v[k];
      }
    } else {
      for (; b < B; b += rows) {
        float v[N];
        load_group(g + b * D, c0, D, v);
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] += v[k] * v[k];
      }
    }
  }
  // part[slice][column of the block]: thread (slice, group) holds columns
  // group*N .. group*N+N-1 of its slice
#pragma unroll
  for (int k = 0; k < N; ++k) part[threadIdx.x * N + k] = acc[k];
  __syncthreads();
  if (threadIdx.x < width) {
    const int64_t d = tile0 + threadIdx.x;
    if (d < D) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += part[r * width + threadIdx.x];
      const float mean = s / static_cast<float>(B);
      const float* old = t.old[l];
      t.out[l][d] = old ? ema * old[d] + (1.f - ema) * mean : (1.f - ema) * mean;
    }
  }
}

}  // namespace

// One launch over n_leaves (1..64) leaves of one batch size B.  g, old, out:
// n_leaves device addresses ((B, cols[i]) row-major f32 or bf16 gradients;
// (cols[i],) f32 old diagonals, 0 for none; (cols[i],) f32 outputs); cols[i]
// >= 1; shift[i] in [0, log2(256 / kVec)]; first: n_leaves + 1 ints, first[0] =
// 0 and first[i + 1] = first[i] + ceil(ceil(cols[i] / kVec) / 2^shift[i])
// (kernels/fim_diag.py: leaf_table).  bf16 != 0 reads bf16 gradients.
// Returns a cudaError_t code.
extern "C" int fim_diag_leaves(const int64_t* g, const int64_t* old, const int64_t* out,
                               const int64_t* cols, const int* first, const int* shift,
                               int n_leaves, int64_t B, float ema, int bf16, void* stream) {
  const int vec = bf16 ? Vec<__nv_bfloat16>::kN : Vec<float>::kN;
  if (n_leaves < 1 || n_leaves > kMaxLeaves || first[0] != 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable t = {};
  t.n_leaves = n_leaves;
  for (int i = 0; i < n_leaves; ++i) {
    if (cols[i] < 1 || shift[i] < 0 || (vec << shift[i]) > kThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t groups = (cols[i] + vec - 1) / vec;
    const int64_t blocks = (groups + (int64_t{1} << shift[i]) - 1) >> shift[i];
    if (first[i + 1] - first[i] != blocks) return static_cast<int>(cudaErrorInvalidValue);
    t.g[i] = reinterpret_cast<const void*>(g[i]);
    t.old[i] = reinterpret_cast<const float*>(old[i]);
    t.out[i] = reinterpret_cast<float*>(out[i]);
    t.cols[i] = cols[i];
    t.first[i] = first[i];
    t.shift[i] = shift[i];
  }
  t.first[n_leaves] = first[n_leaves];
  const unsigned int grid = static_cast<unsigned int>(first[n_leaves]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    fim_diag_leaves_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(t, B, ema);
  else
    fim_diag_leaves_kernel<float><<<grid, kThreads, 0, s>>>(t, B, ema);
  return static_cast<int>(cudaGetLastError());
}
