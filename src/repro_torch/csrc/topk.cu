// Bucketed top-k threshold select of a flat f32 payload:
//   bucket(x) = bits(|x|) >> 22   (an order-preserving radix, 512 buckets)
//   t    = the largest bucket with count(bucket >= t) >= k
//   need = k - count(bucket > t)             (the tie quota of bucket t)
//   keep = bucket > t | (bucket == t & index-order rank among bucket-t < need)
//   out  = keep ? x : +0.0
// Exactly k elements survive for 1 <= k <= n; ties on bucket t break by
// index (lowest index wins), so this is not exact magnitude top-k.
//
// Replaces the TPU kernel src/repro/kernels/codec_ops.py:topk_select
// (_hist_kernel, the threshold glue between the two pallas_calls, and
// _select_kernel).
//
// Bound on the H100: device-memory bandwidth.  The function reads x once
// and writes out once, 8 bytes per element (3.3 MB at the main path's
// n = 413,844, ~1 us at 3.35 TB/s); this design reads x three times, but
// a payload of that size stays in the 50 MB L2 after the first read.  At
// the main path's sizes the four launches' latency sets the time.
//
// Design.  The TPU select pass carries its tie counter across a
// sequential grid; a CUDA grid has no order, so the carry becomes a scan:
//   1. topk_hist: grid-stride histogram, shared-memory int atomics, then
//      one global int atomic per non-empty bucket per block (integer sums
//      do not depend on order);
//   2. topk_threshold: one block of 512 threads; a suffix scan of the
//      histogram gives ge[t] = count(bucket >= t), the one thread with
//      ge[t] >= k > ge[t+1] writes t and need to device memory (no host
//      sync: the select reads them there);
//   3. topk_tie_count: one block per tile of TILE elements counts the tile's
//      bucket-t elements; the last block to finish (a ticket taken after a
//      __threadfence) scans the tile counts in index order into exclusive
//      tile offsets;
//   4. topk_select_tiles: the same tiles; each thread takes ITEMS
//      consecutive elements, a block-wide exclusive scan of the threads'
//      tie counts (warp shuffles + warp totals in shared memory) gives
//      each thread its first rank, and the thread walks its elements in
//      order.
// Integers only, no floating-point atomics: the keep mask is identical
// to the plain version's on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBuckets = 512;  // TOPK_BUCKETS (repro_torch/kernels/ref.py)
constexpr int kShift = 22;     // TOPK_SHIFT
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // elements per tile (TILE)
constexpr int kWarps = kThreads / 32;
constexpr int kHistBlocksMax = 1024;

// the scratch int32 buffer: [hist | t, need | ticket | tile counts | offsets]
constexpr int kHeader = kBuckets + 3;

__device__ __forceinline__ int bucket_of(float v) {
  return static_cast<int>((__float_as_uint(v) & 0x7fffffffu) >> kShift);
}

// exclusive scan of one int per thread over a kThreads block; *total gets
// the block's sum.  Contains __syncthreads: every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    sum += s;
  }
  __syncthreads();  // warp_sums may be reused by the next call
  *total = sum;
  return before + incl - v;
}

__global__ void topk_hist(const float* __restrict__ x, int64_t n, int* __restrict__ hist) {
  __shared__ int sh[kBuckets];
  for (int i = threadIdx.x; i < kBuckets; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    atomicAdd(&sh[bucket_of(x[i])], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < kBuckets; i += blockDim.x)
    if (sh[i]) atomicAdd(&hist[i], sh[i]);
}

// one block of kBuckets threads
__global__ void topk_threshold(int* __restrict__ scratch, int64_t k) {
  __shared__ long long ge[kBuckets];
  const int t = threadIdx.x;
  const int h = scratch[t];
  ge[t] = h;
  __syncthreads();
  // inclusive suffix scan: ge[t] = sum of hist[t..511]
  for (int off = 1; off < kBuckets; off <<= 1) {
    const long long up = t + off < kBuckets ? ge[t + off] : 0;
    __syncthreads();
    ge[t] += up;
    __syncthreads();
  }
  // ge is non-increasing in t, so at most one t has ge[t] >= k and is the
  // last bucket or has ge[t+1] < k; if none does (k > n), the plain
  // version's max over an empty set is 0
  const bool is_t = ge[t] >= k && (t == kBuckets - 1 || ge[t + 1] < k);
  const bool none = t == 0 && ge[0] < k;
  if (is_t || none) {
    scratch[kBuckets] = t;
    scratch[kBuckets + 1] = static_cast<int>(k - (ge[t] - h));
  }
}

__global__ void topk_tie_count(const float* __restrict__ x, int64_t n, int* __restrict__ scratch,
                               int n_tiles) {
  const int t = scratch[kBuckets];
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + kBuckets + 2);
  int* tile_ties = scratch + kHeader;
  int* tile_off = tile_ties + n_tiles;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int c = 0;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int64_t i = base + j;
    if (i < n && bucket_of(x[i]) == t) ++c;
  }
  int total;
  block_exclusive_scan(c, &total);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    tile_ties[blockIdx.x] = total;
    __threadfence();  // the count is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(n_tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: exclusive scan of the tile counts in index order
  int carry = 0;
  for (int start = 0; start < n_tiles; start += kThreads) {
    const int i = start + threadIdx.x;
    const int v = i < n_tiles ? __ldcg(tile_ties + i) : 0;
    int chunk;
    const int excl = block_exclusive_scan(v, &chunk);
    if (i < n_tiles) tile_off[i] = carry + excl;
    carry += chunk;
  }
}

__global__ void topk_select_tiles(const float* __restrict__ x, float* __restrict__ out, int64_t n,
                                  const int* __restrict__ scratch, int n_tiles) {
  const int t = scratch[kBuckets];
  const int need = scratch[kBuckets + 1];
  const int* tile_off = scratch + kHeader + n_tiles;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile +
                        static_cast<int64_t>(threadIdx.x) * kItems;
  float v[kItems];
  int ties = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j;
    v[j] = i < n ? x[i] : 0.f;
    if (i < n && bucket_of(v[j]) == t) ++ties;
  }
  int unused;
  int rank = tile_off[blockIdx.x] + block_exclusive_scan(ties, &unused);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j;
    if (i >= n) break;
    const int b = bucket_of(v[j]);
    bool keep = b > t;
    if (b == t) {
      keep = rank < need;
      ++rank;
    }
    out[i] = keep ? v[j] : 0.f;
  }
}

}  // namespace

// x, out: n contiguous f32 on the device, 1 <= n < 2^31; scratch:
// scratch_len int32 on the device, at least
// kHeader + 2 * ceil(n / kTile) (kernels/codec_ops.py: topk_scratch_len).
// Returns a cudaError_t code.
extern "C" int topk_select(const void* x, void* out, int64_t n, int64_t k, void* scratch,
                           int64_t scratch_len, void* stream) {
  if (n <= 0 || n > INT32_MAX || scratch_len < kHeader + 2 * ((n + kTile - 1) / kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int* sc = static_cast<int*>(scratch);
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  // zero the histogram, t/need and the ticket
  cudaError_t err = cudaMemsetAsync(sc, 0, kHeader * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t hist_blocks = (n + kThreads * 8 - 1) / (kThreads * 8);
  if (hist_blocks > kHistBlocksMax) hist_blocks = kHistBlocksMax;
  topk_hist<<<static_cast<unsigned int>(hist_blocks), kThreads, 0, s>>>(xf, n, sc);
  topk_threshold<<<1, kBuckets, 0, s>>>(sc, k);
  topk_tie_count<<<n_tiles, kThreads, 0, s>>>(xf, n, sc, n_tiles);
  topk_select_tiles<<<n_tiles, kThreads, 0, s>>>(xf, static_cast<float*>(out), n, sc, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
