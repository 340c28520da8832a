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
// n = 413,844, ~1 us at 3.35 TB/s).  Integer work only.
//
// Two paths, chosen by n alone (kernels/codec_ops.py: topk_select):
//
// A. One launch, n up to the cluster's shared memory (topk_cluster_kernel).
//    A block-at-a-time design pays a launch for each global step; a
//    thread-block cluster does them all in one, since its blocks read each
//    other's shared memory (DSMEM) and barrier together.  One cluster of C
//    blocks (C = 16 where the card can place it, else 8: topk_cluster_shape
//    asks cudaOccupancyMaxActiveClusters); block rank r owns the contiguous
//    chunk [r*m, min(n, (r+1)*m)), m = ceil(n / C) rounded up to 4, so the
//    ranks keep index order for the tie break.
//      1. the chunk comes into shared memory once, by 1-D bulk copies
//         (cp.async.bulk) in kPieces pieces, each with its own mbarrier, so
//         the histogram of a piece overlaps the copy of the next; the chunk
//         sits at the address x has modulo 16, so every piece is 16-byte
//         aligned in both spaces and only the <= 3 + 3 elements at the
//         ragged ends are loaded by threads;
//      2. a 512-bucket histogram with shared int atomics, into this rank's
//         row of a C x 512 table;
//      3. each block stores its row into the same row of every other
//         rank's table (16-byte DSMEM stores: no round trip to wait for);
//         one cluster.sync(); then every block holds all C histograms and
//         finds t, need and its tie offset (the lower ranks' bucket-t
//         counts) itself: the same t and need in every block (integers, no
//         global scratch, memset or ticket).  Reading the C histograms
//         through DSMEM, 4 bytes a load, cost ~3 us more on the card, and
//         owners of bucket slices (a push, a barrier, a sum, a barrier, a
//         read) ~0.6 us more;
//      4. each warp counts its segment's bucket-t elements;
//      5. each warp's ties are all kept (its first rank + its ties <= need)
//         or all dropped (first rank >= need), save in the one warp of the
//         cluster that holds the need-th tie: the others keep bucket >= t
//         or > t; in that one each lane walks a contiguous run of the
//         segment from its first rank (a warp scan of the lanes' tie
//         counts).  out is written once from shared memory.  A serial walk
//         of the ranks, 32 elements a step with a ballot, in every warp, took
//         ~4 us at n = 413,844 (the kernel waits for its slowest warp); a
//         ballot a group of 32 in every warp, ~3 us more than this; the
//         result written back into shared memory and out by bulk copies,
//         ~2 us more than these coalesced thread stores;
//    An arrival at the start, waited on before the first DSMEM store, makes
//    sure every block has started; no DSMEM access follows the barrier of
//    step 3, so a block may leave as soon as its own work is done.
//    x is read from device memory once and out written once: the traffic
//    the byte bound counts.
//
// B. Four launches, any n below 2^31 (kept for n above the capacity of A).
//    The TPU select pass carries its tie counter across a sequential grid;
//    a CUDA grid has no order, so the carry becomes a scan:
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
//    A memset and four launches: launch-bound at the main path's sizes.
// Integers only, no floating-point atomics: the keep mask is identical
// to the plain version's on every run, on either path.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBuckets = 512;  // TOPK_BUCKETS (repro_torch/kernels/ref.py)
constexpr int kShift = 22;     // TOPK_SHIFT
constexpr unsigned int kTop = 0x7fffffffu & ~((1u << kShift) - 1u);  // |v|'s bucket bits
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

// ---------------------------------------------------------------------------
// A. the one-launch cluster path
// ---------------------------------------------------------------------------
namespace cl {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPieces = 8;        // bulk copies (and mbarriers) a chunk
constexpr int kMaxCluster = 16;   // non-portable cluster size of sm_90
constexpr int kSlack = 16;        // dynamic shared bytes for the chunk's alignment

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kThreads, 1)
    topk_cluster_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int k,
                        int m) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(gridDim.x);  // the grid is one cluster
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ int ge[kBuckets];         // count(bucket >= i) over the cluster
  __shared__ int wsum[kBuckets / 32];
  __shared__ int warp_ties[kWarps];
  __shared__ int sh_t, sh_need, sh_off;
  __shared__ alignas(8) uint64_t bars[kPieces];
  // dynamic: every rank's histogram (C x 512 ints: this rank's own row,
  // the others stored here by their ranks), kSlack bytes, then the chunk
  extern __shared__ __align__(16) unsigned char dyn[];
  int* hists = reinterpret_cast<int*>(dyn);
  int* hist = hists + rank * kBuckets;

  const int lo = min(n, rank * m);
  const int len = min(n, lo + m) - lo;
  const float* src = x + lo;
  // element j of the chunk lives at sh[j]; sh has src's address modulo 16,
  // so [head, head + body) is 16-byte aligned in both spaces
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  float* sh = reinterpret_cast<float*>(dyn + n_ranks * kBuckets * 4 + mis);
  const int head = min(len, ((16 - mis) & 15) >> 2);
  const int body = ((len - head) >> 2) << 2;
  const int tail = head + body;  // [tail, len): at most 3 elements
  const int per = (((body >> 2) + kPieces - 1) / kPieces) << 2;

  // every block has started before any DSMEM access: this arrival's wait
  // comes before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int i = tid; i < kBuckets; i += kThreads) hist[i] = 0;
  if (tid == 0) {
    for (int p = 0; p < kPieces; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[p]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int p = 0; p < kPieces; ++p) {
      const int s = p * per, e = min(body, s + per);
      if (e <= s) break;
      const uint32_t bar = smem_addr(&bars[p]);
      const uint32_t bytes = static_cast<uint32_t>(e - s) * 4u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(sh + head + s)),
          "l"(src + head + s), "r"(bytes), "r"(bar)
          : "memory");
    }
  }
  // the ragged ends, by threads 0-3 (head) and 4-7 (tail)
  if (tid < 8) {
    const int j = tid < 4 ? tid : tail + tid - 4;
    if (tid < 4 ? j < head : j < len) {
      const float v = src[j];
      sh[j] = v;
      atomicAdd(&hist[bucket_of(v)], 1);
    }
  }
  for (int p = 0; p < kPieces; ++p) {
    const int s = p * per, e = min(body, s + per);
    if (e <= s) break;
    mbar_wait(smem_addr(&bars[p]), 0);
    const float4* piece = reinterpret_cast<const float4*>(sh + head + s);  // 16-byte aligned
    for (int q = tid; q < (e - s) >> 2; q += kThreads) {
      const float4 v = piece[q];
      atomicAdd(&hist[bucket_of(v.x)], 1);
      atomicAdd(&hist[bucket_of(v.y)], 1);
      atomicAdd(&hist[bucket_of(v.z)], 1);
      atomicAdd(&hist[bucket_of(v.w)], 1);
    }
  }
  // The threshold.  Each block stores its histogram into every other rank's
  // row `rank` (DSMEM stores of 16 bytes: no round trip to wait for); after
  // one cluster barrier every block holds all C histograms and finds t, need
  // and its tie offset locally.
  __syncthreads();  // this chunk's histogram is complete
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  constexpr int kQuads = kBuckets / 4;
  for (int i = tid; i < (n_ranks - 1) * kQuads; i += kThreads) {
    const int q = i / kQuads;
    const int4 v = reinterpret_cast<const int4*>(hist)[i % kQuads];
    *cluster.map_shared_rank(reinterpret_cast<int4*>(hist) + i % kQuads, q < rank ? q : q + 1) = v;
  }
  cluster.sync();  // every histogram has arrived; no DSMEM access after this
  int h = 0, incl = 0, off = 0;
  if (tid < kBuckets) {
    for (int r = 0; r < n_ranks; ++r) {
      const int c = hists[r * kBuckets + tid];
      if (r == rank) off = h;  // the lower ranks' count of bucket tid
      h += c;
    }
    incl = h;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int down = __shfl_down_sync(0xffffffffu, incl, d);
      if (lane + d < 32) incl += down;
    }
    if (lane == 0) wsum[warp] = incl;
  }
  __syncthreads();
  if (tid < kBuckets) {
    for (int v = warp + 1; v < kBuckets / 32; ++v) incl += wsum[v];
    ge[tid] = incl;
  }
  __syncthreads();
  // the one t with ge[t] >= k > ge[t+1] (k <= n)
  if (tid < kBuckets && incl >= k && (tid == kBuckets - 1 || ge[tid + 1] < k)) {
    sh_t = tid;
    sh_need = k - (incl - h);
    sh_off = off;  // the chunk's tie offset
  }
  __syncthreads();
  const int t = sh_t;
  const int need = sh_need;

  // warp w's segment of the chunk: seg elements (a multiple of 32) from w * seg,
  // 128 a step, lane l on elements l, l + 32, l + 64, l + 96 of the step
  // (no bank conflicts; a step's loads all go out before its stores).
  // bucket(v) == t and bucket(v) >= tk compare |v|'s bits with t's and
  // tk's first bit patterns.
  const int seg = (((len + kWarps - 1) / kWarps + 31) >> 5) << 5;
  const int seg_lo = min(len, warp * seg);
  const int seg_hi = min(len, seg_lo + seg);
  const unsigned int t_bits = static_cast<unsigned int>(t) << kShift;
  int c = 0;
  int j0 = seg_lo + lane;
  for (; j0 + 96 < seg_hi; j0 += 128) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c += (__float_as_uint(sh[j0 + 32 * i]) & kTop) == t_bits;
  }
  for (; j0 < seg_hi; j0 += 32) c += (__float_as_uint(sh[j0]) & kTop) == t_bits;
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) warp_ties[warp] = c;
  __syncthreads();
  int rank_t = sh_off;
  for (int w = 0; w < warp; ++w) rank_t += warp_ties[w];
  if (rank_t + warp_ties[warp] <= need || rank_t >= need) {
    // the segment's ties are all kept or all dropped: keep bucket >= tk
    // (tk = 512 keeps nothing: no |v| reaches 2^31)
    const unsigned int keep_bits = static_cast<unsigned int>(rank_t < need ? t : t + 1) << kShift;
    j0 = seg_lo + lane;
    for (; j0 + 96 < seg_hi; j0 += 128) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = sh[j0 + 32 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[lo + j0 + 32 * i] = (__float_as_uint(v[i]) & 0x7fffffffu) >= keep_bits ? v[i] : 0.f;
    }
    for (; j0 < seg_hi; j0 += 32) {
      const float v = sh[j0];
      out[lo + j0] = (__float_as_uint(v) & 0x7fffffffu) >= keep_bits ? v : 0.f;
    }
  } else {
    // the one warp of the cluster whose segment holds the need-th tie: each
    // lane takes a contiguous run of the segment and counts its ties, a warp
    // scan gives each lane its first index-order rank, and the lane walks
    // its run in order, 8 elements a batch
    const int run = (seg_hi - seg_lo + 31) / 32;
    const int r_lo = min(seg_hi, seg_lo + lane * run);
    const int r_hi = min(seg_hi, r_lo + run);
    int mine = 0;
    for (int j = r_lo; j < r_hi; ++j) mine += (__float_as_uint(sh[j]) & kTop) == t_bits;
    int before = mine;  // inclusive scan of the lanes' counts
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, before, d);
      if (lane >= d) before += up;
    }
    int r = rank_t + before - mine;
    for (int q0 = r_lo; q0 < r_hi; q0 += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = q0 + i < r_hi ? sh[q0 + i] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (q0 + i >= r_hi) break;
        const int b = bucket_of(v[i]);
        bool keep = b > t;
        if (b == t) keep = r++ < need;
        out[lo + q0 + i] = keep ? v[i] : 0.f;
      }
    }
  }
}

// the attributes the kernel needs on the current device; *dyn_max gets the
// dynamic shared memory a block may take: the opt-in maximum less the
// static part
cudaError_t prepare(int* dyn_max) {
  static int done[64] = {};  // a device's dyn_max once its attributes are set
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev] > 0) {
    *dyn_max = done[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, topk_cluster_kernel);
  if (err != cudaSuccess) return err;
  *dyn_max = optin - static_cast<int>(fa.sharedSizeBytes);
  err = cudaFuncSetAttribute(topk_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *dyn_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(topk_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) done[dev] = *dyn_max;
  return err;
}

// dynamic shared bytes of a block of a `cluster`-block launch with chunks
// of m elements: the C histograms, the slack, the chunk
size_t smem_bytes(int cluster, int64_t m) {
  return static_cast<size_t>(cluster * kBuckets * 4 + kSlack + 4 * m);
}

// the largest chunk (a multiple of 4 elements) a block holds
int64_t chunk_max(int dyn_max, int cluster) {
  return ((static_cast<int64_t>(dyn_max) - cluster * kBuckets * 4 - kSlack) / 4) & ~int64_t{3};
}

cudaLaunchConfig_t config(int cluster, size_t smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace cl

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

// The one-launch path's shape on the current device: *cluster gets the
// cluster size (`want`, or with want = 0 the larger of 16 and 8 that
// cudaOccupancyMaxActiveClusters can place at full shared memory; 0 if
// neither), *capacity the largest n it takes (cluster x the chunk a block
// holds).  Returns a cudaError_t code.
extern "C" int topk_cluster_shape(int want, int* cluster, int64_t* capacity) {
  *cluster = 0;
  *capacity = 0;
  if (want != 0 && want != 8 && want != 16) return static_cast<int>(cudaErrorInvalidValue);
  int dyn_max = 0;
  cudaError_t err = cl::prepare(&dyn_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int c = cl::kMaxCluster; c >= 8; c /= 2) {
    if (want != 0 && c != want) continue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cl::config(c, static_cast<size_t>(dyn_max), nullptr, &attr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, cl::topk_cluster_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active >= 1) {
      *cluster = c;
      *capacity = c * cl::chunk_max(dyn_max, c);
      break;
    }
  }
  return 0;
}

// x, out: n contiguous f32 on the device, 1 <= n <= the capacity that
// topk_cluster_shape gave for this cluster size; 0 <= k <= n.  One launch.
// Returns a cudaError_t code.
extern "C" int topk_select_cluster(const void* x, void* out, int64_t n, int64_t k, int cluster,
                                   void* stream) {
  if (n <= 0 || n > INT32_MAX || k < 0 || k > n || (cluster != 8 && cluster != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  int dyn_max = 0;
  cudaError_t err = cl::prepare(&dyn_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t m = ((n + cluster - 1) / cluster + 3) & ~int64_t{3};
  if (m > cl::chunk_max(dyn_max, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cl::config(cluster, cl::smem_bytes(cluster, m),
                                            static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, cl::topk_cluster_kernel, static_cast<const float*>(x),
                           static_cast<float*>(out), static_cast<int>(n), static_cast<int>(k),
                           static_cast<int>(m));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
