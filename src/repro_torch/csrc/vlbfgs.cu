// VL-BFGS Gram matrix: out = basis * basis^T, in f32, for the (n, D) basis
// [s_0..s_{m-1}, y_0..y_{m-1}, g], n = 2m+1 <= 64, read in place from the
// leaves of the history: no basis is built.  Each row group (s, y, g) is f32
// or bf16 (an LLM's history is kept in bf16, its gradient in f32); bf16 rows
// are read as they lie and widened to f32 as they leave shared memory, as the
// TPU kernel casts each tile to f32 in the kernel.
//
// Replaces the TPU kernel src/repro/kernels/vlbfgs.py:gram (_kernel), which
// walks D over a sequential grid and rank-updates one (n, n) accumulator on
// the MXU; its caller first concatenates every history leaf into one (n, D)
// array, because a BlockSpec cuts one array.
//
// Bound on the H100: device-memory bandwidth.  The function reads the basis
// once (n*D*4 bytes, ~17.4 MB at the main path's n = 21, D = 206,922: ~5.2 us
// at 3.35 TB/s) and does n(n+1)/2 * 2 flops per column (~96 MFLOP, ~1.4 us at
// the 67 TFLOP/s f32 rate outside the tensor cores).  Building the basis first
// would write and read it once more.
//
// Design: one launch over a table of the leaves (a __grid_constant__
// GramTable, as csrc/codec_ops.cu passes a payload's leaves).  Row r of leaf l
// lies in one of three row groups (s, y, g: m, m and 1 rows; the (n, D) basis
// entry point passes one group of n rows), at group base + r' * cols[l]
// elements of the group's type, so the history's (m, *shape) buffers are read
// where they are.  A leaf of cols
// columns takes ceil(cols / chunk) blocks, each a contiguous column chunk; a
// block finds its leaf by a binary search of the first blocks.  The host picks
// the least chunk (a multiple of 4 columns, so slabs keep each row's 16-byte
// alignment) that needs no more blocks than SMs, so every SM streams and the
// partials stay few.
//   A block streams its chunk as (n, tile) slabs through kStages shared-memory
// stages with cp.async (the next slabs load while this one is multiplied):
// 16-byte copies on rows whose start is 16-byte aligned, 4-byte copies on the
// others (row r of a (m, 10) f32 leaf starts 40r bytes in, so the odd rows
// are 8 bytes off), zero-filled past the chunk's end.  A bf16 row keeps its
// 2-byte elements in the stage (a quad is 8 bytes): 16-byte copies of 8
// columns where the row's slab starts 16-byte aligned (the host then cuts
// chunks in multiples of 8 columns), 8-byte copies of a quad where it starts
// 8-byte aligned, and plain loads and stores of single elements elsewhere
// (rows of odd width).  A tile whose rows are all f32 runs the f32 loop as it
// was; a tile with a bf16 row widens each bf16 quad (two shifts and two ands)
// before its FMAs.  The (n_pad, n_pad)
// pair space, n_pad = n rounded up to 8, is cut into 8 x 8 register tiles of
// the upper triangle (6 tiles at n = 21); `lanes` threads share a tile, each
// taking every lanes-th 4-column quad of the slab, so a thread reads 16
// float4s from shared memory for 256 FMAs (8 for a diagonal tile, whose
// rows are its own, and only its upper half summed), and 8 lanes of a tile
// read 8 neighbouring quads of a row (conflict-free).  Rows n .. n_pad-1 of a
// stage are never written: what they hold reaches only the accumulators of
// padded pairs, which are never stored.
//   Each block then sums its lanes' tiles in lane order and writes its
// n(n+1)/2 upper-triangle partials.  The last kReducers blocks to arrive (a
// counter taken by a release atomic after the block's partials are written)
// wait, by an acquire load, until every block has arrived, and each sums a
// slice of the pairs: a thread loads one pair's partials of kRange blocks at
// once and sums them in block order, then the ranges are added in order, and
// both mirrored entries written; the last reducer resets the counters.  No
// atomics on values: the result is deterministic and exactly symmetric.
// Plain f32 FMAs on the CUDA cores, no TF32.
//   What the card showed for earlier versions of this file
// (tools/fim_gram_breakdown.py --cuts, n = 21 from an m = 10 history of the
// CNN, on an H100 at 700 W): summing the partials in one last block, a warp
// a pair, cost ~15 us more than two levels of last blocks (~4.4 us); one
// last block with every load in flight took ~4.9 us; the reducers ~2.7.  With
// 4 x 4 register tiles (twice the shared-memory reads) the products added
// ~7 us to the copies, with 8 x 8 ~4.4 us, whatever the stage count (3 to 8)
// or slab width.  Bulk copies (cp.async.bulk, a row a copy, issued by one
// warp after each slab's barrier) streamed 3x slower than these cp.asyncs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;         // MAX_N (kernels/vlbfgs.py)
constexpr int kMaxLeaves = 64;    // MAX_LEAVES
constexpr int kStages = 4;        // STAGES: slabs in shared memory, kStages - 1 loading
constexpr int kMaxThreads = 384;  // MAX_THREADS
constexpr int kPad = 4;           // floats after each slab row
constexpr int kT = 8;             // TILE_EDGE: a thread's register tile is kT x kT pairs
constexpr int kRedStride = kT * kT + 1;  // floats a thread's tile takes in shared memory
constexpr int kRange = 16;        // RANGE: blocks' partials a reducer loads at once a pair
constexpr int kReducers = 8;      // REDUCERS: the last blocks to arrive sum the partials
constexpr int64_t kMaxSmem = 226 * 1024;  // dynamic shared memory a block may use (H100: 227 KB)

struct GramTable {
  const char* rows[kMaxLeaves][3];   // first row of the leaf's s, y and g groups
  int64_t cols[kMaxLeaves];          // the leaf's columns, each group's row stride
  int first[kMaxLeaves + 1];         // each leaf's first block; first[n_leaves] = the grid
  int n_leaves;
};

struct GramShape {
  int count[3];   // rows of each group, the same for every leaf
  int half[3];    // 1 where the group's rows are bf16, 0 where f32
  int n;          // count[0] + count[1] + count[2]
  int n_tiles;    // kT x kT tiles of the upper triangle of (n_pad, n_pad)
  int lanes;      // threads a tile
  int tile;       // slab columns: 4 * lanes * quads a lane
  int64_t chunk;  // columns a block, a multiple of tile
};

__host__ __device__ constexpr int pad_rows(int n) { return (n + kT - 1) / kT * kT; }


__device__ __forceinline__ int leaf_of(const GramTable& t, int block) {
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

// the group of basis row r (0 s, 1 y, 2 g), and r made its row in the group
__device__ __forceinline__ int group_of(const GramShape& s, int* r) {
  if (*r < s.count[0]) return 0;
  *r -= s.count[0];
  if (*r < s.count[1]) return 1;
  *r -= s.count[1];
  return 2;
}

// first byte of row r of leaf l, and whether the row is bf16
__device__ __forceinline__ const char* row_ptr(const GramTable& t, const GramShape& s, int l,
                                               int r, bool* half) {
  const int g = group_of(s, &r);
  *half = s.half[g] != 0;
  return t.rows[l][g] + static_cast<int64_t>(r) * t.cols[l] * (*half ? 2 : 4);
}

// bit x set where row row0 + x of the basis is bf16 (padding rows are not)
__device__ __forceinline__ unsigned int half_mask(const GramShape& s, int row0) {
  unsigned int mask = 0;
  for (int x = 0; x < kT; ++x) {
    int r = row0 + x;
    if (r < s.n && s.half[group_of(s, &r)]) mask |= 1u << x;
  }
  return mask;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// columns [c, c + tile) of leaf l into stage buf, zero-filled from `end`
// on: thread k copies quads k, k + blockDim.x, ... of the (n, tile / 4)
// quad grid.  An f32 row: 16 bytes at a time where the row starts 16-byte
// aligned and 4 bytes at a time elsewhere.  A bf16 row (2-byte elements kept
// as they are, a quad in 8 bytes): where the row starts 16-byte aligned the
// even quads copy 16 bytes (their quad and the next) and the odd ones
// nothing; 8-byte aligned, a quad 8 bytes; elsewhere element by element.
// kAny: some group of the launch is bf16 (else every row is f32).
template <bool kAny>
__device__ __forceinline__ void issue_slab(float* buf, const GramTable& t, const GramShape& s,
                                           int l, int64_t c, int64_t end) {
  const int quads = s.tile >> 2;
  const int64_t left = end - c;
  const int width = left < s.tile ? static_cast<int>(left) : s.tile;
  // (r, q) of quad threadIdx.x, stepped by blockDim.x without a division a step
  const int step_r = blockDim.x / quads, step_q = blockDim.x - step_r * quads;
  int r = threadIdx.x / quads, q = threadIdx.x - r * quads;
  for (; r < s.n; r += step_r, q += step_q) {
    if (q >= quads) {
      q -= quads;
      if (++r >= s.n) break;
    }
    bool half;
    const char* row = row_ptr(t, s, l, r, &half);
    const int valid = min(max(width - 4 * q, 0), 4);
    if (!kAny || !half) {
      const float* src = reinterpret_cast<const float*>(row) + c;
      float* dst = buf + r * (s.tile + kPad) + 4 * q;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        cp_async16(dst, valid ? src + 4 * q : src, 4 * valid);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + e, e < valid ? src + 4 * q + e : src, e < valid ? 4 : 0);
      }
      continue;
    }
    const uint16_t* src = reinterpret_cast<const uint16_t*>(row) + c;
    uint16_t* dst = reinterpret_cast<uint16_t*>(buf + r * (s.tile + kPad)) + 4 * q;
    const uintptr_t align = reinterpret_cast<uintptr_t>(src);
    if ((align & 15) == 0) {
      if (q & 1) continue;  // copied with quad q - 1
      const int pair = min(max(width - 4 * q, 0), 8);
      cp_async16(dst, pair ? src + 4 * q : src, 2 * pair);
    } else if ((align & 7) == 0) {
      cp_async8(dst, valid ? src + 4 * q : src, 2 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = e < valid ? src[4 * q + e] : uint16_t{0};
    }
  }
}

// quad q of a stage row: 4 f32, or 4 bf16 (8 bytes) widened to f32
template <bool kMixed>
__device__ __forceinline__ float4 load_quad(const float* row, int q, bool half) {
  if (kMixed && half) {
    const uint2 v = *reinterpret_cast<const uint2*>(reinterpret_cast<const char*>(row) + 8 * q);
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(row + 4 * q);
}

// acc[x][y] += <row x of a_rows, row y of b_rows> over the quads lane,
// lane + lanes, ... of a slab (rows ld floats apart); a diagonal tile
// (b_rows == a_rows) reads its rows once and sums only y >= x.  kMixed:
// bit x of a_half (b_half) marks row x of a_rows (b_rows) bf16.
template <bool kDiag, bool kMixed>
__device__ __forceinline__ void tile_fma(float (&acc)[kT][kT], const float* a_rows,
                                         const float* b_rows, int ld, int lane, int quads,
                                         int lanes, unsigned int a_half, unsigned int b_half) {
  for (int q = lane; q < quads; q += lanes) {
    float4 a[kT];
#pragma unroll
    for (int x = 0; x < kT; ++x) a[x] = load_quad<kMixed>(a_rows + x * ld, q, (a_half >> x) & 1);
#pragma unroll
    for (int y = 0; y < kT; ++y) {
      const float4 c = kDiag ? a[y] : load_quad<kMixed>(b_rows + y * ld, q, (b_half >> y) & 1);
#pragma unroll
      for (int x = 0; x < kT; ++x) {
        if (kDiag && y < x) continue;
        acc[x][y] += a[x].x * c.x;
        acc[x][y] += a[x].y * c.y;
        acc[x][y] += a[x].z * c.z;
        acc[x][y] += a[x].w * c.w;
      }
    }
  }
}

// The block's slabs through the stages (kStages - 1 in flight), each
// multiplied into this thread's tile (ti, tj) as it lands.  kAny: some
// group is bf16; a tile with a bf16 row then widens it as it reads it.
template <bool kAny>
__device__ __forceinline__ void stream_slabs(float (&acc)[kT][kT], float* smem, const GramTable& t,
                                             const GramShape& s, int l, int64_t c_begin,
                                             int64_t c_end, int slabs, bool on_tile, int ti,
                                             int tj, int lane) {
  const int ld = s.tile + kPad;
  const int stage = pad_rows(s.n) * ld;  // floats a stage
  const unsigned int a_half = kAny ? half_mask(s, kT * ti) : 0u;
  const unsigned int b_half = kAny ? half_mask(s, kT * tj) : 0u;
  const bool mixed = (a_half | b_half) != 0;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < slabs)
      issue_slab<kAny>(smem + j * stage, t, s, l, c_begin + int64_t{j} * s.tile, c_end);
    cp_async_commit();
  }
  const int quads = s.tile >> 2;
  for (int j = 0; j < slabs; ++j) {
    cp_async_wait<kStages - 2>();  // slab j has landed (this thread's copies)
    __syncthreads();               // ... and everyone's; stage (j-1) is free
    const int next = j + kStages - 1;
    if (next < slabs)
      issue_slab<kAny>(smem + (next % kStages) * stage, t, s, l,
                       c_begin + int64_t{next} * s.tile, c_end);
    cp_async_commit();
    if (on_tile) {
      const float* rows = smem + (j % kStages) * stage;
      const float* a_rows = rows + kT * ti * ld;
      const float* b_rows = rows + kT * tj * ld;
      if (kAny && mixed) {
        if (ti == tj)
          tile_fma<true, true>(acc, a_rows, a_rows, ld, lane, quads, s.lanes, a_half, a_half);
        else
          tile_fma<false, true>(acc, a_rows, b_rows, ld, lane, quads, s.lanes, a_half, b_half);
      } else {
        if (ti == tj)
          tile_fma<true, false>(acc, a_rows, a_rows, ld, lane, quads, s.lanes, 0, 0);
        else
          tile_fma<false, false>(acc, a_rows, b_rows, ld, lane, quads, s.lanes, 0, 0);
      }
    }
  }
}

__device__ __forceinline__ unsigned int add_release(unsigned int* p, unsigned int v) {
  unsigned int old;
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
    gram_leaves_kernel(const __grid_constant__ GramTable t, const GramShape s,
                       float* __restrict__ partial, unsigned int* __restrict__ ticket,
                       float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_pad = pad_rows(s.n);
  const int l = leaf_of(t, blockIdx.x);
  const int64_t c_begin = static_cast<int64_t>(blockIdx.x - t.first[l]) * s.chunk;
  const int64_t c_end = c_begin + s.chunk < t.cols[l] ? c_begin + s.chunk : t.cols[l];
  const int slabs = static_cast<int>((c_end - c_begin + s.tile - 1) / s.tile);

  // this thread's tile (ti, tj), ti <= tj, of the R x R tile grid, and lane
  const int R = n_pad / kT;
  const int my_tile = threadIdx.x / s.lanes;
  const int lane = threadIdx.x - my_tile * s.lanes;
  int ti = 0, tj = 0;
  if (my_tile < s.n_tiles) {
    int p = my_tile;
    while (p >= R - ti) {
      p -= R - ti;
      ++ti;
    }
    tj = ti + p;
  }

  float acc[kT][kT];
#pragma unroll
  for (int x = 0; x < kT; ++x)
#pragma unroll
    for (int y = 0; y < kT; ++y) acc[x][y] = 0.f;
  // the launch's dtypes are the block's: an all-f32 launch runs the f32
  // loop alone, with no dtype test in it
  if (s.half[0] | s.half[1] | s.half[2])
    stream_slabs<true>(acc, smem, t, s, l, c_begin, c_end, slabs, my_tile < s.n_tiles, ti, tj,
                       lane);
  else
    stream_slabs<false>(acc, smem, t, s, l, c_begin, c_end, slabs, my_tile < s.n_tiles, ti, tj,
                        lane);
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: reuse them for the lanes' tiles

  float* red = smem;  // red[thread][kRedStride]: padded, so the stores do not conflict
#pragma unroll
  for (int x = 0; x < kT; ++x)
#pragma unroll
    for (int y = 0; y < kT; ++y) red[threadIdx.x * kRedStride + x * kT + y] = acc[x][y];
  __syncthreads();
  const int npairs = s.n * (s.n + 1) / 2;
  const unsigned int grid = gridDim.x;
  for (int p = threadIdx.x; p < npairs; p += blockDim.x) {
    int i, j;
    pair_of(p, s.n, &i, &j);
    const int a = i / kT, b = j / kT;
    const int tile_id = a * R - a * (a - 1) / 2 + (b - a);
    const float* src = red + tile_id * s.lanes * kRedStride + (i % kT) * kT + (j % kT);
    float v = 0.f;
#pragma unroll 8
    for (int k = 0; k < s.lanes; ++k) v += src[k * kRedStride];
    partial[static_cast<int64_t>(blockIdx.x) * npairs + p] = v;
  }

  // The last kReducers blocks to arrive sum the partials, each a slice of
  // the pairs: a thread takes one pair's partials of kRange blocks (its
  // loads all in flight), then each pair's range sums are added in order.
  __shared__ unsigned int arrival;
  __syncthreads();  // every partial of this block is written ...
  if (threadIdx.x == 0) arrival = add_release(ticket, 1u);  // ... and published
  __syncthreads();
  const unsigned int reducers = grid < kReducers ? grid : kReducers;
  if (arrival < grid - reducers) return;
  const int rank = static_cast<int>(arrival - (grid - reducers));
  if (threadIdx.x == 0)
    while (load_acquire(ticket) < grid) {
    }
  __syncthreads();  // every block's partials are visible
  const int p0 = rank * npairs / static_cast<int>(reducers);
  const int len = (rank + 1) * npairs / static_cast<int>(reducers) - p0;
  const int ranges = static_cast<int>((grid + kRange - 1) / kRange);
  float* sums = smem;  // (ranges, len)
  for (int item = threadIdx.x; item < ranges * len; item += blockDim.x) {
    const int r = item / len;
    const int p = p0 + item - r * len;
    const unsigned int b0 = static_cast<unsigned int>(r) * kRange;
    float v[kRange];
#pragma unroll
    for (int b = 0; b < kRange; ++b)
      if (b0 + b < grid) v[b] = __ldcg(partial + static_cast<int64_t>(b0 + b) * npairs + p);
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < kRange; ++b)
      if (b0 + b < grid) sum += v[b];
    sums[item] = sum;
  }
  __syncthreads();
  for (int p = p0 + threadIdx.x; p < p0 + len; p += blockDim.x) {
    float v = 0.f;
    for (int r = 0; r < ranges; ++r) v += sums[r * len + p - p0];
    int i, j;
    pair_of(p, s.n, &i, &j);
    out[i * s.n + j] = v;
    out[j * s.n + i] = v;
  }
  // the last reducer to finish resets both counters for the next launch
  // (every reducer has stopped reading the arrivals by then)
  if (threadIdx.x == 0 && atomicAdd(ticket + 1, 1u) == reducers - 1) {
    ticket[0] = 0;
    ticket[1] = 0;
  }
}

}  // namespace

// Dynamic shared memory of one launch: the stages, then the lanes' tiles and
// the last block's range sums in the same space.
static int64_t gram_smem(int n, int lanes, int tile, int grid) {
  const int r = pad_rows(n) / kT;
  const int threads = (r * (r + 1) / 2 * lanes + 31) / 32 * 32;
  const int64_t stages = int64_t{kStages} * pad_rows(n) * (tile + kPad) * 4;
  const int64_t red = int64_t{threads} * kRedStride * 4;
  const int64_t sums =
      int64_t{(grid + kRange - 1) / kRange} * ((n * (n + 1) / 2 + kReducers - 1) / kReducers) * 4;
  return stages > red ? (stages > sums ? stages : sums) : (red > sums ? red : sums);
}

// One launch over n_leaves (1..64) leaves.  rows: 3 * n_leaves device
// addresses, leaf i's s, y and g groups at rows[3i .. 3i+2] (0 for a group of
// no rows); count: the 3 groups' rows, n = their sum in 1..64; half: 3 flags,
// 1 where a group's rows are bf16, 0 where f32; cols[i] >= 1, each group's
// row stride in elements; lanes >= 1 threads a tile, with ceil32(tiles *
// lanes) <= 384; tile: a multiple of 4 * lanes; chunk: a multiple of 4;
// first: n_leaves + 1 ints, first[0] = 0 and first[i + 1] = first[i] +
// ceil(cols[i] / chunk).  partial: grid * n(n+1)/2 f32 of device scratch,
// grid = first[n_leaves]; ticket: two uint32 on the device, 0 before the
// launch and after it; out: (n, n) f32.  Returns a cudaError_t code.
extern "C" int vlbfgs_gram_leaves(const int64_t* rows, const int64_t* cols, const int* first,
                                  int n_leaves, const int* count, const int* half, int lanes,
                                  int tile,
                                  int64_t chunk, void* partial, void* ticket, void* out,
                                  void* stream) {
  GramShape s = {};
  s.n = 0;
  for (int g = 0; g < 3; ++g) {
    if (count[g] < 0 || half[g] < 0 || half[g] > 1)
      return static_cast<int>(cudaErrorInvalidValue);
    s.count[g] = count[g];
    s.half[g] = half[g];
    s.n += count[g];
  }
  const int r = pad_rows(s.n) / kT;
  s.n_tiles = r * (r + 1) / 2;
  s.lanes = lanes;
  s.tile = tile;
  s.chunk = chunk;
  const int threads = (s.n_tiles * lanes + 31) / 32 * 32;
  if (s.n < 1 || s.n > kMaxN || n_leaves < 1 || n_leaves > kMaxLeaves || first[0] != 0 ||
      lanes < 1 || threads > kMaxThreads || tile < 4 * lanes || tile % (4 * lanes) != 0 ||
      chunk < 4 || chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GramTable t = {};
  t.n_leaves = n_leaves;
  for (int i = 0; i < n_leaves; ++i) {
    if (cols[i] < 1 || first[i + 1] - first[i] != (cols[i] + chunk - 1) / chunk)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int g = 0; g < 3; ++g) t.rows[i][g] = reinterpret_cast<const char*>(rows[3 * i + g]);
    t.cols[i] = cols[i];
    t.first[i] = first[i];
  }
  t.first[n_leaves] = first[n_leaves];
  const int64_t smem = gram_smem(s.n, lanes, tile, first[n_leaves]);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's dynamic shared-memory limit once a device (above 48 KB)
  static int64_t limit[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > limit[dev]) {
    err = cudaFuncSetAttribute(gram_leaves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit[dev] = smem;
  }
  gram_leaves_kernel<<<static_cast<unsigned int>(first[n_leaves]), threads,
                       static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      t, s, static_cast<float*>(partial), static_cast<unsigned int*>(ticket),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
