// Blocked online-softmax (flash) attention with GQA, causal masking and an
// optional sliding window:
//   out[b,h,i,:] = sum_j softmax_j(s[i,j]) v[b,h/G,j,:],
//   s[i,j] = hd^-0.5 * (q[b,h,i,:] . k[b,h/G,j,:]),
// masked to -1e30 unless j < S, (causal) j <= i and (window > 0)
// j > i - window.  Softmax and accumulation in f32; out in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_kernel at :33, pl.pallas_call at :106), whose grid walks the KV blocks of
// one q block in order with the running max, sum and accumulator in VMEM.
// Two kernels, one per dtype, share that function and these behaviours: GQA
// (query head h reads KV head h / (H / KV); K/V are never repeated); a loop
// over key tiles in place of the TPU's sequential KV grid axis, from the
// first tile the window keeps to the last the causal mask keeps (the
// pl.when skip), heaviest causal q tiles first; keys >= S masked, so a
// ragged S stays finite; the finite -1e30 as the mask, as the reference
// (-inf would give exp(-inf + inf) = NaN in a row whose first visited tile
// is wholly masked); out = acc / max(l, 1e-30); q, k, v and out addressed by
// (batch, head, row) strides with contiguous hd, so the model hands over
// its (B, S, H, hd) tensors as transposed views without copies; no atomics,
// so results are deterministic.
//
// Bound on the H100 (forward): operations.  At granite-8b's prefill (B 2, H 32, KV 8,
// S 4096, hd 128, bf16, causal) the live (i, j) pairs need 4 * hd flops
// each, ~2.75e11 flops a call: 0.28 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 0.08 ms for its 134 MB of q, k, v and out.
//
// f32 (flash_kernel, SIMT): every product an f32 FMA (67 TFLOP/s peak
// outside the tensor cores), which holds f32 to the plain version at 2e-5.
//   * one block of 256 threads per (b*H + h, 64-row q tile), 64-key tiles;
//   * tiles staged in shared memory as f32 rows of hd + 4 (16-byte aligned
//     rows, conflict-free float4 reads); K and V share one buffer; rows >= S
//     are zero-filled and never read from device memory;
//   * thread (ty, tx) owns query rows 4ty..4ty+3, the score columns
//     tx + 16j (j < 4) and the output columns tx + 16c (c < hd/16); a row's
//     max and sum are reduced across its 16 threads with shuffles;
//   * a row whose first visited tile is wholly masked gets m = -1e30 and
//     p = 1 there, and the next tile's alpha = exp(-1e30 - m) = 0 wipes
//     that out (every row meets its diagonal);
//   * plain expf and IEEE division (no fast math).
//
// bf16 (tc::flash_tc_kernel, tensor cores): Q.K^T and P.V by wgmma, bf16 in,
// f32 accumulate, on tiles that TMA brings into shared memory.  With P split
// (below) the kernel does 6 * hd flops a live pair, not 4 * hd: its own
// floor at granite's shape is 1.5x the 0.28 ms bound.
//   * work split: one block of 384 threads per (b*H + h, 128-row q tile).
//     Warpgroups 0 and 1 consume, 64 q rows each; one thread of warpgroup 2
//     issues every load.  setmaxnreg moves registers from the producer
//     (24) to the consumers (240), which hold S (64 f32), O (hd padded / 2
//     f32) and P hi/lo (64 packed bf16x2) a thread, all live at once while
//     the softmax overlaps P.V.  Key tiles of 128 at every head dim: at
//     hd 128 the registers still hold them without a spill.
//   * loads: TMA from 4-d maps (hd, S, heads, B) built per call from the
//     tensors' pointers and strides, boxes of 64 columns (one 128-byte
//     swizzle row) x 128 rows.  Q once; K and V each through a ring of two
//     stages with full/empty mbarriers, so the next tiles' copies overlap
//     this tile's products.  TMA fills rows >= S with zeros, and the
//     columns past hd where hd is no multiple of 64: hd 80 and 32 are
//     padded to 128 and 64 in shared memory.  Q.K^T skips the padding
//     (ceil(hd / 16) k16 steps); P.V multiplies it (N is the padded hd) and
//     drops those columns at the store.
//   * overlap: tile t's Q.K^T and tile t - 1's P.V are issued together, so
//     the softmax of t runs while the tensor cores do P.V of t - 1; the two
//     consumer warpgroups take turns to issue (named barriers), so one's
//     softmax meets the other's products.
//   * S = Q K^T: both operands K-major in shared memory, S left unscaled;
//     hd^-0.5 (times log2 e) is applied in f32 after the product, inside
//     the exponent: p = 2^(s c - m c), one FFMA and ex2.approx a score.
//   * masks (-1e30; kpos < S, causal, window) only on tiles that cross the
//     diagonal, the window's edge or S; running max, alpha and sum in f32
//     registers, the row's max over its quad of threads by shuffles.  While
//     a row has met no live key (m = -1e30) its p is 0, not 1.
//   * O += P V with P split: P_hi = bf16(P), P_lo = bf16(P - P_hi), both as
//     the register A operand of a wgmma against the same V tile (B
//     MN-major), into one f32 accumulator.  A single bf16 P loses 8 bits of
//     each probability and misses the one-bf16-ulp gate against the plain
//     version on ~10 % of outputs; hi/lo keeps ~16 bits.
//   * epilogue: O / max(l, 1e-30) in f32, rounded to bf16 once, stored
//     straight from registers to the rows < S by the output's strides.
//     Under autograd (flash_attention_bf16_fwd) the same kernel also stores
//     the f32 output before that rounding and each row's log-sum-exp; the
//     prefill's instantiation (kSave false) is the body above unchanged.
//
// bf16 backward (tc::flash_bwd_dq_kernel, tc::flash_bwd_dkdv_kernel).
// Replaces no TPU kernel: the reference has no backward for its Pallas
// kernel and trains through its jnp _chunked_attention, as the port's plain
// path (models/attention.py) does on the CPU.  Added because that plain path
// on the card forms each 256-row chunk's full (chunk x S) score block in f32
// on the CUDA cores, masked but not skipped, forward, remat and backward:
// ~40 % of granite-8b's 4,096-token train step.
//   dV = P^T dO, dP = dO V^T, dS = P o (dP - D), dK = scale dS^T Q,
//   dQ = scale dS K, with P = 2^(S c - lse log2 e) recomputed from q, k and
//   the forward's lse (the scale applied after the product, as there), and
//   D = rowsum(dO o O) from the forward's unrounded f32 output (D from the
//   bf16 output would put a bf16-sized error into every dS where dP ~ D).
// Bound on the H100: operations.  At granite-8b's train step (B 1, H 32,
// KV 8, S 4096, hd 128, causal) the 268.5 M live pairs need 8 * hd flops
// each for dV, dP, dK and dQ: 0.278 ms at 989 TFLOP/s.  The design does 20 *
// hd a pair (S and dP twice, the f32-held P and dS as two bf16 products
// each), its own floor 2.5x the bound.
//   * precision as the plain path's: S, P, dP, dS and D in f32; products of
//     bf16 operands (q, k, v, dO) are exact in the f32 accumulators; every
//     f32-held operand (P, dS) enters an MMA as x_hi = bf16(x), x_lo =
//     bf16(x - x_hi); dq, dk, dv rounded once from f32.
//   * no atomics, so two runs give the same bits: a dQ pass, one block per
//     (b * H + h, 128 q rows), over the key tiles the forward visits (64
//     keys a step; causal tiles above the diagonal and outside the window
//     skipped), which also writes D; then a dK/dV pass, one block per
//     (b * KV + kv head, 128 keys), over the q tiles that see those keys (64
//     rows a step) of each of the G query heads, GQA summed in the f32
//     accumulators.  Each pass recomputes S and dP.
//   * the forward's shape: warpgroups 0 and 1 consume 64 rows each,
//     setmaxnreg 240; one thread of warpgroup 2 issues TMA loads of the
//     block's two fixed tiles (128 rows) and a two-stage ring of the step's
//     two tiles (64 rows; the dK/dV pass's with the step's lse and D rows
//     by a bulk copy).  S and dP by wgmma from shared memory (m64n64, both
//     K-major); dQ, dK and dV from the fragments in registers (the
//     accumulator layout of S is the A fragment layout) against an MN-major
//     tile.  The dQ pass retires a step's dS K with the next step's S and
//     dP; the dK/dV pass, which holds two accumulators, waits for each
//     product, so no register of a product in flight is needed for the
//     softmax (ptxas otherwise serialises its wgmmas; issuing dV and dK
//     together read 1.50 ms against 1.39).  hd 32 and 80 are padded as
//     above.
//   * masks (P = 0) only on tiles that cross the diagonal, the window's
//     edge or S; lse and D are padded to whole 128-row tiles, so no read
//     of them is guarded.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kBK + 4;  // row length of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// 64 rows of hd elements (row r at src + r * stride) -> dst[r * (hd + 4) + d]
// as f32 times `mul`, in 16-byte loads; rows >= valid are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride, int valid,
                                          float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int kLd = HD + 4;
  for (int i = threadIdx.x; i < kBK * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int d = (i % kPerRow) * kVec;
    float* out = dst + r * kLd + d;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + d);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        *reinterpret_cast<float4*>(out + j) =
            make_float4(to_f32(e[j]) * mul, to_f32(e[j + 1]) * mul, to_f32(e[j + 2]) * mul,
                        to_f32(e[j + 3]) * mul);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        *reinterpret_cast<float4*>(out + j) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

struct Strides {
  int64_t b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int KV, int S, int nq, Strides qs, Strides ks,
                 Strides vs, Strides os, int causal, int window, float scale) {
  constexpr int kLd = HD + 4;
  constexpr int kNC = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBQ][kLd], pre-scaled
  float* sKV = sQ + kBQ * kLd;                  // [kBK][kLd], K then V
  float* sP = sKV + kBK * kLd;                  // [kBQ][kLdP]

  const int heads = gridDim.x / nq;  // B * H
  const int iq = nq - 1 - static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = iq * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  load_tile<T, HD>(sQ, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, S - q0, scale);

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;

  float m[4], l[4], acc[4][kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  for (int t = k_first / kBK; t <= k_last / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // sQ is stored; the last tile's reads of sKV, sP are done
    load_tile<T, HD>(sKV, kb + k0 * ks.s, ks.s, S - k0, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sKV + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, then the online softmax of each row over its 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool live = kpos < S;
        if (causal) live = live && qpos >= kpos;
        if (window > 0) live = live && kpos > qpos - window;
        s[i][j] = live ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K
    load_tile<T, HD>(sKV, vb + k0 * vs.s, vs.s, S - k0, 1.f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(4 * ty + i) * kLdP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * kLdP + c0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = sKV + (c0 + kk) * kLd + tx;
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const float vv = vrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pk = kk == 0 ? p[i].x : kk == 1 ? p[i].y : kk == 2 ? p[i].z : p[i].w;
            acc[i][c] = fmaf(pk, vv, acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < S) {
      const float lsum = fmaxf(l[i], 1e-30f);
      T* orow = o + b * os.b + h * os.h + row * os.s + tx;
#pragma unroll
      for (int c = 0; c < kNC; ++c) store(orow + 16 * c, acc[i][c] / lsum);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int S,
           const int64_t* st, int causal, int window, float scale, void* stream) {
  constexpr int kLd = HD + 4;
  const int smem = static_cast<int>(sizeof(float)) * (2 * kBK * kLd + kBQ * kLdP);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (S + kBQ - 1) / kBQ;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  flash_kernel<T, HD><<<static_cast<unsigned int>(nq * B * H), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, S, nq, qs, ks, vs, os, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int S,
             int hd, const int64_t* strides, int causal, int window, float scale, void* stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, S, strides, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, S, strides, causal, window, scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, B, H, KV, S, strides, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, S, strides, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The bf16 path: wgmma on TMA-fed tiles, warp-specialised.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;           // query rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;           // keys per tile
constexpr int kStages = 2;         // K and V ring depth
constexpr int kConsumers = 256;    // warpgroups 0 and 1
constexpr int kThreads = 384;      // + warpgroup 2, whose thread 256 issues every load
constexpr int kRowBytes = 128;     // one 128-byte swizzle row: 64 bf16 of a 64-column chunk
constexpr int kChunkCols = kRowBytes / 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile of `rows` x hdp bf16 in shared memory: hdp / 64 chunks of rows x 64,
// each chunk rows x 128 bytes in TMA's 128-byte swizzle (the layout wgmma's
// 128B descriptors read).  Chunks start on 1,024-byte boundaries.
template <int HDP>
struct Layout {
  static constexpr int kChunks = HDP / kChunkCols;
  static constexpr int kQBytes = kBM * HDP * 2;
  static constexpr int kTileBytes = kBN * HDP * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // 1 + 4 * kStages mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of `bar` with this parity has completed
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

// one box of the 4-d map (hd, S, heads, B) at element coordinates c0..c3
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of this warpgroup's commit groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D(64x128, f32) = A(64x16 bf16, shared, K-major) * B(16x128 bf16, shared, K-major)
// + D if accumulate
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64x64, f32) += A(64x16 bf16, registers) * B(16x64 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64x128, f32) += A(64x16 bf16, registers) * B(16x128 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HDP>
__device__ __forceinline__ void wgmma_rs(float (&d)[HDP / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HDP == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// kSave (the forward under autograd): also the f32 output o32, unrounded,
// and the rows' natural log-sum-exp of the scaled scores, lse[bh * s_pad +
// row] for every row of the block's tile (rows >= S too, finite: the
// backward reads whole tiles).  Without it the body is the prefill's.
template <int HD, bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H,
                    int KV, int S, int nq, Strides os, int causal, int window, float scale_log2,
                    float* __restrict__ o32, Strides o32s, float* __restrict__ lse, int s_pad) {
  constexpr int HDP = HD <= 64 ? 64 : 128;  // hd padded to whole 64-column chunks
  constexpr int kSteps = (HD + 15) / 16;    // k16 steps of Q.K^T (the padding is skipped)
  using L = Layout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto bar_kfull = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_vfull = [&](int st) { return bar_q + 8 * (1 + kStages + st); };
  auto bar_kempty = [&](int st) { return bar_q + 8 * (1 + 2 * kStages + st); };
  auto bar_vempty = [&](int st) { return bar_q + 8 * (1 + 3 * kStages + st); };

  const int heads = gridDim.x / nq;  // B * H
  const int iq = nq - 1 - static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = iq * kBM;
  const int q_last = min(q0 + kBM, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int t_first = k_first / kBN;
  const int n_tiles = k_last / kBN - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_kfull(st), 1);
      mbar_init(bar_vfull(st), 1);
      mbar_init(bar_kempty(st), kConsumers);
      mbar_init(bar_vempty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps the K and V rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(sQ + c * kBM * kRowBytes, &tq, bar_q, c * kChunkCols, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        const int k0 = (t_first + t) * kBN;
        mbar_wait(bar_kempty(st), ph ^ 1);
        mbar_expect_tx(bar_kfull(st), L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sK + st * L::kTileBytes + c * kBN * kRowBytes, &tk, bar_kfull(st),
                   c * kChunkCols, k0, kvh, b);
        mbar_wait(bar_vempty(st), ph ^ 1);
        mbar_expect_tx(bar_vfull(st), L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sV + st * L::kTileBytes + c * kBN * kRowBytes, &tv, bar_vfull(st),
                   c * kChunkCols, k0, kvh, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64 wg ... + 63; thread
    // (warp w, lane) holds rows r0 = 16 w + lane / 4 and r0 + 8 of them,
    // and in each 8-column group the columns 2 (lane % 4) and + 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * (tid / 32) + (tid % 32) / 4;
    const int col = 2 * (tid % 4);
    const uint32_t sQw = sQ + wg * 64 * kRowBytes;

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    float s[kBN / 2];
    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];

    // S = Q K_t^T, one commit group: A = this warpgroup's 64 q rows, B = the
    // key tile, both K-major; a k16 step moves 32 bytes along the swizzled rows
    auto issue_qk = [&](int t) {
      const int st = t % kStages;
      mbar_wait(bar_kfull(st), (t / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // bytes into the chunk's rows
        wgmma_ss_n128(s, desc(sQw + (kk / 4) * kBM * kRowBytes + off, 16, 1024),
                      desc(sK + st * L::kTileBytes + (kk / 4) * kBN * kRowBytes + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
    };

    // O += P_hi V_t + P_lo V_t, one commit group: B = the value tile,
    // MN-major (hd contiguous); a k16 step is 16 key rows (2,048 bytes), the
    // 64-column chunks LBO apart
    auto issue_pv = [&](int t) {
      const int st = t % kStages;
      mbar_wait(bar_vfull(st), (t / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv =
            desc(sV + st * L::kTileBytes + kk * 16 * kRowBytes, kBN * kRowBytes, 1024);
        wgmma_rs<HDP>(acc, p_hi[kk], dv);
        wgmma_rs<HDP>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
    };

    // s of tile t -> its probabilities in place, alpha, the running max and
    // this thread's share of the running sum (the quad sums at the end)
    auto softmax = [&](int t) {
      const int k0 = (t_first + t) * kBN;
      // the mask, only on tiles that cross the diagonal, the window's edge or S
      const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > wq0) ||
                        (window > 0 && k0 <= wq0 + 63 - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + col + (i % 2);
          const int qpos = row0 + 8 * ((i / 2) % 2);
          bool live = kpos < S;
          if (causal) live = live && qpos >= kpos;
          if (window > 0) live = live && kpos > qpos - window;
          if (!live) s[i] = kNegInf;
        }
      }
      // rows r0 (j = 0) and r0 + 8 (j = 1), each over its quad of threads;
      // max over the unscaled s (the scale is > 0), then p = 2^(s c - m c)
      // with c = hd^-0.5 log2 e: the scale in f32 after the product.  A row
      // with no live key yet (m = -1e30) takes m c = 0, so its p is 0
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * j], s[4 * n + 2 * j + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[j], mx);
        alpha[j] = ex2((m[j] - m_new) * scale_log2);
        const float mc = m_new == kNegInf ? 0.f : m_new * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
          s[4 * n + 2 * j] = ex2(fmaf(s[4 * n + 2 * j], scale_log2, -mc));
          s[4 * n + 2 * j + 1] = ex2(fmaf(s[4 * n + 2 * j + 1], scale_log2, -mc));
          sum += s[4 * n + 2 * j] + s[4 * n + 2 * j + 1];
        }
        l[j] = l[j] * alpha[j] + sum;
        m[j] = m_new;
      }
    };

    // P = P_hi + P_lo, each bf16: the accumulator layout of S is the A
    // fragment layout of P.V, k16 step kk taking s[8 kk .. 8 kk + 7]
    auto split = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][r] = bf16x2_bits(hi);
          p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
        }
    };

    // Tile t's Q.K^T and tile t - 1's P.V are in flight together, so the
    // softmax of t overlaps P.V of t - 1 on the tensor cores; O takes
    // tile t's alpha once P.V of t - 1 has landed in it.  The two consumer
    // warpgroups take turns to issue their products (named barriers 1, 2;
    // warpgroup 0 goes first).
    auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
    auto turn_pass = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); };
    if (wg == 1) turn_pass();
    mbar_wait(bar_q, 0);
    turn_wait();
    issue_qk(0);
    turn_pass();
    wgmma_wait<0>();
    pin(s);
    mbar_arrive(bar_kempty(0));
    softmax(0);
    split();
    for (int t = 1; t < n_tiles; ++t) {
      turn_wait();
      issue_qk(t);
      issue_pv(t - 1);
      turn_pass();
      wgmma_wait<1>();
      pin(s);
      mbar_arrive(bar_kempty(t % kStages));
      softmax(t);
      wgmma_wait<0>();
      pin(acc);
      pin(p_hi);
      pin(p_lo);
      mbar_arrive(bar_vempty((t - 1) % kStages));
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      split();
    }
    turn_wait();
    issue_pv(n_tiles - 1);
    turn_pass();
    wgmma_wait<0>();
    pin(acc);
    pin(p_hi);
    pin(p_lo);
    mbar_arrive(bar_vempty((n_tiles - 1) % kStages));

    // epilogue: O / max(l, 1e-30) in f32, rounded to bf16 once, rows < S
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float lsum = l[j];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      lsum = fmaxf(lsum, 1e-30f);
      const int row = row0 + 8 * j;
      if constexpr (kSave) {
        if (tid % 4 == 0)
          lse[static_cast<int64_t>(bh) * s_pad + row] = (m[j] * scale_log2 + log2f(lsum)) * kLn2;
      }
      if (row < S) {
        __nv_bfloat16* orow = o + b * os.b + h * os.h + row * os.s + col;
#pragma unroll
        for (int n = 0; n < HDP / 8; ++n) {
          if (8 * n < HD) {
            const float x = acc[4 * n + 2 * j] / lsum, y = acc[4 * n + 2 * j + 1] / lsum;
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(x, y);
            if constexpr (kSave)
              *reinterpret_cast<float2*>(o32 + b * o32s.b + h * o32s.h + row * o32s.s + col +
                                         8 * n) = make_float2(x, y);
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime: no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, S, heads, B) view of a bf16 tensor with element strides st = (batch,
// head, row), boxes of 64 columns x `rows` rows, 128-byte swizzle; TMA fills
// whatever lies past hd or S with zeros
int make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads, int B,
             const int64_t* st, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kChunkCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// o32 and lse null: the prefill's kernel; else the forward under autograd,
// which also writes them (flash_tc_kernel's kSave).  The launches make a
// runtime call before they encode their maps: it makes the device's primary
// context current on the calling thread, which cuTensorMapEncodeTiled needs
// (autograd runs the backward, and a remat's forward, on a thread of its own).
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* o32, float* lse, int B,
           int H, int KV, int S, const int64_t* st, int causal, int window, float scale,
           void* stream) {
  using L = Layout<(HD <= 64 ? 64 : 128)>;
  const auto kernel = lse == nullptr ? flash_tc_kernel<HD, false> : flash_tc_kernel<HD, true>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, HD, S, H, B, st, kBM);
  if (rc == 0) rc = make_map(&mk, k, HD, S, KV, B, st + 3, kBN);
  if (rc == 0) rc = make_map(&mv, v, HD, S, KV, B, st + 6, kBN);
  if (rc != 0) return rc;
  const int nq = (S + kBM - 1) / kBM;
  const Strides os{st[9], st[10], st[11]};
  const Strides o32s = lse == nullptr ? Strides{0, 0, 0} : Strides{st[12], st[13], st[14]};
  kernel<<<static_cast<unsigned int>(nq * B * H), kThreads, L::kBytes,
           static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), H,
                                                KV, S, nq, os, causal, window, scale * kLog2e,
                                                o32, o32s, lse, nq * kBM);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* o32, float* lse, int B,
             int H, int KV, int S, int hd, const int64_t* strides, int causal, int window,
             float scale, void* stream) {
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, o32, lse, B, H, KV, S, strides, causal, window, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, o32, lse, B, H, KV, S, strides, causal, window, scale, stream);
    case 80:
      return launch<80>(q, k, v, o, o32, lse, B, H, KV, S, strides, causal, window, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, o32, lse, B, H, KV, S, strides, causal, window, scale,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The backward of the bf16 path: dQ, then dK and dV, by wgmma on TMA-fed
// tiles (see the note at the top of the file).
// ---------------------------------------------------------------------------
constexpr int kBwdBlk = 128;   // rows a block owns, 64 per consumer warpgroup
constexpr int kBwdStep = 64;   // rows of the other side a step brings
constexpr int kBwdStages = 2;  // ring depth of the step's tiles
static_assert(kBwdBlk == kBM, "lse and D rows are padded to the forward's q tile");

// Two tiles of kBwdBlk rows loaded once (dQ: Q, dO; dK/dV: K, V), a ring of
// two tiles of kBwdStep rows a step (dQ: K, V; dK/dV: Q, dO), and for dK/dV
// the step's lse and D rows beside them, all in TMA's 128-byte swizzle.
template <int HDP>
struct BwdLayout {
  static constexpr int kChunks = HDP / kChunkCols;
  static constexpr int kFixBytes = kBwdBlk * HDP * 2;
  static constexpr int kRingBytes = kBwdStep * HDP * 2;
  static constexpr int kVecBytes = kBwdStep * 4;
  static constexpr int kF0 = 0;
  static constexpr int kF1 = kF0 + kFixBytes;
  static constexpr int kR0 = kF1 + kFixBytes;
  static constexpr int kR1 = kR0 + kBwdStages * kRingBytes;
  static constexpr int kLse = kR1 + kBwdStages * kRingBytes;
  static constexpr int kD = kLse + kBwdStages * kVecBytes;
  static constexpr int kBar = kD + kBwdStages * kVecBytes;  // 1 + 2 * kBwdStages mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kBwdStages) + 1024;
};

// `bytes` (a multiple of 16) from global memory to shared, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// D(64x64, f32) = A(64x16 bf16, shared, K-major) * B(16x64 bf16, shared, K-major)
// + D if accumulate
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// x = hi + lo, each bf16 (lo = bf16(x - hi)): the accumulator layout of an
// m64nN product is the A fragment layout of the next, k16 step kk taking
// x[8 kk .. 8 kk + 7]
template <int N>
__device__ __forceinline__ void split_hi_lo(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], c = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, c);
      const float2 hf = __bfloat1622float2(h2);
      hi[kk][r] = bf16x2_bits(h2);
      lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
    }
}

// Is (qpos, kpos) a pair the forward kept?
__device__ __forceinline__ bool live_pair(int qpos, int kpos, int S, int causal, int window) {
  bool live = kpos < S && qpos < S;
  if (causal) live = live && qpos >= kpos;
  if (window > 0) live = live && kpos > qpos - window;
  return live;
}

// One block per (b * H + h, 128-row q tile), heaviest causal tiles first.
// D = rowsum(dO o O32) of the block's rows first (written out for the dK/dV
// pass), then over the key tiles the forward visits, 64 keys a step:
// S = Q K^T and dP = dO V^T (shared x shared), P = 2^(S c - lse log2 e),
// dS = P o (dP - D), dQ += dS_hi K + dS_lo K (registers x shared, K
// MN-major); dQ = scale * that, rounded to bf16 once.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __nv_bfloat16* __restrict__ dout, Strides dos,
                        const float* __restrict__ o32, Strides o32s, const float* __restrict__ lse,
                        float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, Strides dqs,
                        int H, int KV, int S, int s_pad, int nq, int causal, int window,
                        float scale_log2, float scale) {
  constexpr int HDP = HD <= 64 ? 64 : 128;
  constexpr int kSteps = (HD + 15) / 16;
  using L = BwdLayout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kF0, sO = base + L::kF1, sK = base + L::kR0, sV = base + L::kR1;
  const uint32_t bar_fix = base + L::kBar;
  auto bar_full = [&](int st) { return bar_fix + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_fix + 8 * (1 + kBwdStages + st); };

  const int heads = gridDim.x / nq;  // B * H
  const int iq = nq - 1 - static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = iq * kBwdBlk;
  const int q_last = min(q0 + kBwdBlk, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int t_first = k_first / kBwdStep;
  const int n_tiles = k_last / kBwdStep - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_fix, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_fix, 2 * L::kFixBytes);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(sQ + c * kBwdBlk * kRowBytes, &tq, bar_fix, c * kChunkCols, q0, h, b);
        tma_load(sO + c * kBwdBlk * kRowBytes, &tdo, bar_fix, c * kChunkCols, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kBwdStages;
        const int k0 = (t_first + t) * kBwdStep;
        mbar_wait(bar_empty(st), ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(st), 2 * L::kRingBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(sK + st * L::kRingBytes + c * kBwdStep * kRowBytes, &tk, bar_full(st),
                   c * kChunkCols, k0, kvh, b);
          tma_load(sV + st * L::kRingBytes + c * kBwdStep * kRowBytes, &tv, bar_full(st),
                   c * kChunkCols, k0, kvh, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64 wg ... + 63; thread
    // (warp w, lane) holds rows r0 = 16 w + lane / 4 and r0 + 8, and in each
    // 8-column group the columns 2 (lane % 4) and + 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * (tid / 32) + (tid % 32) / 4;
    const int col = 2 * (tid % 4);
    const uint32_t sQw = sQ + wg * 64 * kRowBytes, sOw = sO + wg * 64 * kRowBytes;

    // D = rowsum(dO o O32) of rows r0 and r0 + 8 in f32, over the row's quad
    // of threads (0 for rows >= S), and lse log2 e of the same rows
    float dd[2], l2[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + 8 * j;
      float sum = 0.f;
      if (row < S) {
        const __nv_bfloat16* drow = dout + b * dos.b + h * dos.h + row * dos.s;
        const float* orow = o32 + b * o32s.b + h * o32s.h + row * o32s.s;
        for (int c = tid % 4; c < HD / 8; c += 4) {
          const uint4 raw = *reinterpret_cast<const uint4*>(drow + 8 * c);
          const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float4 oa = *reinterpret_cast<const float4*>(orow + 8 * c);
          const float4 ob = *reinterpret_cast<const float4*>(orow + 8 * c + 4);
          const float2 e0 = __bfloat1622float2(e[0]), e1 = __bfloat1622float2(e[1]);
          const float2 e2 = __bfloat1622float2(e[2]), e3 = __bfloat1622float2(e[3]);
          sum = fmaf(e0.x, oa.x, sum);
          sum = fmaf(e0.y, oa.y, sum);
          sum = fmaf(e1.x, oa.z, sum);
          sum = fmaf(e1.y, oa.w, sum);
          sum = fmaf(e2.x, ob.x, sum);
          sum = fmaf(e2.y, ob.y, sum);
          sum = fmaf(e3.x, ob.z, sum);
          sum = fmaf(e3.y, ob.w, sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dd[j] = sum;
      const int64_t at = static_cast<int64_t>(bh) * s_pad + row;
      if (tid % 4 == 0) dsum[at] = sum;
      l2[j] = lse[at] * kLog2e;
    }

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float s[kBwdStep / 2], dp[kBwdStep / 2];
    uint32_t fhi[kBwdStep / 16][4], flo[kBwdStep / 16][4];
    mbar_wait(bar_fix, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kBwdStages;
      const int k0 = (t_first + t) * kBwdStep;
      const uint32_t sKs = sK + st * L::kRingBytes, sVs = sV + st * L::kRingBytes;
      mbar_wait(bar_full(st), (t / kBwdStages) & 1);
      // S = Q K^T and dP = dO V^T, one commit group (both operands K-major);
      // it also retires the last step's dS K
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(s, desc(sQw + (kk / 4) * kBwdBlk * kRowBytes + off, 16, 1024),
                     desc(sKs + (kk / 4) * kBwdStep * kRowBytes + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(dp, desc(sOw + (kk / 4) * kBwdBlk * kRowBytes + off, 16, 1024),
                     desc(sVs + (kk / 4) * kBwdStep * kRowBytes + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      pin(acc);
      pin(fhi);
      pin(flo);
      if (t > 0) mbar_arrive(bar_empty((t - 1) % kBwdStages));
      const bool edge = wq0 + 64 > S || k0 + kBwdStep > S ||
                        (causal && k0 + kBwdStep - 1 > wq0) ||
                        (window > 0 && k0 <= wq0 + 63 - window);
#pragma unroll
      for (int i = 0; i < kBwdStep / 2; ++i) {
        const int j = (i / 2) % 2;
        float p = ex2(fmaf(s[i], scale_log2, -l2[j]));
        if (edge && !live_pair(row0 + 8 * j, k0 + 8 * (i / 4) + col + (i % 2), S, causal, window))
          p = 0.f;
        s[i] = p * (dp[i] - dd[j]);
      }
      split_hi_lo<kBwdStep>(s, fhi, flo);
      // dQ += dS_hi K + dS_lo K: B = the key tile, MN-major (hd contiguous)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdStep / 16; ++kk) {
        const uint64_t dk = desc(sKs + kk * 16 * kRowBytes, kBwdStep * kRowBytes, 1024);
        wgmma_rs<HDP>(acc, fhi[kk], dk);
        wgmma_rs<HDP>(acc, flo[kk], dk);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    pin(acc);
    pin(fhi);
    pin(flo);
    mbar_arrive(bar_empty((n_tiles - 1) % kBwdStages));

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + 8 * j;
      if (row < S) {
        __nv_bfloat16* qrow = dq + b * dqs.b + h * dqs.h + row * dqs.s + col;
#pragma unroll
        for (int n = 0; n < HDP / 8; ++n) {
          if (8 * n < HD) {
            *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * n) = __floats2bfloat162_rn(
                acc[4 * n + 2 * j] * scale, acc[4 * n + 2 * j + 1] * scale);
          }
        }
      }
    }
  }
}

// One block per (b * KV + kv head, 128-key tile), the heaviest causal tile
// (the first) first.  K and V are loaded once; each step brings 64 q rows of
// one of the G query heads of the KV head, with their lse and D.  In the
// transposed frame (keys as rows): S^T = K Q^T and dP^T = V dO^T, P^T =
// 2^(S^T c - lse log2 e), dV += P^T_hi dO + P^T_lo dO, dS^T = P^T o (dP^T -
// D), dK += dS^T_hi Q + dS^T_lo Q; the G heads summed in the f32
// accumulators; dK = scale * that and dV rounded to bf16 once.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                          const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                          Strides dks, __nv_bfloat16* __restrict__ dv, Strides dvs, int H, int KV,
                          int S, int s_pad, int nk, int causal, int window, float scale_log2,
                          float scale) {
  constexpr int HDP = HD <= 64 ? 64 : 128;
  constexpr int kSteps = (HD + 15) / 16;
  using L = BwdLayout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base + L::kF0, sV = base + L::kF1, sQ = base + L::kR0, sO = base + L::kR1;
  const uint32_t sL = base + L::kLse, sD = base + L::kD;
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* d_s = reinterpret_cast<const float*>(smem_raw + (sD - raw));
  const uint32_t bar_fix = base + L::kBar;
  auto bar_full = [&](int st) { return bar_fix + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_fix + 8 * (1 + kBwdStages + st); };

  const int groups = gridDim.x / nk;  // B * KV
  const int it = static_cast<int>(blockIdx.x) / groups;
  const int bkv = static_cast<int>(blockIdx.x) % groups;
  const int b = bkv / KV, kvh = bkv % KV;
  const int G = H / KV;
  const int k0 = it * kBwdBlk;
  const int k_last = min(k0 + kBwdBlk, S) - 1;
  const int q_first = causal ? k0 : 0;
  const int q_last = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  const int t_first = q_first / kBwdStep;
  const int n_qt = q_last / kBwdStep - t_first + 1;
  const int n_steps = G * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(bar_fix, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_fix, 2 * L::kFixBytes);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(sK + c * kBwdBlk * kRowBytes, &tk, bar_fix, c * kChunkCols, k0, kvh, b);
        tma_load(sV + c * kBwdBlk * kRowBytes, &tv, bar_fix, c * kChunkCols, k0, kvh, b);
      }
      for (int t = 0; t < n_steps; ++t) {
        const int st = t % kBwdStages;
        const int h = kvh * G + t / n_qt;
        const int q0 = (t_first + t % n_qt) * kBwdStep;
        mbar_wait(bar_empty(st), ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(st), 2 * L::kRingBytes + 2 * L::kVecBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(sQ + st * L::kRingBytes + c * kBwdStep * kRowBytes, &tq, bar_full(st),
                   c * kChunkCols, q0, h, b);
          tma_load(sO + st * L::kRingBytes + c * kBwdStep * kRowBytes, &tdo, bar_full(st),
                   c * kChunkCols, q0, h, b);
        }
        const int64_t at = static_cast<int64_t>(b * H + h) * s_pad + q0;
        bulk_load(sL + st * L::kVecBytes, lse + at, L::kVecBytes, bar_full(st));
        bulk_load(sD + st * L::kVecBytes, dsum + at, L::kVecBytes, bar_full(st));
      }
    }
  } else {
    // consumers: warpgroup wg owns keys k0 + 64 wg ... + 63, the rows of the
    // transposed frame; thread (warp w, lane) holds key rows r0 = 16 w +
    // lane / 4 and r0 + 8, and in each 8-column group of queries the columns
    // 2 (lane % 4) and + 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int wk0 = k0 + 64 * wg;
    const int row0 = wk0 + 16 * (tid / 32) + (tid % 32) / 4;
    const int col = 2 * (tid % 4);
    const uint32_t sKw = sK + wg * 64 * kRowBytes, sVw = sV + wg * 64 * kRowBytes;

    float dka[HDP / 2], dva[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) {
      dka[i] = 0.f;
      dva[i] = 0.f;
    }
    float s[kBwdStep / 2], dp[kBwdStep / 2];
    uint32_t fhi[kBwdStep / 16][4], flo[kBwdStep / 16][4];
    mbar_wait(bar_fix, 0);
    for (int t = 0; t < n_steps; ++t) {
      const int st = t % kBwdStages;
      const int q0 = (t_first + t % n_qt) * kBwdStep;
      const uint32_t sQs = sQ + st * L::kRingBytes, sOs = sO + st * L::kRingBytes;
      const float* ls = lse_s + st * kBwdStep;
      const float* ds = d_s + st * kBwdStep;
      mbar_wait(bar_full(st), (t / kBwdStages) & 1);
      // S^T = K Q^T and dP^T = V dO^T, one commit group (both operands
      // K-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(s, desc(sKw + (kk / 4) * kBwdBlk * kRowBytes + off, 16, 1024),
                     desc(sQs + (kk / 4) * kBwdStep * kRowBytes + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(dp, desc(sVw + (kk / 4) * kBwdBlk * kRowBytes + off, 16, 1024),
                     desc(sOs + (kk / 4) * kBwdStep * kRowBytes + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      // P^T = 2^(S^T c - lse log2 e) and dS^T = P^T o (dP^T - D), the
      // columns being queries; no product is in flight here, so the
      // registers of s, dp and both accumulators may all be live
      const bool edge = q0 + kBwdStep > S || wk0 + 64 > S || (causal && q0 < wk0 + 63) ||
                        (window > 0 && q0 + kBwdStep - 1 >= wk0 + window);
#pragma unroll
      for (int i = 0; i < kBwdStep / 2; ++i) {
        const int qc = 8 * (i / 4) + col + (i % 2);
        float p = ex2(fmaf(s[i], scale_log2, -ls[qc] * kLog2e));
        if (edge && !live_pair(q0 + qc, row0 + 8 * ((i / 2) % 2), S, causal, window)) p = 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - ds[qc]);
      }
      split_hi_lo<kBwdStep>(s, fhi, flo);
      // dV += P^T_hi dO + P^T_lo dO: B = the dO tile, MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdStep / 16; ++kk) {
        const uint64_t dob = desc(sOs + kk * 16 * kRowBytes, kBwdStep * kRowBytes, 1024);
        wgmma_rs<HDP>(dva, fhi[kk], dob);
        wgmma_rs<HDP>(dva, flo[kk], dob);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(dva);
      pin(fhi);
      pin(flo);
      split_hi_lo<kBwdStep>(dp, fhi, flo);
      // dK += dS^T_hi Q + dS^T_lo Q: B = the Q tile, MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdStep / 16; ++kk) {
        const uint64_t qb = desc(sQs + kk * 16 * kRowBytes, kBwdStep * kRowBytes, 1024);
        wgmma_rs<HDP>(dka, fhi[kk], qb);
        wgmma_rs<HDP>(dka, flo[kk], qb);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(dka);
      pin(fhi);
      pin(flo);
      mbar_arrive(bar_empty(st));
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + 8 * j;
      if (row < S) {
        __nv_bfloat16* krow = dk + b * dks.b + kvh * dks.h + row * dks.s + col;
        __nv_bfloat16* vrow = dv + b * dvs.b + kvh * dvs.h + row * dvs.s + col;
#pragma unroll
        for (int n = 0; n < HDP / 8; ++n) {
          if (8 * n < HD) {
            *reinterpret_cast<__nv_bfloat162*>(krow + 8 * n) = __floats2bfloat162_rn(
                dka[4 * n + 2 * j] * scale, dka[4 * n + 2 * j + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * n) =
                __floats2bfloat162_rn(dva[4 * n + 2 * j], dva[4 * n + 2 * j + 1]);
          }
        }
      }
    }
  }
}

// st: (batch, head, row) element strides of q, k, v, o32, dout, dq, dk, dv
template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const float* o32, const void* dout,
               const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int H, int KV,
               int S, const int64_t* st, int causal, int window, float scale, void* stream) {
  using L = BwdLayout<(HD <= 64 ? 64 : 128)>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dQ pass reads q and dout in boxes of kBwdBlk rows and k, v in
  // kBwdStep; the dK/dV pass the other way round
  CUtensorMap fq, fdo, rk, rv, rq, rdo, fk, fv;
  int rc = make_map(&fq, q, HD, S, H, B, st, kBwdBlk);
  if (rc == 0) rc = make_map(&fdo, dout, HD, S, H, B, st + 12, kBwdBlk);
  if (rc == 0) rc = make_map(&rk, k, HD, S, KV, B, st + 3, kBwdStep);
  if (rc == 0) rc = make_map(&rv, v, HD, S, KV, B, st + 6, kBwdStep);
  if (rc == 0) rc = make_map(&rq, q, HD, S, H, B, st, kBwdStep);
  if (rc == 0) rc = make_map(&rdo, dout, HD, S, H, B, st + 12, kBwdStep);
  if (rc == 0) rc = make_map(&fk, k, HD, S, KV, B, st + 3, kBwdBlk);
  if (rc == 0) rc = make_map(&fv, v, HD, S, KV, B, st + 6, kBwdBlk);
  if (rc != 0) return rc;
  const int nq = (S + kBwdBlk - 1) / kBwdBlk;
  const int s_pad = nq * kBwdBlk;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dq_kernel<HD><<<static_cast<unsigned int>(nq * B * H), kThreads, L::kBytes, cs>>>(
      fq, rk, rv, fdo, static_cast<const __nv_bfloat16*>(dout), Strides{st[12], st[13], st[14]},
      o32, Strides{st[9], st[10], st[11]}, lse, dsum, static_cast<__nv_bfloat16*>(dq),
      Strides{st[15], st[16], st[17]}, H, KV, S, s_pad, nq, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<HD><<<static_cast<unsigned int>(nq * B * KV), kThreads, L::kBytes, cs>>>(
      rq, fk, fv, rdo, lse, dsum, static_cast<__nv_bfloat16*>(dk), Strides{st[18], st[19], st[20]},
      static_cast<__nv_bfloat16*>(dv), Strides{st[21], st[22], st[23]}, H, KV, S, s_pad, nq,
      causal, window, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bwd(const void* q, const void* k, const void* v, const float* o32, const void* dout,
                 const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int H,
                 int KV, int S, int hd, const int64_t* st, int causal, int window, float scale,
                 void* stream) {
  switch (hd) {
    case 32:
      return launch_bwd<32>(q, k, v, o32, dout, lse, dsum, dq, dk, dv, B, H, KV, S, st, causal,
                            window, scale, stream);
    case 64:
      return launch_bwd<64>(q, k, v, o32, dout, lse, dsum, dq, dk, dv, B, H, KV, S, st, causal,
                            window, scale, stream);
    case 80:
      return launch_bwd<80>(q, k, v, o32, dout, lse, dsum, dq, dk, dv, B, H, KV, S, st, causal,
                            window, scale, stream);
    case 128:
      return launch_bwd<128>(q, k, v, o32, dout, lse, dsum, dq, dk, dv, B, H, KV, S, st, causal,
                             window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// strides: 12 int64 element strides, (batch, head, row) of q, k, v, out in
// that order; every tensor's hd elements are contiguous.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int KV, int S, int hd, const int64_t* strides,
                                   int causal, int window, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, B, H, KV, S, hd, strides, causal, window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int KV, int S, int hd, const int64_t* strides,
                                    int causal, int window, float scale, void* stream) {
  return tc::dispatch(q, k, v, o, nullptr, nullptr, B, H, KV, S, hd, strides, causal, window,
                      scale, stream);
}

// The forward under autograd: flash_attention_bf16, and also o32, the f32
// output before its rounding (strides 12..14 of 15), and lse, the rows'
// natural log-sum-exp of the scaled scores, (B, H, s_pad) f32 contiguous
// with s_pad = S rounded up to 128.
extern "C" int flash_attention_bf16_fwd(const void* q, const void* k, const void* v, void* o,
                                        float* o32, float* lse, int B, int H, int KV, int S, int hd,
                                        const int64_t* strides, int causal, int window, float scale,
                                        void* stream) {
  return tc::dispatch(q, k, v, o, o32, lse, B, H, KV, S, hd, strides, causal, window, scale,
                      stream);
}

// The backward: dq, dk, dv (bf16, by their strides) from q, k, v, the
// forward's o32 and lse, and dout (bf16); dsum, (B, H, s_pad) f32, receives
// D = rowsum(dout o o32).  strides: 24, (batch, head, row) of q, k, v, o32,
// dout, dq, dk, dv.  Two launches: dQ (and D), then dK and dV.
extern "C" int flash_attention_bf16_bwd(const void* q, const void* k, const void* v,
                                        const float* o32, const void* dout, const float* lse,
                                        float* dsum, void* dq, void* dk, void* dv, int B, int H,
                                        int KV, int S, int hd, const int64_t* strides, int causal,
                                        int window, float scale, void* stream) {
  return tc::dispatch_bwd(q, k, v, o32, dout, lse, dsum, dq, dk, dv, B, H, KV, S, hd, strides,
                          causal, window, scale, stream);
}
