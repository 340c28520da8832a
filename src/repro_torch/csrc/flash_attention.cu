// Blocked online-softmax (flash) attention with GQA, causal masking and an
// optional sliding window:
//   out[b,h,i,:] = sum_j softmax_j(s[i,j]) v[b,h/G,j,:],
//   s[i,j] = (f32(q[b,h,i,:]) * f32(hd^-0.5)) . f32(k[b,h/G,j,:]),
// masked to -1e30 unless j < S, (causal) j <= i and (window > 0)
// j > i - window.  Softmax and accumulation in f32; out in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_kernel at :33, pl.pallas_call at :106), whose grid walks the KV blocks of
// one q block in order with the running max, sum and accumulator in VMEM.
//
// Bound on the H100: operations.  At granite-8b's prefill (B 2, H 32, KV 8,
// S 4096, hd 128, bf16, causal) the live (i, j) pairs need
// 4 * hd flops each, ~2.75e11 flops a call: 0.28 ms at the 989 TFLOP/s of
// the bf16 tensor cores, against 0.08 ms for its 134 MB of q, k, v and out.
// This first kernel does not reach the tensor cores: it does every product
// as an f32 FMA (67 TFLOP/s peak outside the tensor cores), which also holds
// the f32 path to the plain version at 2e-5.  wgmma/TMA are later work.
//
// Design:
//   * one block of 256 threads per (b*H + h, 64-row q tile), the heaviest
//     causal tiles first; a loop over 64-key tiles takes the place of the
//     TPU's sequential KV grid axis, and runs only from the first tile the
//     window keeps to the last the causal mask keeps (the pl.when skip);
//   * GQA: query head h reads KV head h / (H / KV); K/V are never repeated;
//   * tiles are staged in shared memory as f32 rows of hd + 4 (16-byte
//     aligned rows, conflict-free float4 reads); K and V share one buffer.
//     Rows >= S are zero-filled and never read from device memory, and
//     keys >= S are masked: the ragged tail stays finite;
//   * thread (ty, tx) owns query rows 4ty..4ty+3, the score columns
//     tx + 16j (j < 4) and the output columns tx + 16c (c < hd/16); a row's
//     max and sum are reduced across its 16 threads with shuffles;
//   * masking uses the finite -1e30 as the reference does: a row whose
//     first visited tile is wholly masked gets m = -1e30 and p = 1 there,
//     and the next tile's alpha = exp(-1e30 - m) = 0 wipes that out
//     (every row meets its diagonal).  -inf would give exp(-inf + inf) = NaN;
//   * plain expf and IEEE division (no fast math); out = acc / max(l, 1e-30).
//   * q, k, v and out are addressed by (batch, head, row) strides with
//     contiguous hd, so the model hands over its (B, S, H, hd) tensors as
//     transposed views without copies.
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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, hd, strides, causal, window, scale,
                                 stream);
}
