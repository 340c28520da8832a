// Int8 stochastic-rounding round-trip of one payload tensor:
//   q = x / s;  lo = floor(q);  out = clip(lo + (u < q - lo), -127, 127) * s
//
// Replaces the TPU kernel src/repro/kernels/codec_ops.py:int8_roundtrip
// (_int8_kernel).  The uniforms u and the per-tensor scale s are computed
// by the caller (repro_torch.kernels.ops.int8_roundtrip), as on the TPU.
//
// Bound on the H100: device-memory bandwidth.  It reads x and u and writes
// out once, 12 bytes per element for ~7 flops, so a 200,704-element leaf
// (fc0.w of the F-MNIST CNN) moves 2.4 MB, ~0.7 us at 3.35 TB/s; the
// small leaves of a payload are bound by launch latency instead.
//
// Design: one thread per element, neighbouring threads on neighbouring
// elements so every warp load is one coalesced line.  The scale is read
// from device memory (no host sync).  The result must be bit-identical to
// the plain PyTorch version given the same x, u and s, so every step is
// correctly rounded: __fdiv_rn for the quotient (not a multiply by the
// reciprocal), floorf, a plain compare, fmaxf/fminf for the clip, and the
// _rn intrinsics for the add, subtract and final multiply; the file is
// also compiled with -fmad=false so nothing is contracted into an FMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void int8_roundtrip_kernel(const float* __restrict__ x, const float* __restrict__ u,
                                      const float* __restrict__ scale, float* __restrict__ out,
                                      int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float s = *scale;
  const float q = __fdiv_rn(x[i], s);
  const float lo = floorf(q);
  const float up = u[i] < __fsub_rn(q, lo) ? 1.f : 0.f;
  const float rnd = fminf(fmaxf(__fadd_rn(lo, up), -127.f), 127.f);
  out[i] = __fmul_rn(rnd, s);
}

}  // namespace

extern "C" int int8_roundtrip(const void* x, const void* u, const void* scale, void* out,
                              int64_t n, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  int8_roundtrip_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(scale), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
