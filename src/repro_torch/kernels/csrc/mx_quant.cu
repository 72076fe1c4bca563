// Standalone MX quantizers for Hopper: x (M, K) f32 -> codes (M, K) u8 (one
// symmetric code per byte) + scales (M, K/32) f32.
//
// Replaces two Pallas kernels of the JAX package:
//   * ``mx_quant`` (src/repro/kernels/mx_quant.py:72, ``pallas_call`` :88),
//     reached from ``ops.mx_quantize``;
//   * ``hadamard_quant`` (src/repro/kernels/hadamard_quant.py:46,
//     ``pallas_call`` :59), the online T3: blockdiag(H32) rotation, then the
//     same encode; reached from ``ops.t3_quantize``.
// Every MX format: mxfp4, mxint4, mxfp6, mxfp8, mxint8.
//
// What bounds it on an H100: bytes — 4 read and 1 + 1/8 written per element,
// against a handful of compares per element (T3 adds the rotation, a 5-step
// f64 butterfly per element; its time against the bound is in PERF.md).
//
// Design (simple first): one thread per 32-block runs ``mx_encode_block``
// (mx_common.cuh) — the steps and the T3 rotation every kernel's encode
// shares, so one definition decides every snap — and writes the 32 codes as
// two 16-byte stores and the block scale 2^sexp (1.0 for an all-zero block).
#include "mx_common.cuh"

namespace {

constexpr int NT = 128;

template <bool T3>
__global__ void __launch_bounds__(NT)
mx_quant_kernel(const float* __restrict__ x, uint8_t* __restrict__ codes,
                float* __restrict__ scales, long long nblk, int fmt) {
  const long long blk = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= nblk) return;
  const float* src = x + blk * 32;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    float4 f = *reinterpret_cast<const float4*>(src + i);
    v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
  }
  int code[32];
  const int sexp = mx_encode_block<true>(fmt, v, T3, code);
  scales[blk] = ldexpf(1.0f, sexp);
  __align__(16) uint8_t c8[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c8[i] = (uint8_t)code[i];
  uint4* dst = reinterpret_cast<uint4*>(codes + blk * 32);
  dst[0] = reinterpret_cast<const uint4*>(c8)[0];
  dst[1] = reinterpret_cast<const uint4*>(c8)[1];
}

template <bool T3>
int launch(const void* x, void* codes, void* scales, int M, int K, int fmt,
           void* stream) {
  if (M <= 0 || K <= 0 || K % 32 != 0 || fmt < FMT_FP4 || fmt > FMT_FP6)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (long long)M * (K / 32);
  mx_quant_kernel<T3><<<(unsigned)((nblk + NT - 1) / NT), NT, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(codes),
      static_cast<float*>(scales), nblk, fmt);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32 (16-byte aligned), codes (M, K) u8, scales (M, K/32) f32.
extern "C" int mx_quant_launch(const void* x, void* codes, void* scales,
                               int M, int K, int fmt, void* stream) {
  return launch<false>(x, codes, scales, M, K, fmt, stream);
}

extern "C" int hadamard_quant_launch(const void* x, void* codes, void* scales,
                                     int M, int K, int fmt, void* stream) {
  return launch<true>(x, codes, scales, M, K, fmt, stream);
}
