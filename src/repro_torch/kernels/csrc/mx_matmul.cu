// Fused MX GEMM over the unpacked weight layout, for Hopper:
//     y = Q_mx(x) @ deq(w),   f32 out.
//
// Replaces the Pallas kernel ``mx_matmul`` of the JAX package
// (src/repro/kernels/mx_matmul.py:96, its ``pallas_call`` at :107), reached
// from ``ops.mx_gemm``.
//
// Inputs: x (M, K) f32; w codes (K, N) u8, one code per byte (any MX format:
// mxfp4, mxint4, mxfp6, mxfp8, mxint8); w scales (K/32, N) f32; y (M, N)
// f32. The activations are quantized to the same format as the weights.
// The tile, its bound and its design are in mx_gemm.cuh. This layout's f32
// scales need not be powers of two, so they are applied in registers to the
// f32 partial product of each 32-deep K step (one MX block, two k16 wgmmas),
// not folded into the bf16 weight tile.
#include "mx_gemm.cuh"

// x (M, K) f32, xq scratch (M, K) bf16, wc (K, N) u8, ws (K/32, N) f32,
// y (M, N) f32. K % 32 == 0. Returns cudaGetLastError() after the launches.
extern "C" int mx_gemm_launch(const void* x, void* xq, const void* wc,
                              const void* ws, void* y, int M, int N, int K,
                              int fmt, void* stream) {
  if (M <= 0 || N <= 0 || K % 32 != 0 || fmt < FMT_FP4 || fmt > FMT_FP6)
    return (int)cudaErrorInvalidValue;
  mxgemm::ByteF32Weights w{static_cast<const uint8_t*>(wc),
                           static_cast<const float*>(ws)};
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(wc) % 16 == 0
                   && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  return mxgemm::launch(x, xq, w, vec, y, 1, M, N, K, fmt, 0, stream);
}
