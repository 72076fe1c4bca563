// Packed-native fused MX GEMM for Hopper:
//     y = Q_mx(x [· blockdiag(H32)]) @ deq(w),   f32 out.
//
// Replaces the Pallas kernel ``mx_matmul_packed`` of the JAX package
// (src/repro/kernels/mx_matmul.py:170, its ``pallas_call`` at :203).
//
// Inputs: x (M, K) f32; w packed (K/2, N) u8, code 2i in the low nibble of
// byte i along K; w scales (K/32, N) u8 E8M0; y (M, N) f32. The tile loop,
// its bound on the card and its design are in mx_gemm.cuh; this layout's
// power-of-two scales are folded into the bf16 weight tile (exact).
#include "mx_gemm.cuh"

// x (M, K) f32, xq scratch (M, K) bf16, wp (K/2, N) u8, ws (K/32, N) u8,
// y (M, N) f32. K % 32 == 0. Returns cudaGetLastError() after the launches.
extern "C" int mx_gemm_packed_launch(const void* x, void* xq, const void* wp,
                                     const void* ws, void* y, int M, int N,
                                     int K, int fmt, int t3, void* stream) {
  if (M <= 0 || N <= 0 || K % 32 != 0 || fmt_bits(fmt) != 4)
    return (int)cudaErrorInvalidValue;
  mxgemm::PackedE8M0Weights w{static_cast<const uint8_t*>(wp),
                              static_cast<const uint8_t*>(ws)};
  return mxgemm::launch(x, xq, w, y, M, N, K, fmt, t3, stream);
}
