// Packed-native fused MX GEMM for Hopper:
//     y = Q_mx(x [· blockdiag(H32)]) @ deq(w),   f32 out.
//
// Replaces the Pallas kernel ``mx_matmul_packed`` of the JAX package
// (src/repro/kernels/mx_matmul.py:170, its ``pallas_call`` at :203).
//
// Inputs: x (M, K) f32; w packed (K/2, N) u8, code 2i in the low nibble of
// byte i along K; w scales (K/32, N) u8 E8M0; y (M, N) f32.
//
// What bounds it on an H100: bytes. At decode (M = a few lanes) the packed
// weights (K*N*(1/2 + 1/32) bytes), at prefill (M = lanes x 1024) the f32
// activations and outputs; both sit far below the tensor-core rate. This
// simple version reaches neither bound: at M = 4 it runs N/64 blocks (14 to
// 76 on 132 SMs), each walking all of K, so it is bound by how few SMs
// work. The decoded operands are E2M1 / INT4 grid values times powers of
// two, exact in bf16, so a bf16 tensor-core product with f32 accumulation
// differs from the f32 plain version only in summation order.
//
// Design (simple first): pass 1 quantizes the activations, one thread per
// 32-block (the optional T3 rotation of the block is accumulated in f64,
// where the products of f32 values are exact, and rounded once — the same
// definition as the plain version), and writes the dequantized values as
// bf16 (exact). Pass 2 is a 64x64x32 WMMA tile loop: each K step stages the
// bf16 activation tile and decodes one MX block row of the nibble-packed
// weight tile into shared memory, then four warps issue bf16 m16n16k16 MMAs
// into f32 accumulators. No dense weight exists outside shared memory.
// Making it fast (wgmma, TMA, a pipelined ring, split-K for decode) is
// later work.
#include <mma.h>

#include "mx_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8;   // bf16 elements; 80-byte rows keep 32-byte
constexpr int LDB = BN + 8;   // alignment of every 16-row fragment
constexpr int LDC = BN + 4;   // floats

__global__ void act_quant_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ xq, int M, int K,
                                 int fmt, int t3) {
  const int nb = K / 32;
  const long long blk = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= (long long)M * nb) return;
  const float* src = x + blk * 32;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    float4 f = *reinterpret_cast<const float4*>(src + i);
    v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
  }
  if (t3) {
    // y_c = sum_b x_b H[b][c], H the Sylvester-ordered Hadamard with entries
    // +-f32(1/sqrt(32)): products exact in f64, one rounding to f32 at the end
    const double h = (double)(float)(1.0 / sqrt(32.0));
    float y[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      double acc = 0.0;
#pragma unroll
      for (int b = 0; b < 32; ++b)
        acc = fma((double)v[b], (__popc(b & c) & 1) ? -h : h, acc);
      y[c] = (float)acc;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = y[i];
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const int sexp = block_scale_exp(fmt, amax);
  const float scale = ldexpf(1.0f, sexp);
  __align__(16) __nv_bfloat16 out[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    out[i] = __float2bfloat16_rn(decode_code(fmt, quant_code(fmt, v[i], scale))
                                 * scale);
  uint4* dst = reinterpret_cast<uint4*>(xq + blk * 32);
  const uint4* s4 = reinterpret_cast<const uint4*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = s4[i];
}

__global__ void __launch_bounds__(128)
mx_gemm_kernel(const __nv_bfloat16* __restrict__ A,
               const uint8_t* __restrict__ wp, const uint8_t* __restrict__ ws,
               float* __restrict__ Y, int M, int N, int K, int fmt) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[BM * LDC];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // 2 x 2 warps of 32 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int center = fmt_center(fmt);
  const uint8_t zero_byte = (uint8_t)(center | (center << 4));

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: 64 rows x 32 bf16 = 4 x 16-byte chunks per row
    for (int i = tid; i < BM * 4; i += blockDim.x) {
      const int r = i >> 2, c = i & 3;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0
                                              + c * 8);
      *reinterpret_cast<uint4*>(As + r * LDA + c * 8) = val;
    }
    // weight tile: 16 packed rows (one MX block along K) x 64 columns
    for (int i = tid; i < (BK / 2) * BN; i += blockDim.x) {
      const int pr = i / BN, c = i % BN, n = n0 + c;
      uint8_t b = zero_byte;
      int sb = 127;
      if (n < N) {
        b = wp[(size_t)(k0 / 2 + pr) * N + n];
        sb = ws[(size_t)(k0 / 32) * N + n];
      }
      const float s = e8m0_scale(sb);
      Bs[(2 * pr) * LDB + c] = __float2bfloat16_rn(decode_code(fmt, b & 0xF) * s);
      Bs[(2 * pr + 1) * LDB + c] = __float2bfloat16_rn(decode_code(fmt, b >> 4) * s);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < M && n0 + c < N) Y[(size_t)(m0 + r) * N + n0 + c] = Cs[r * LDC + c];
  }
}

}  // namespace

// x (M, K) f32, xq scratch (M, K) bf16, wp (K/2, N) u8, ws (K/32, N) u8,
// y (M, N) f32. K % 32 == 0. Returns cudaGetLastError() after the launches.
extern "C" int mx_gemm_packed_launch(const void* x, void* xq, const void* wp,
                                     const void* ws, void* y, int M, int N,
                                     int K, int fmt, int t3, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K % 32 != 0 || fmt_bits(fmt) != 4)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (long long)M * (K / 32);
  const int tpb = 128;
  act_quant_kernel<<<(unsigned)((nblk + tpb - 1) / tpb), tpb, 0, s>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(xq), M, K, fmt,
      t3);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mx_gemm_kernel<<<grid, 128, 0, s>>>(
      static_cast<const __nv_bfloat16*>(xq), static_cast<const uint8_t*>(wp),
      static_cast<const uint8_t*>(ws), static_cast<float*>(y), M, N, K, fmt);
  return (int)cudaGetLastError();
}
