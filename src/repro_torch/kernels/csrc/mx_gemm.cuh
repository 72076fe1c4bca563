// The fused MX GEMM of the port, y = Q_mx(x [· blockdiag(H32)]) @ deq(w),
// f32 out, templated over the layout of the weight operand:
//
//   * ``PackedE8M0Weights``: (K/2, N) u8 nibble codes (code 2i in the low
//     nibble of byte i along K) + (K/32, N) u8 E8M0 bytes — the artifact
//     layout (mx_gemm.cu, the Pallas ``mx_matmul_packed``);
//   * ``ByteF32Weights``: (K, N) u8, one code per byte, + (K/32, N) f32
//     scales — the unpacked layout (mx_matmul.cu, the Pallas ``mx_matmul``).
//
// What bounds it on an H100: bytes. At decode (M = a few lanes) the weights,
// at prefill (M = lanes x 1024) the f32 activations and outputs; both sit far
// below the tensor-core rate. This simple version reaches neither bound: at
// M = 4 it runs N/64 blocks (14 to 76 on 132 SMs), each walking all of K.
//
// Design (simple first): pass 1 (``act_quant_kernel``) quantizes the
// activations, one thread per 32-block through ``mx_encode_block``, and
// writes the dequantized values as bf16 — exact, since every MX grid value
// has at most 4 significant bits (int8: 7) and the block scale is a power of
// two. Pass 2 is a 64x64x32 WMMA tile loop: each K step stages the bf16
// activation tile and decodes one MX block row of the weight tile into
// shared memory, then four warps issue bf16 m16n16k16 MMAs into f32
// accumulators. No dense weight exists outside shared memory.
//
// Where the scale goes: E8M0 scales are powers of two, so the packed loader
// folds them into the bf16 weight tile (exact). The unpacked layout's f32
// scales need not be powers of two (the JAX package builds them with an f32
// ``exp2`` that is an ulp off outside 2^+-12), and code x scale is then not
// exact in bf16. So that loader stages the bare codes (exact in bf16), the
// 32-deep product of each K step — exactly one MX block — lands in a
// separate f32 fragment, and the block's per-column scale multiplies that
// partial sum in f32 before it joins the accumulator (the per-block scale of
// ROADMAP Queue 2's Hopper note). Both differ from the f32 plain versions
// only in rounding order.
#pragma once

#include <mma.h>

#include "mx_common.cuh"

namespace mxgemm {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int NT = 128;       // threads per block: 2 x 2 warps of 32 x 32
constexpr int LDA = BK + 8;   // bf16 elements; 80-byte rows keep 32-byte
constexpr int LDB = BN + 8;   // alignment of every 16-row fragment
constexpr int LDC = BN + 4;   // floats

// Pass 1: x (M, K) f32 -> xq (M, K) bf16 = Q_mx(x [· blockdiag(H32)]).
// ``kFp6``: whether the format set includes FP6 (mx_common.cuh).
template <bool kFp6>
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
  int code[32];
  const float scale =
      ldexpf(1.0f, mx_encode_block<kFp6>(fmt, v, t3 != 0, code));
  __align__(16) __nv_bfloat16 out[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    out[i] = __float2bfloat16_rn(decode_code<kFp6>(fmt, code[i]) * scale);
  uint4* dst = reinterpret_cast<uint4*>(xq + blk * 32);
  const uint4* s4 = reinterpret_cast<const uint4*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = s4[i];
}

// Weight tile of K step k0: BK rows x BN columns of bf16 into Bs.
struct PackedE8M0Weights {
  const uint8_t* wp;   // (K/2, N)
  const uint8_t* ws;   // (K/32, N) E8M0
  static constexpr bool kScaleAfter = false;
  static constexpr bool kFp6 = false;

  __device__ void load(__nv_bfloat16* Bs, int k0, int n0, int N, int fmt,
                       int tid) const {
    const int center = fmt_center(fmt);
    const uint8_t zero_byte = (uint8_t)(center | (center << 4));
    for (int i = tid; i < (BK / 2) * BN; i += NT) {
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
  }
  __device__ float scale(int, int) const { return 1.0f; }
};

struct ByteF32Weights {
  const uint8_t* wc;   // (K, N), one code per byte
  const float* ws;     // (K/32, N)
  int N;
  static constexpr bool kScaleAfter = true;
  static constexpr bool kFp6 = true;

  __device__ void load(__nv_bfloat16* Bs, int k0, int n0, int N_, int fmt,
                       int tid) const {
    const int center = fmt_center<kFp6>(fmt);
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN, n = n0 + c;
      const int code = n < N_ ? wc[(size_t)(k0 + r) * N_ + n] : center;
      Bs[r * LDB + c] = __float2bfloat16_rn(decode_code<kFp6>(fmt, code));
    }
  }
  __device__ float scale(int kb, int n) const {
    return n < N ? ws[(size_t)kb * N + n] : 0.0f;
  }
};

// Pass 2: Y (M, N) f32 = A (M, K) bf16 @ W.
template <class W>
__global__ void __launch_bounds__(NT)
gemm_kernel(const __nv_bfloat16* __restrict__ A, W w, float* __restrict__ Y,
            int M, int N, int K, int fmt) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[BM * LDC];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  constexpr int PER = BM * BN / NT;   // scaled-after accumulators per thread

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float racc[W::kScaleAfter ? PER : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
#pragma unroll
  for (int j = 0; j < (W::kScaleAfter ? PER : 1); ++j) racc[j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: 64 rows x 32 bf16 = 4 x 16-byte chunks per row
    for (int i = tid; i < BM * 4; i += NT) {
      const int r = i >> 2, c = i & 3;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0
                                              + c * 8);
      *reinterpret_cast<uint4*>(As + r * LDA + c * 8) = val;
    }
    w.load(Bs, k0, n0, N, fmt, tid);
    __syncthreads();
    if constexpr (W::kScaleAfter) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    }
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
    if constexpr (W::kScaleAfter) {
      // this K step's partial product is one MX block: scale it per column
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                  acc[i][j], LDC, wmma::mem_row_major);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + j * NT, r = e / BN, c = e % BN;
        racc[j] += Cs[r * LDC + c] * w.scale(k0 / 32, n0 + c);
      }
    }
    __syncthreads();
  }
  if constexpr (W::kScaleAfter) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * NT, r = e / BN, c = e % BN;
      if (m0 + r < M && n0 + c < N) Y[(size_t)(m0 + r) * N + n0 + c] = racc[j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < BM * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      if (m0 + r < M && n0 + c < N) Y[(size_t)(m0 + r) * N + n0 + c] = Cs[r * LDC + c];
    }
  }
}

// Both passes on ``stream``; returns cudaGetLastError() after the launches.
template <class W>
int launch(const void* x, void* xq, W w, void* y, int M, int N, int K,
           int fmt, int t3, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long nblk = (long long)M * (K / 32);
  act_quant_kernel<W::kFp6><<<(unsigned)((nblk + NT - 1) / NT), NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(xq), M, K, fmt,
      t3);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<W><<<grid, NT, 0, s>>>(static_cast<const __nv_bfloat16*>(xq), w,
                                     static_cast<float*>(y), M, N, K, fmt);
  return (int)cudaGetLastError();
}

}  // namespace mxgemm
