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
// What bounds it on an H100: nominally bytes — 4 read and 1 + 1/8 written
// per element — but the encode's instructions about as much: at M = 4096,
// K = 4864 this layout's copy alone takes 1.13x the bytes bound and the
// mxfp4 encode alone as long, and the two overlap in part; T3's f64
// butterfly (its shuffles and conversions) adds about half again
// (scripts/quant_passes.py; the times are in PERF.md).
//
// Design: a warp takes four 32-blocks at a time, lane l elements 4 (l % 8)
// .. + 3 of block l / 8 (one 16-byte load; a warp's loads are 512
// contiguous bytes), and QU such groups one after the other, their loads in
// flight together. T3 rotates the block across its 8 lanes
// (mx_common.cuh's ``rotate_h32<4>``: the same f64 additions in the same
// order as every kernel's T3), then mx_common.cuh's ``mx_encode_quad`` —
// the prefill's chunk encode too, so one definition decides every snap —
// gives the codes (one 4-byte store a lane) and the scale exponent (the
// scale 2^sexp, 1.0 for an all-zero block, stored by one lane a block).
#include "mx_common.cuh"

namespace {

// For timing the kernel's parts (scripts/quant_passes.py): built with
// -DMXQUANT_LEAVE_OUT=bits, it leaves out the T3 rotation (1), the encode
// (2: amax, scale exponent, quotient and snap), the loads (4) or the stores
// (8; kept behind a test no output meets, so the work stays), and its
// output is wrong.
#ifndef MXQUANT_LEAVE_OUT
#define MXQUANT_LEAVE_OUT 0
#endif
constexpr int LEAVE_OUT = MXQUANT_LEAVE_OUT;

constexpr int QW = 8;    // warps a block
constexpr int QU = 4;    // groups of four 32-blocks a warp

// The block scale 2^sexp as a float (``ldexpf(1, sexp)``: 0 below the
// subnormals).
__device__ __forceinline__ float scale_of(int sexp) {
  return sexp >= -126 && sexp <= 127 ? __int_as_float((sexp + 127) << 23)
                                     : ldexpf(1.0f, sexp);
}

template <bool T3>
__global__ void __launch_bounds__(32 * QW)
mx_quant_kernel(const float* __restrict__ x, uint8_t* __restrict__ codes,
                float* __restrict__ scales, long long nblk, int fmt) {
  __shared__ float mids[128];
  fill_snap_mids<true>(mids, fmt, threadIdx.x, 32 * QW);
  __syncthreads();
  const int lane = threadIdx.x % 32, e = 4 * (lane % 8);
  // the warp's first 32-block
  const long long b0 =
      ((long long)blockIdx.x * QW + threadIdx.x / 32) * QU * 4;
  if (b0 >= nblk) return;
  float v[QU][4];
#pragma unroll
  for (int u = 0; u < QU; ++u) {
    const long long blk = b0 + 4 * u + lane / 8;
    float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (LEAVE_OUT & 4)
      f = make_float4((float)blk, (float)e, (float)u, 1.0f);
    else if (blk < nblk)
      f = __ldg(reinterpret_cast<const float4*>(x + blk * 32 + e));
    v[u][0] = f.x; v[u][1] = f.y; v[u][2] = f.z; v[u][3] = f.w;
  }
#pragma unroll
  for (int u = 0; u < QU; ++u) {
    const long long blk = b0 + 4 * u + lane / 8;
    if (T3 && !(LEAVE_OUT & 1)) rotate_h32<4>(v[u], lane);
    uint32_t c[4];
    int sexp = 0;
    if constexpr (LEAVE_OUT & 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = __float_as_uint(v[u][i]) >> 24;
    } else {
      sexp = mx_encode_quad<true>(fmt, v[u], mids, c);
    }
    if ((LEAVE_OUT & 8) && (c[0] ^ c[1] ^ c[2] ^ c[3] ^ sexp) != 0x7fffffff)
      continue;
    if (blk < nblk) {
      if (lane % 8 == 0) scales[blk] = scale_of(sexp);
      *reinterpret_cast<uint32_t*>(codes + blk * 32 + e) =
          c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
    }
  }
}

template <bool T3>
int launch(const void* x, void* codes, void* scales, int M, int K, int fmt,
           void* stream) {
  if (M <= 0 || K <= 0 || K % 32 != 0 || fmt < FMT_FP4 || fmt > FMT_FP6)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (long long)M * (K / 32);
  const long long per_block = (long long)QW * QU * 4;
  mx_quant_kernel<T3><<<(unsigned)((nblk + per_block - 1) / per_block),
                        32 * QW, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
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
