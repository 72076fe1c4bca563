// Shared MX device functions for the Hopper kernels of the port.
//
// Ports the Pallas tile helpers of the JAX package:
//   * the quantize snap of ``_quant_tile`` (src/repro/kernels/mx_quant.py:47-59)
//     and the T3 rotation of ``_rotate_tile`` (hadamard_quant.py:25): the
//     steps every kernel's encode takes (``block_scale_exp``, ``quant_code``,
//     ``snap_index``), and the encode of a 32-block spread over 8 lanes
//     (``mx_encode_quad``) that the standalone quantizers and the prefill's
//     chunk encode share,
//   * the code decodes (``_decode_tile``, mx_quant.py:34, and the arithmetic
//     fp8 / int8 decode of ``_decode_codes``, mx_attention.py:80-105),
//   * the E8M0 scale-byte conversions (packing.py:67-74).
//
// Block exponent: floor(log2(amax)) taken exactly from the float's bits
// (ilogbf), amax == 0 mapped to scale 1 — the same definition as the plain
// versions (repro_torch/core/mx.py), so kernel and plain bytes are identical.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Element formats, in the order of the Python side (kernels/ops.py _FMT).
// FP6 (E2M3) codes are stored one per byte; only the standalone quantizer
// and the unpacked GEMM take it. The packed layouts (the KV cache, nibble
// weights, the packed GEMM's activations) hold the other four, so every
// format helper below takes the set as a template flag ``kFp6`` (default
// off) and the packed kernels' format switches carry no FP6 arm: with one,
// ptxas spilled the paged flash-decode (80 registers instead of 95), which
// ran 7% slower, and the paged flash-prefill 6% (kernel_ab.py, H100).
enum MxFmt { FMT_FP4 = 0, FMT_INT4 = 1, FMT_FP8 = 2, FMT_INT8 = 3, FMT_FP6 = 4 };

template <bool kFp6 = false>
__host__ __device__ inline int fmt_bits(int f) {
  return f <= FMT_INT4 ? 4 : (kFp6 && f == FMT_FP6 ? 6 : 8);
}

// Code that decodes to 0.0 (= index of 0 in the full symmetric grid).
template <bool kFp6 = false>
__host__ __device__ inline int fmt_center(int f) {
  return f == FMT_FP8 ? 126
                      : (f == FMT_INT8 ? 127 : (kFp6 && f == FMT_FP6 ? 31 : 7));
}

// Largest power-of-two exponent of the grid (Eq. 1's r_max).
__host__ __device__ inline int fmt_rmax(int f) {
  return f == FMT_FP8 ? 8 : (f == FMT_INT8 ? 6 : 2);
}

// Number of magnitudes in the positive half-grid.
template <bool kFp6 = false>
__host__ __device__ inline int fmt_ngrid(int f) {
  return f == FMT_FP8 ? 127
                      : (f == FMT_INT8 ? 128 : (kFp6 && f == FMT_FP6 ? 32 : 8));
}

// Magnitude of half-grid index k. Every value is exact in f32 (and bf16).
template <bool kFp6 = false>
__device__ __forceinline__ float grid_value(int fmt, int k) {
  switch (fmt) {
    case FMT_FP4:  // 0, .5, 1, 1.5, 2, 3, 4, 6
      return k < 2 ? ldexpf((float)k, -1)
                   : ldexpf((float)(2 + (k & 1)), (k >> 1) - 2);
    case FMT_FP8:  // subnormals k * 2^-9, normals (8 + m) * 2^(e - 10)
      if (k < 8) return ldexpf((float)k, -9);
      return ldexpf((float)(8 + ((k - 8) & 7)), (k - 8) / 8 + 1 - 10);
    case FMT_FP6:  // subnormals k * 2^-3, normals (8 + m) * 2^(e - 3)
      if (kFp6) {
        if (k < 8) return ldexpf((float)k, -3);
        return ldexpf((float)(8 + ((k - 8) & 7)), (k - 8) / 8 - 3);
      }
      return (float)k;
    default:       // int4 / int8: the value is the index
      return (float)k;
  }
}

// Symmetric code -> element value (before the block scale).
template <bool kFp6 = false>
__device__ __forceinline__ float decode_code(int fmt, int code) {
  int rel = code - fmt_center<kFp6>(fmt);
  float v = grid_value<kFp6>(fmt, rel < 0 ? -rel : rel);
  return rel < 0 ? -v : v;
}

// E8M0 byte -> power-of-two scale.
__device__ __forceinline__ float e8m0_scale(int b) {
  return ldexpf(1.0f, b - 127);
}

// Half-grid index of |z|: the number of grid midpoints m with m <= mag
// (searchsorted side='right' over the f32 midpoints; ties go to the larger
// magnitude, as the Pallas tile's ``mag >= m`` compares do).
template <bool kFp6 = false>
__device__ __forceinline__ int snap_index(int fmt, float mag) {
  int lo = 0, hi = fmt_ngrid<kFp6>(fmt) - 1;  // hi = number of midpoints
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    float m = (grid_value<kFp6>(fmt, mid) + grid_value<kFp6>(fmt, mid + 1)) * 0.5f;
    if (m <= mag) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// MX block scale exponent (scale = 2^sexp) of a block with max |x| = amax.
__device__ __forceinline__ int block_scale_exp(int fmt, float amax) {
  return amax > 0.0f ? ilogbf(amax) - fmt_rmax(fmt) : 0;
}

// Quantize one element of a block with scale 2^sexp -> symmetric code.
template <bool kFp6 = false>
__device__ __forceinline__ int quant_code(int fmt, float x, float scale) {
  float z = __fdiv_rn(x, scale);
  int idx = snap_index<kFp6>(fmt, fabsf(z));
  return fmt_center<kFp6>(fmt) + (z < 0.0f ? -idx : idx);
}

// The T3 rotation of a 32-block held E elements a thread by 32 / E lanes
// (element E (lane % (32 / E)) + i in v[i]; E = 32: the whole block in one
// thread): y_c = f32(h sum_b (-1)^popc(b & c) v_b), the Sylvester-ordered
// Hadamard H32 with h = f32(1/sqrt(32)). The sum is the Walsh-Hadamard
// butterfly in f64, one index bit at a time from bit 0 (the bits below
// log2 E in registers, the others across lanes by shuffles), each step
// (lower + upper, lower - upper): the same additions in the same order in
// every layout, so every kernel lands on the same f32 values. The sums are
// exact unless a block spans more than 24 binades (24 bits of f32 and 5 of
// 32 terms within f64's 53); the product with h is rounded to f64, then to
// f32. The plain version (core/transforms.py ``apply_blockwise``) sums the
// exact products h v_b in f64 and rounds once: the two differ only where
// their f64 values straddle an f32 rounding point.
template <int E>
__device__ __forceinline__ void rotate_h32(float (&v)[E], int lane) {
  double d[E];
#pragma unroll
  for (int i = 0; i < E; ++i) d[i] = v[i];
#pragma unroll
  for (int o = 1; o < E; o <<= 1)
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (!(i & o)) {
        const double a = d[i], b = d[i + o];
        d[i] = a + b;
        d[i + o] = a - b;
      }
#pragma unroll
  for (int o = 1; o < 32 / E; o <<= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const double q = __shfl_xor_sync(0xffffffffu, d[i], o);
      d[i] = upper ? q - d[i] : d[i] + q;
    }
  }
  const double h = (double)(float)(1.0 / sqrt(32.0));
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = (float)(d[i] * h);
}

// The snap's table: mids[k] = (grid_value(k) + grid_value(k + 1)) * 0.5f,
// the midpoints ``snap_index`` compares |z| with, then NaN up to 128
// entries (no |z| is at or above a NaN, so a search that reads past the last
// midpoint stops there). Threads tid, tid + nth, ... of a block fill it; a
// barrier must follow.
template <bool kFp6 = false>
__device__ __forceinline__ void fill_snap_mids(float* mids, int fmt, int tid,
                                               int nth) {
  const int ngrid = fmt_ngrid<kFp6>(fmt);
  for (int k = tid; k < 128; k += nth)
    mids[k] = k < ngrid - 1 ? (grid_value<kFp6>(fmt, k) +
                               grid_value<kFp6>(fmt, k + 1)) * 0.5f
                            : __int_as_float(0x7fc00000);
}

// Encode one 32-block held four elements a lane by 8 lanes (lane l: block
// elements 4 (l % 8) .. + 3 in v; every lane of the warp calls it): the
// block's max magnitude by shuffles, ``block_scale_exp``, then per element
// ``quant_code``'s quotient and ``snap_index``'s count of the midpoints at
// or below |z|, here by binary lifting over ``mids`` (``fill_snap_mids``):
// a fixed number of steps for the format, no branch. The quotient x / 2^sexp
// is the product with 2^-sexp where that is a normal float (the same real
// number, rounded once: the same float). Returns the scale exponent; the
// symmetric codes in ``code``. The standalone quantizers and the prefill's
// chunk encode call it, so one definition decides their snaps.
template <bool kFp6 = false>
__device__ __forceinline__ int mx_encode_quad(int fmt, const float (&v)[4],
                                              const float* mids,
                                              uint32_t (&code)[4]) {
  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                     fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const int sexp = block_scale_exp(fmt, amax);
  float z[4];
  if (sexp >= -127 && sexp <= 126) {
    const float inv = __int_as_float((127 - sexp) << 23);   // 2^-sexp
#pragma unroll
    for (int i = 0; i < 4; ++i) z[i] = v[i] * inv;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) z[i] = __fdiv_rn(v[i], ldexpf(1.0f, sexp));
  }
  // half the power of two at or above the grid's size: 4, 16 or 64
  const int top = fmt_ngrid<kFp6>(fmt) > 32 ? 64
                                            : (fmt_ngrid<kFp6>(fmt) > 8 ? 16
                                                                        : 4);
  // the four searches step by step, so their table reads overlap
  int idx[4] = {0, 0, 0, 0};
  for (int step = top; step; step >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      idx[i] += mids[idx[i] + step - 1] <= fabsf(z[i]) ? step : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    code[i] = (uint32_t)(fmt_center<kFp6>(fmt) +
                         (z[i] < 0.0f ? -idx[i] : idx[i]));
  return sexp;
}

// E8M0 byte of a block scale 2^sexp (round(log2(scale)) + 127).
__device__ __forceinline__ uint8_t e8m0_byte(int sexp) {
  return (uint8_t)((sexp + 127) & 0xFF);
}

// Decode feature d of a packed KV row (codes + E8M0 bytes): 8-bit formats
// keep one code per byte, 4-bit formats put feature 2i in the low nibble of
// byte i (pack_codes order).
__device__ __forceinline__ float decode_kv(int fmt, const uint8_t* codes,
                                           const uint8_t* scales, int d) {
  int code;
  if (fmt_bits(fmt) == 8) {
    code = codes[d];
  } else {
    uint8_t b = codes[d >> 1];
    code = (d & 1) ? (b >> 4) : (b & 0xF);
  }
  return decode_code(fmt, code) * e8m0_scale(scales[d >> 5]);
}
