// Shared MX device functions for the Hopper kernels of the serving path.
//
// Ports the Pallas tile helpers of the JAX package:
//   * the quantize snap of ``_quant_tile`` (src/repro/kernels/mx_quant.py:47-59),
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
enum MxFmt { FMT_FP4 = 0, FMT_INT4 = 1, FMT_FP8 = 2, FMT_INT8 = 3 };

__host__ __device__ inline int fmt_bits(int f) { return f <= FMT_INT4 ? 4 : 8; }

// Code that decodes to 0.0 (= index of 0 in the full symmetric grid).
__host__ __device__ inline int fmt_center(int f) {
  return f == FMT_FP8 ? 126 : (f == FMT_INT8 ? 127 : 7);
}

// Largest power-of-two exponent of the grid (Eq. 1's r_max).
__host__ __device__ inline int fmt_rmax(int f) {
  return f == FMT_FP8 ? 8 : (f == FMT_INT8 ? 6 : 2);
}

// Number of magnitudes in the positive half-grid.
__host__ __device__ inline int fmt_ngrid(int f) {
  return f == FMT_FP8 ? 127 : (f == FMT_INT8 ? 128 : 8);
}

// Magnitude of half-grid index k. Every value is exact in f32 (and bf16).
__device__ __forceinline__ float grid_value(int fmt, int k) {
  switch (fmt) {
    case FMT_FP4:  // 0, .5, 1, 1.5, 2, 3, 4, 6
      return k < 2 ? ldexpf((float)k, -1)
                   : ldexpf((float)(2 + (k & 1)), (k >> 1) - 2);
    case FMT_FP8:  // subnormals k * 2^-9, normals (8 + m) * 2^(e - 10)
      if (k < 8) return ldexpf((float)k, -9);
      return ldexpf((float)(8 + ((k - 8) & 7)), (k - 8) / 8 + 1 - 10);
    default:       // int4 / int8: the value is the index
      return (float)k;
  }
}

// Symmetric code -> element value (before the block scale).
__device__ __forceinline__ float decode_code(int fmt, int code) {
  int rel = code - fmt_center(fmt);
  float v = grid_value(fmt, rel < 0 ? -rel : rel);
  return rel < 0 ? -v : v;
}

// E8M0 byte -> power-of-two scale.
__device__ __forceinline__ float e8m0_scale(int b) {
  return ldexpf(1.0f, b - 127);
}

// Half-grid index of |z|: the number of grid midpoints m with m <= mag
// (searchsorted side='right' over the f32 midpoints; ties go to the larger
// magnitude, as the Pallas tile's ``mag >= m`` compares do).
__device__ __forceinline__ int snap_index(int fmt, float mag) {
  int lo = 0, hi = fmt_ngrid(fmt) - 1;  // hi = number of midpoints
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    float m = (grid_value(fmt, mid) + grid_value(fmt, mid + 1)) * 0.5f;
    if (m <= mag) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// MX block scale exponent (scale = 2^sexp) of a block with max |x| = amax.
__device__ __forceinline__ int block_scale_exp(int fmt, float amax) {
  return amax > 0.0f ? ilogbf(amax) - fmt_rmax(fmt) : 0;
}

// Quantize one element of a block with scale 2^sexp -> symmetric code.
__device__ __forceinline__ int quant_code(int fmt, float x, float scale) {
  float z = __fdiv_rn(x, scale);
  int idx = snap_index(fmt, fabsf(z));
  return fmt_center(fmt) + (z < 0.0f ? -idx : idx);
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
