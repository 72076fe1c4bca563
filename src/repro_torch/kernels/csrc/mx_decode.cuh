// Single-token flash-decode attention over a packed MX KV cache, for Hopper:
// one split-key (flash-decoding) body for both cache layouts, templated over
// where key position kp of lane b lives (the row-address functor):
//
//   * ``PagedRows`` — the paged pool (N, P, ·) through block tables: row
//     ``tables[b, kp / P] * P + kp % P`` (mx_decode_paged.cu, the Pallas
//     ``mx_flash_decode_paged``);
//   * ``ContiguousRows`` — the contiguous ``PackedKV`` (B, S, ·): row
//     ``b * S + kp`` (mx_decode.cu, the Pallas ``mx_flash_decode``).
//
// q (B, H, Dh) f32 — one decode token per lane; K/V codes (rows, D*bits/8)
// u8 + (rows, D/32) u8 E8M0 bytes; q_pos, kv_len (B,) i32. Out (B, H, Dh)
// f32. GQA: query head h reads KV head h / G with G = H / kvh (no
// power-of-two assumption: G = 7 for Qwen2-0.5B).
//
// What bounds it on an H100: the bytes of the lane's KV rows (D*bits/8 + D/32
// per row, K and V) — two to four FLOPs per byte, far below the ~300 the
// tensor cores need. At a decode step those are a few hundred KB, so what
// the card can do is keep them all in flight at once: the design is about
// parallelism and whole-line loads.
//
// Design: keys [s * chunk, (s + 1) * chunk) of every lane belong to split s
// (chunk a multiple of 64, chosen on the host from static sizes: see
// ``ops.decode_splits``). Pass 1, ``split_decode_kernel``, runs one block per
// (lane, KV head, split): it clips its keys to [kbeg, kend) — kend =
// min(kv_len, q_pos + 1, the layout's row count), kbeg the window's first
// key — and walks them in tiles of 64. Each thread group of Dh/16 threads
// owns a key row slice: one 16-byte load of fp8/int8 codes (8 bytes for
// fp4/int4) per thread, decoded through a table in shared memory and scaled
// by its E8M0 byte; the K slice is dotted with the G query heads in
// registers and summed across the group by xor shuffles, the V slice lands
// in shared memory. Then the online softmax of the Pallas body: masked
// scores at NEG_INF, masked probabilities 0. The block writes its
// unnormalised (m, l, acc[G, Dh]) to the f32 scratch. A split with no key
// writes m = NEG_INF, l = 0, acc = 0. Pass 2, ``merge_kernel``, combines the
// splits in split order: M = max m_s, L = sum l_s e^(m_s - M), out = sum
// acc_s e^(m_s - M) / max(L, 1e-30); an empty split adds exactly 0, and a
// lane with no key at all gives 0.
#pragma once

#include <stdint.h>

#include "mx_common.cuh"

namespace mxdecode {

constexpr int NT = 128;        // threads per block
constexpr int TK = 64;         // keys per tile; a split's keys are a multiple
constexpr int MAXG = 16;       // query heads per KV head
constexpr int FPT = 16;        // features per load item
constexpr int MAXI = 4;        // load items per thread per tile (Dh <= 128)
constexpr float NEG_INF = -1e30f;

struct PagedRows {
  const int* __restrict__ tables;   // (B, maxp)
  int P, maxp;
  __host__ __device__ int limit() const { return maxp * P; }
  __device__ size_t row(int b, int kp) const {
    return (size_t)tables[b * maxp + kp / P] * P + kp % P;
  }
};

struct ContiguousRows {
  int S;
  __host__ __device__ int limit() const { return S; }
  __device__ size_t row(int b, int kp) const { return (size_t)b * S + kp; }
};

// Offset of feature f in a shared query row: 4 floats of padding after every
// 32, so the float4 reads of the 4 groups of a 64-wide head hit 4 banks.
__device__ __forceinline__ int q_off(int f) { return f + (f >> 5) * 4; }

// The 16 codes of a load item (16 bytes of 8-bit codes, 8 bytes of 4-bit),
// decoded through ``lut`` and scaled.
__device__ __forceinline__ void decode_item(const float* lut, bool byte_codes,
                                            const uint4& w, float scale,
                                            float (&v)[FPT]) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    const uint32_t c = byte_codes ? (ws[i >> 2] >> (8 * (i & 3))) & 0xFFu
                                  : (ws[i >> 3] >> (4 * (i & 7))) & 0xFu;
    v[i] = lut[c] * scale;
  }
}

// Pass 1. part: acc (B, H, nsplit, Dh) then (m, l) (B, H, nsplit, 2), f32.
template <class Rows>
__global__ void __launch_bounds__(NT)
split_decode_kernel(const float* __restrict__ q,
                    const uint8_t* __restrict__ kc,
                    const uint8_t* __restrict__ ks,
                    const uint8_t* __restrict__ vc,
                    const uint8_t* __restrict__ vs, Rows rows,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_len, float* __restrict__ part,
                    int H, int Dh, int D, int fmt, int window, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, hk = blockIdx.y, s = blockIdx.z;
  const int B = gridDim.x, nsplit = gridDim.z, tid = threadIdx.x;
  const int kvh = D / Dh, G = H / kvh;
  const bool byte_codes = fmt_bits(fmt) == 8;
  const int db = D * fmt_bits(fmt) / 8, ns = D / 32;
  const int QR = q_off(Dh), VR = Dh + 4;
  float* lut = smem;                       // 256 code values
  float* Qs = lut + 256;                   // G x QR
  float* Vs = Qs + G * QR;                 // TK x VR
  float* Ss = Vs + TK * VR;                // G x TK
  float* Ms = Ss + G * TK;                 // G running max
  float* Ls = Ms + G;                      // G running normaliser
  float* Cs = Ls + G;                      // G correction of this tile

  const int qp = q_pos[b], kl = kv_len[b];
  const int kend = min(min(kl, qp + 1), rows.limit());
  const int kbeg = window > 0 ? max(0, qp - window + 1) : 0;
  const int lo = max(kbeg, s * chunk), hi = min(kend, (s + 1) * chunk);
  const size_t head0 = (size_t)b * H + hk * G;   // this block's first head
  float* pacc = part + (head0 * nsplit + s) * Dh;
  float* pml = part + (size_t)B * H * nsplit * Dh + (head0 * nsplit + s) * 2;

  // accumulator mapping: d = tid % Dh, heads g = tid / Dh + j * (NT / Dh)
  const int gstride = NT / Dh, dcol = tid % Dh, g0 = tid / Dh;
  if (lo >= hi) {                          // no key here: an exact no-op
#pragma unroll
    for (int j = 0; j < MAXG; ++j) {
      const int g = g0 + j * gstride;
      if (g < G) pacc[(size_t)g * nsplit * Dh + dcol] = 0.0f;
    }
    for (int g = tid; g < G; g += NT) {
      pml[(size_t)g * nsplit * 2] = NEG_INF;
      pml[(size_t)g * nsplit * 2 + 1] = 0.0f;
    }
    return;
  }

  for (int i = tid; i < (byte_codes ? 256 : 16); i += NT)
    lut[i] = decode_code(fmt, i);
  for (int i = tid; i < G * Dh; i += NT)
    Qs[(i / Dh) * QR + q_off(i % Dh)] = q[head0 * Dh + i];
  for (int g = tid; g < G; g += NT) { Ms[g] = NEG_INF; Ls[g] = 0.0f; }
  float acc[MAXG];
#pragma unroll
  for (int j = 0; j < MAXG; ++j) acc[j] = 0.0f;

  const float sm = 1.0f / sqrtf((float)Dh);
  const int ipk = Dh / FPT;                // load items per key row slice
  const int ni = TK * ipk;                 // items per tile (a multiple of 32)
  const int ib = FPT * fmt_bits(fmt) / 8;  // bytes per item: 16 or 8
  const size_t fbyte = (size_t)hk * Dh * fmt_bits(fmt) / 8;
  for (int k0 = lo; k0 < hi; k0 += TK) {
    // every K and V line of the tile in flight
    uint4 kw[MAXI], vw[MAXI];
    float ksc[MAXI], vsc[MAXI];
#pragma unroll
    for (int r = 0; r < MAXI; ++r) {
      const int it = tid + r * NT, t = it / ipk, j = it % ipk;
      kw[r] = vw[r] = make_uint4(0, 0, 0, 0);
      ksc[r] = vsc[r] = 0.0f;
      if (it < ni && k0 + t < hi) {
        const size_t row = rows.row(b, k0 + t);
        const size_t off = row * db + fbyte + (size_t)j * ib;
        const int sb = (hk * Dh + j * FPT) / 32;
        if (ib == 16) {
          kw[r] = *reinterpret_cast<const uint4*>(kc + off);
          vw[r] = *reinterpret_cast<const uint4*>(vc + off);
        } else {
          const uint2 k2 = *reinterpret_cast<const uint2*>(kc + off);
          const uint2 v2 = *reinterpret_cast<const uint2*>(vc + off);
          kw[r] = make_uint4(k2.x, k2.y, 0, 0);
          vw[r] = make_uint4(v2.x, v2.y, 0, 0);
        }
        ksc[r] = e8m0_scale(ks[row * ns + sb]);
        vsc[r] = e8m0_scale(vs[row * ns + sb]);
      }
    }
    __syncthreads();                       // lut / Qs ready; last tile done
    // scores: the key's item group dots its slice with every query head
#pragma unroll
    for (int r = 0; r < MAXI; ++r) {
      const int it = tid + r * NT, t = it / ipk, j = it % ipk;
      if (it >= ni) break;                 // warp-uniform: ni % 32 == 0
      float v[FPT];
      decode_item(lut, byte_codes, kw[r], ksc[r], v);
      const bool ok = k0 + t < hi;
      const float* qrow = Qs + q_off(j * FPT);
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int i = 0; i < FPT; i += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qrow + g * QR + i);
          d = fmaf(qv.x, v[i], d);
          d = fmaf(qv.y, v[i + 1], d);
          d = fmaf(qv.z, v[i + 2], d);
          d = fmaf(qv.w, v[i + 3], d);
        }
        for (int o = ipk >> 1; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if (j == 0) Ss[g * TK + t] = ok ? d * sm : -INFINITY;
      }
      decode_item(lut, byte_codes, vw[r], vsc[r], v);
      float* vrow = Vs + t * VR + j * FPT;
#pragma unroll
      for (int i = 0; i < FPT; i += 4)
        *reinterpret_cast<float4*>(vrow + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
    __syncthreads();
    // online softmax per head: warp w owns heads w, w + 4, ...
    {
      const int lane = tid & 31, w = tid >> 5;
      for (int g = w; g < G; g += NT / 32) {
        float s0 = Ss[g * TK + lane], s1 = Ss[g * TK + lane + 32];
        float mx = fmaxf(fmaxf(s0, s1), NEG_INF);
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = Ms[g], m_new = fmaxf(m_prev, mx);
        const float p0 = s0 == -INFINITY ? 0.0f : expf(s0 - m_new);
        const float p1 = s1 == -INFINITY ? 0.0f : expf(s1 - m_new);
        float sum = p0 + p1;
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        Ss[g * TK + lane] = p0;
        Ss[g * TK + lane + 32] = p1;
        __syncwarp();
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          Cs[g] = corr;
          Ls[g] = Ls[g] * corr + sum;
          Ms[g] = m_new;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXG; ++j) {
      const int g = g0 + j * gstride;
      if (g < G) {
        float a = acc[j] * Cs[g];
        for (int t = 0; t < TK; ++t)
          a = fmaf(Ss[g * TK + t], Vs[t * VR + dcol], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MAXG; ++j) {
    const int g = g0 + j * gstride;
    if (g < G) pacc[(size_t)g * nsplit * Dh + dcol] = acc[j];
  }
  for (int g = tid; g < G; g += NT) {
    pml[(size_t)g * nsplit * 2] = Ms[g];
    pml[(size_t)g * nsplit * 2 + 1] = Ls[g];
  }
}

// Pass 2: one thread per output (b, h, d), splits merged in split order.
__global__ void merge_kernel(const float* __restrict__ part,
                             float* __restrict__ out, int BH, int Dh,
                             int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BH * Dh) return;
  const int bh = i / Dh, d = i % Dh;
  const float* acc = part + (size_t)bh * nsplit * Dh + d;
  const float* ml = part + (size_t)BH * nsplit * Dh + (size_t)bh * nsplit * 2;
  // unrolled so that the loads of several splits are in flight at once;
  // the sums still run in split order
  float M = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.0f, o = 0.0f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float e = expf(ml[2 * s] - M);
    L = fmaf(ml[2 * s + 1], e, L);
    o = fmaf(acc[(size_t)s * Dh], e, o);
  }
  out[i] = o / fmaxf(L, 1e-30f);
}

// Both passes on ``stream``; ``part`` holds B * H * nsplit * (Dh + 2) f32.
// Returns cudaErrorInvalidValue for a non-KV format, for shapes the tiling
// does not take (Dh in {16, 32, 64, 128}, at most MAXG query heads per KV
// head, 32-blocks along the features), for a split that is not a whole
// number of tiles or splits that miss a row, and for code pointers off a
// 16-byte boundary; else cudaGetLastError() after the launches.
template <class Rows>
int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, Rows rows, const void* q_pos, const void* kv_len,
           void* part, void* out, int B, int H, int Dh, int D, int fmt,
           int window, int chunk, int nsplit, void* stream) {
  if (B <= 0 || fmt < FMT_FP4 || fmt > FMT_INT8 || Dh < FPT ||
      NT % Dh != 0 || D % Dh != 0 || D % 32 != 0 || H % (D / Dh) != 0 ||
      H / (D / Dh) > MAXG || chunk <= 0 || chunk % TK != 0 || nsplit <= 0 ||
      (long long)chunk * nsplit < rows.limit() ||
      (reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) %
          16 != 0)
    return (int)cudaErrorInvalidValue;
  const int kvh = D / Dh, G = H / kvh;
  const size_t shm = sizeof(float) * (256 + G * (Dh + Dh / 32 * 4) +
                                      TK * (Dh + 4) + G * TK + 3 * G);
  cudaFuncSetAttribute(split_decode_kernel<Rows>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(B, kvh, nsplit);
  split_decode_kernel<Rows><<<grid, NT, shm, s>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(ks), static_cast<const uint8_t*>(vc),
      static_cast<const uint8_t*>(vs), rows, static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_len), static_cast<float*>(part), H, Dh, D,
      fmt, window, chunk);
  merge_kernel<<<(B * H * Dh + NT - 1) / NT, NT, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), B * H, Dh,
      nsplit);
  return (int)cudaGetLastError();
}

}  // namespace mxdecode
