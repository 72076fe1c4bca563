// Paged flash-decode attention over a packed MX KV pool, for Hopper.
//
// Replaces the Pallas kernel ``mx_flash_decode_paged`` of the JAX package
// (src/repro/kernels/mx_attention.py:270, its ``pallas_call`` at :323).
//
// q (B, H, Dh) f32 — one decode token per lane; K/V pools (N, P, D*bits/8)
// u8 codes + (N, P, D/32) u8 E8M0 bytes; block tables (B, maxp) i32 (page
// ``tables[b, c]`` holds positions [c*P, (c+1)*P) of lane b); q_pos, kv_len
// (B,) i32. Out (B, H, Dh) f32. GQA: query head h reads KV head h / G with
// G = H / kvh (no power-of-two assumption: G = 7 for Qwen2-0.5B).
//
// What bounds it on an H100: the bytes of the lane's KV rows (D*bits/8 + D/32
// per row, K and V) — two to four FLOPs per byte, far below the ~300 the
// tensor cores need. This version runs one block per (lane, KV head), 8
// blocks at 4 lanes of Qwen2-0.5B on 132 SMs, so it is bound by how few
// SMs work long before the bytes.
//
// Design (simple first): one block per (lane, KV head) walks the lane's
// keys in tiles of 64 rows through the block table, decodes the K and V
// rows of its head into shared memory (fp8 / int8 arithmetically, 4-bit via
// the nibble order of pack_codes), and runs the online softmax of the
// Pallas body for its G query heads: masked scores at NEG_INF, masked
// probabilities forced to 0, the normaliser clamped at 1e-30. Keys at or
// past min(kv_len, q_pos + 1) — the table slots parked on the scrap page —
// and keys before the sliding window are skipped (fully masked tiles are
// exact no-ops of the online softmax). Splitting a lane's keys over more
// blocks (flash-decoding) is later work.
#include "mx_common.cuh"

namespace {

constexpr int NT = 128;        // threads per block
constexpr int TK = 64;         // keys per tile
constexpr int MAXG = 16;       // query heads per KV head
constexpr float NEG_INF = -1e30f;

__global__ void __launch_bounds__(NT)
flash_decode_paged_kernel(const float* __restrict__ q,
                          const uint8_t* __restrict__ kc,
                          const uint8_t* __restrict__ ks,
                          const uint8_t* __restrict__ vc,
                          const uint8_t* __restrict__ vs,
                          const int* __restrict__ tables,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_len,
                          float* __restrict__ out, int H, int Dh, int D,
                          int P, int maxp, int fmt, int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, hk = blockIdx.y, tid = threadIdx.x;
  const int kvh = D / Dh, G = H / kvh;
  const int db = D * fmt_bits(fmt) / 8, ns = D / 32;
  float* Ks = smem;                        // TK x (Dh + 1)
  float* Vs = Ks + TK * (Dh + 1);          // TK x Dh
  float* Qs = Vs + TK * Dh;                // G x Dh
  float* Ss = Qs + G * Dh;                 // G x TK
  float* Ms = Ss + G * TK;                 // G running max
  float* Ls = Ms + G;                      // G running normaliser
  float* Cs = Ls + G;                      // G correction of this tile

  const float sm = 1.0f / sqrtf((float)Dh);
  const int qp = q_pos[b], kl = kv_len[b];
  for (int i = tid; i < G * Dh; i += NT)
    Qs[i] = q[((size_t)b * H + hk * G) * Dh + i];
  for (int g = tid; g < G; g += NT) { Ms[g] = NEG_INF; Ls[g] = 0.0f; }

  // accumulator mapping: d = tid % Dh, heads g = tid / Dh + j * (NT / Dh)
  const int gstride = NT / Dh, dcol = tid % Dh, g0 = tid / Dh;
  float acc[MAXG];
#pragma unroll
  for (int j = 0; j < MAXG; ++j) acc[j] = 0.0f;

  const int kend = min(min(kl, qp + 1), maxp * P);
  const int kbeg = window > 0 ? max(0, qp - window + 1) : 0;
  const int foff = hk * Dh;                // this head's feature offset
  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    __syncthreads();
    for (int i = tid; i < TK * Dh; i += NT) {
      const int t = i / Dh, d = i % Dh, kp = k0 + t;
      float kv = 0.0f, vv = 0.0f;
      if (kp < kend) {
        const size_t row = (size_t)tables[b * maxp + kp / P] * P + kp % P;
        kv = decode_kv(fmt, kc + row * db, ks + row * ns, foff + d);
        vv = decode_kv(fmt, vc + row * db, vs + row * ns, foff + d);
      }
      Ks[t * (Dh + 1) + d] = kv;
      Vs[t * Dh + d] = vv;
    }
    __syncthreads();
    // scores: key t = tid % TK, heads g = tid / TK + j * (NT / TK)
    {
      const int t = tid % TK, kp = k0 + t;
      const bool ok = kp < kend && kp < kl && kp <= qp &&
                      (window == 0 || kp > qp - window);
      for (int g = tid / TK; g < G; g += NT / TK) {
        float s = 0.0f;
        for (int d = 0; d < Dh; ++d) s = fmaf(Qs[g * Dh + d], Ks[t * (Dh + 1) + d], s);
        Ss[g * TK + t] = ok ? s * sm : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax per head: warp w owns heads w, w + 4, ...
    {
      const int lane = tid & 31, w = tid >> 5;
      for (int g = w; g < G; g += NT / 32) {
        float s0 = Ss[g * TK + lane], s1 = Ss[g * TK + lane + 32];
        float mx = fmaxf(fmaxf(s0, s1), NEG_INF);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = Ms[g], m_new = fmaxf(m_prev, mx);
        const float p0 = s0 == -INFINITY ? 0.0f : expf(s0 - m_new);
        const float p1 = s1 == -INFINITY ? 0.0f : expf(s1 - m_new);
        float sum = p0 + p1;
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
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
        for (int t = 0; t < TK; ++t) a = fmaf(Ss[g * TK + t], Vs[t * Dh + dcol], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MAXG; ++j) {
    const int g = g0 + j * gstride;
    if (g < G)
      out[((size_t)b * H + hk * G + g) * Dh + dcol] = acc[j] / fmaxf(Ls[g], 1e-30f);
  }
}

}  // namespace

extern "C" int mx_flash_decode_paged_launch(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* tables, const void* q_pos, const void* kv_len,
    void* out, int B, int H, int Dh, int D, int P, int maxp, int fmt,
    int window, void* stream) {
  // shapes the tiling takes: Dh divides the block, at most MAXG query heads
  // per KV head (the per-thread accumulators), 32-blocks along the features
  if (Dh <= 0 || NT % Dh != 0 || D % Dh != 0 || D % 32 != 0 ||
      H % (D / Dh) != 0 || H / (D / Dh) > MAXG)
    return (int)cudaErrorInvalidValue;
  const int kvh = D / Dh, G = H / kvh;
  const size_t shm = sizeof(float) *
      (TK * (Dh + 1) + TK * Dh + G * Dh + G * TK + 3 * G);
  cudaFuncSetAttribute(flash_decode_paged_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  dim3 grid(B, kvh);
  flash_decode_paged_kernel<<<grid, NT, shm, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(ks), static_cast<const uint8_t*>(vc),
      static_cast<const uint8_t*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_len),
      static_cast<float*>(out), H, Dh, D, P, maxp, fmt, window);
  return (int)cudaGetLastError();
}
