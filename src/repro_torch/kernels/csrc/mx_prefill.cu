// Paged flash-prefill attention fused with the chunk's quantize-on-append,
// for Hopper.
//
// Replaces the Pallas kernel ``mx_flash_prefill`` of the JAX package
// (src/repro/kernels/mx_attention.py:478, its ``pallas_call`` at :582).
//
// q (B, C, H, Dh) f32 — a C-token chunk per lane; K/V chunk (B, C, D) f32;
// K/V pools (N, P, D*bits/8) u8 + (N, P, D/32) u8 E8M0; block tables
// (B, maxp) i32; q_start, kv_len (B,) i32. Outputs: out (B, C, H, Dh) f32 and
// the chunk's bytes (B, C, D*bits/8) + (B, C, D/32) for K and V, equal to
// ``kv_encode`` of the chunk — the caller scatters them into the pool.
//
// What bounds it on an H100: the operations. A 1024-row chunk against up to
// a page of prefix does ~4 FLOPs per (query head, key, feature) over ~1e3
// keys per byte moved, far above the memory roofline, so the f32 CUDA-core
// math below sits at a small share of the bf16 tensor-core bound. Moving the
// two products onto tensor cores (q and p are not exact in bf16, so it needs
// a split or a tolerance) is the later step.
//
// Design (simple first): pass 1 encodes the chunk, one thread per 32-block
// (the ``_quant_tile`` snap + E8M0 byte + nibble order), and writes the byte
// outputs — exactly one writer per chunk row. Pass 2 attends: one block per
// (query tile of up to 64 / G rows, KV head, lane) walks the committed
// prefix through the block table (pool rows valid iff kp < q_start, so a
// mid-page resume never counts a row twice), then the chunk rows decoded
// from the bytes pass 1 wrote (row i at q_start + i) — attention reads the
// round trip of the very bytes the pool receives. Causal (kp <= qp), fill
// (kp < kv_len) and window (kp > qp - window) masks per query row; online
// softmax with NEG_INF scores, masked probabilities at 0 and the normaliser
// clamped at 1e-30, as in the Pallas body.
#include "mx_common.cuh"

namespace {

constexpr int NT = 128;        // threads per block
constexpr int TK = 64;         // keys per tile
constexpr int MAXR = 64;       // query rows (query position x head) per block
constexpr float NEG_INF = -1e30f;

__global__ void kv_quant_kernel(const float* __restrict__ x,
                                uint8_t* __restrict__ codes,
                                uint8_t* __restrict__ scales, long long nblk,
                                int fmt) {
  const long long blk = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= nblk) return;
  const float* src = x + blk * 32;
  float v[32];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) { v[i] = src[i]; amax = fmaxf(amax, fabsf(v[i])); }
  const int sexp = block_scale_exp(fmt, amax);
  const float scale = ldexpf(1.0f, sexp);
  scales[blk] = e8m0_byte(sexp);
  if (fmt_bits(fmt) == 8) {
    uint8_t* dst = codes + blk * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[i] = (uint8_t)quant_code(fmt, v[i], scale);
  } else {
    uint8_t* dst = codes + blk * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dst[i] = (uint8_t)(quant_code(fmt, v[2 * i], scale) |
                         (quant_code(fmt, v[2 * i + 1], scale) << 4));
  }
}

__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const float* __restrict__ q,
                     const uint8_t* __restrict__ kcp, const uint8_t* __restrict__ ksp,
                     const uint8_t* __restrict__ vcp, const uint8_t* __restrict__ vsp,
                     const uint8_t* __restrict__ kcc, const uint8_t* __restrict__ ksc,
                     const uint8_t* __restrict__ vcc, const uint8_t* __restrict__ vsc,
                     const int* __restrict__ tables, const int* __restrict__ q_start,
                     const int* __restrict__ kv_len, float* __restrict__ out,
                     int C, int H, int Dh, int D, int P, int maxp, int fmt,
                     int window, int QT) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int kvh = D / Dh, G = H / kvh;
  const int i0 = blockIdx.x * QT, i1 = min(i0 + QT, C);
  const int R = (i1 - i0) * G;                // rows r = (i - i0) * G + g
  const int db = D * fmt_bits(fmt) / 8, ns = D / 32;
  float* Qs = smem;                           // R x Dh
  float* Ks = Qs + MAXR * Dh;                 // TK x (Dh + 1)
  float* Vs = Ks + TK * (Dh + 1);             // TK x Dh
  float* Ps = Vs + TK * Dh;                   // R x TK
  float* Ms = Ps + MAXR * TK;
  float* Ls = Ms + MAXR;
  float* Cs = Ls + MAXR;

  const float sm = 1.0f / sqrtf((float)Dh);
  const int st = q_start[b], kl = kv_len[b];
  for (int i = tid; i < R * Dh; i += NT) {
    const int r = i / Dh, d = i % Dh;
    const int qi = i0 + r / G, g = r % G;
    Qs[i] = q[(((size_t)b * C + qi) * H + hk * G + g) * Dh + d];
  }
  for (int r = tid; r < R; r += NT) { Ms[r] = NEG_INF; Ls[r] = 0.0f; }

  // accumulators: d = tid % Dh, rows r = tid / Dh + j * (NT / Dh)
  const int rstride = NT / Dh, dcol = tid % Dh, r0 = tid / Dh;
  constexpr int MAXJ = 32;
  float acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.0f;

  const int qp_lo = st + i0, qp_hi = st + i1 - 1;
  const int foff = hk * Dh;
  // source 0: committed prefix pages; source 1: the chunk's own rows
  for (int src = 0; src < 2; ++src) {
    int lo, hi;
    if (src == 0) {
      hi = min(min(st, kl), min(qp_hi + 1, maxp * P));
      lo = window > 0 ? max(0, qp_lo - window + 1) : 0;
    } else {      // chunk row index i, key position st + i
      hi = min(min(C, i1), kl - st);
      lo = window > 0 ? max(0, i0 - window + 1) : 0;
    }
    for (int k0 = lo; k0 < hi; k0 += TK) {
      __syncthreads();
      for (int i = tid; i < TK * Dh; i += NT) {
        const int t = i / Dh, d = i % Dh, k = k0 + t;
        float kv = 0.0f, vv = 0.0f;
        if (k < hi) {
          if (src == 0) {
            const size_t row = (size_t)tables[b * maxp + k / P] * P + k % P;
            kv = decode_kv(fmt, kcp + row * db, ksp + row * ns, foff + d);
            vv = decode_kv(fmt, vcp + row * db, vsp + row * ns, foff + d);
          } else {
            const size_t row = (size_t)b * C + k;
            kv = decode_kv(fmt, kcc + row * db, ksc + row * ns, foff + d);
            vv = decode_kv(fmt, vcc + row * db, vsc + row * ns, foff + d);
          }
        }
        Ks[t * (Dh + 1) + d] = kv;
        Vs[t * Dh + d] = vv;
      }
      __syncthreads();
      {   // scores: key t = tid % TK, rows r = tid / TK + j * (NT / TK)
        const int t = tid % TK, k = k0 + t;
        const int kp = src == 0 ? k : st + k;
        for (int r = tid / TK; r < R; r += NT / TK) {
          const int qp = st + i0 + r / G;
          const bool ok = k < hi && kp < kl && kp <= qp &&
                          (window == 0 || kp > qp - window);
          float s = 0.0f;
          for (int d = 0; d < Dh; ++d) s = fmaf(Qs[r * Dh + d], Ks[t * (Dh + 1) + d], s);
          Ps[r * TK + t] = ok ? s * sm : -INFINITY;
        }
      }
      __syncthreads();
      {   // online softmax per row: warp w owns rows w, w + 4, ...
        const int lane = tid & 31, w = tid >> 5;
        for (int r = w; r < R; r += NT / 32) {
          const float s0 = Ps[r * TK + lane], s1 = Ps[r * TK + lane + 32];
          float mx = fmaxf(fmaxf(s0, s1), NEG_INF);
          for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_prev = Ms[r], m_new = fmaxf(m_prev, mx);
          const float p0 = s0 == -INFINITY ? 0.0f : expf(s0 - m_new);
          const float p1 = s1 == -INFINITY ? 0.0f : expf(s1 - m_new);
          float sum = p0 + p1;
          for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          Ps[r * TK + lane] = p0;
          Ps[r * TK + lane + 32] = p1;
          __syncwarp();
          if (lane == 0) {
            const float corr = expf(m_prev - m_new);
            Cs[r] = corr;
            Ls[r] = Ls[r] * corr + sum;
            Ms[r] = m_new;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int r = r0 + j * rstride;
        if (r < R) {
          float a = acc[j] * Cs[r];
          for (int t = 0; t < TK; ++t) a = fmaf(Ps[r * TK + t], Vs[t * Dh + dcol], a);
          acc[j] = a;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int r = r0 + j * rstride;
    if (r < R) {
      const int qi = i0 + r / G, g = r % G;
      out[(((size_t)b * C + qi) * H + hk * G + g) * Dh + dcol] =
          acc[j] / fmaxf(Ls[r], 1e-30f);
    }
  }
}

}  // namespace

extern "C" int mx_flash_prefill_launch(
    const void* q, const void* k_chunk, const void* v_chunk, const void* kcp,
    const void* ksp, const void* vcp, const void* vsp, const void* tables,
    const void* q_start, const void* kv_len, void* out, void* kc, void* ks,
    void* vc, void* vs, int B, int C, int H, int Dh, int D, int P, int maxp,
    int fmt, int window, void* stream) {
  // shapes the tiling takes: Dh divides the block, the per-thread
  // accumulators (MAXR * Dh / NT <= 32) cover one block's rows, and a block
  // holds at least one query position's G heads
  if (Dh <= 0 || NT % Dh != 0 || D % Dh != 0 || D % 32 != 0 ||
      H % (D / Dh) != 0 || MAXR * Dh > 32 * NT)
    return (int)cudaErrorInvalidValue;
  const int kvh = D / Dh, G = H / kvh;
  if (G > MAXR) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long nblk = (long long)B * C * (D / 32);
  const int tpb = 128;
  const unsigned qgrid = (unsigned)((nblk + tpb - 1) / tpb);
  kv_quant_kernel<<<qgrid, tpb, 0, s>>>(static_cast<const float*>(k_chunk),
                                        static_cast<uint8_t*>(kc),
                                        static_cast<uint8_t*>(ks), nblk, fmt);
  kv_quant_kernel<<<qgrid, tpb, 0, s>>>(static_cast<const float*>(v_chunk),
                                        static_cast<uint8_t*>(vc),
                                        static_cast<uint8_t*>(vs), nblk, fmt);
  const int QT = MAXR / G;
  const size_t shm = sizeof(float) *
      (MAXR * Dh + TK * (Dh + 1) + TK * Dh + MAXR * TK + 3 * MAXR);
  cudaFuncSetAttribute(flash_prefill_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  dim3 grid((C + QT - 1) / QT, kvh, B);
  flash_prefill_kernel<<<grid, NT, shm, s>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(kcp),
      static_cast<const uint8_t*>(ksp), static_cast<const uint8_t*>(vcp),
      static_cast<const uint8_t*>(vsp), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(ks), static_cast<const uint8_t*>(vc),
      static_cast<const uint8_t*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(q_start), static_cast<const int*>(kv_len),
      static_cast<float*>(out), C, H, Dh, D, P, maxp, fmt, window, QT);
  return (int)cudaGetLastError();
}
