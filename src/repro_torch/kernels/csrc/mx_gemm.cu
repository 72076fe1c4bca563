// Packed-native fused MX GEMM for Hopper:
//     y = Q_mx(x [· blockdiag(H32)]) @ deq(w),   f32 out.
//
// Replaces the Pallas kernel ``mx_matmul_packed`` of the JAX package
// (src/repro/kernels/mx_matmul.py:170, its ``pallas_call`` at :203).
//
// Inputs: x (M, K) f32; w packed (K/2, N) u8, code 2i in the low nibble of
// byte i along K; w scales (K/32, N) u8 E8M0; y (M, N) f32 — or E of each,
// stacked contiguously (the expert-batched weights of the MoE family, which
// the JAX package maps with ``jax.vmap``): one launch of each kernel runs
// the E products, the expert a grid axis. Two kernels, chosen by M (the rows
// of one expert):
//
//   * M > MAX_M (prefill): the wgmma tile of mx_gemm.cuh after its
//     activation-quantize pass; this layout's power-of-two scales are folded
//     into the bf16 weight tile (exact).
//   * M <= MAX_M (every decode step): ``gemv_kernel`` below, a GEMV built for
//     the weight bytes.
//
// What bounds the small-M case on an H100: the (K/2 + K/32) x N weight bytes,
// 2.3 MB per projection of Qwen2-0.5B, under a microsecond at 3.35 TB/s; with
// a handful of rows there are 8 operations per weight byte at most. What the
// kernel really fights is latency: a few microseconds of dependent steps
// (load, encode, multiply, reduce) per block.
//
// Design of ``gemv_kernel``: a block of 256 threads owns 64 columns (4 groups
// of 16) x one split of K (``kbb`` MX blocks, 4 where K allows) x 4
// activation rows; the splits of a column tile form one thread-block cluster
// (at most 8 blocks, and about two blocks per SM in all). The block walks its
// split in chunks of at most KCH MX blocks, so its shared memory stays under
// 80 KB whatever K is. For each chunk it copies the weight lines (16-byte
// lines of nibbles, 16 columns x 2 K rows each, and the E8M0 lines) into
// shared memory with cp.async, every copy in flight at once. Warp (row pair,
// jw) takes MX blocks jw, jw + 4, ... of the chunk: it encodes its two rows'
// 32-element activation blocks, one element per lane (``encode_rows``: the
// activation pass's ``encode_lanes`` and mx_common.cuh's ``rotate_h32``, so
// the snaps are the plain version's); past MAX_INKERNEL_KBB MX blocks per
// split (``ffn_down``: K = 4864, 19 per split) the tile's activation pass
// (mx_gemm.cuh, with f32 output) encodes each activation block once before
// the GEMV instead. Lane (sub, group) decodes the nibbles of byte rows 2 sub
// and 2 sub + 1 through a 16-entry table once for both rows, and each
// 4-term dot product is scaled by its column's E8M0 power of two (exact) as
// it joins the accumulator; a chunk's sums are added to the earlier chunks'
// in shared memory. The 32 partial sums of each output (8 lanes x 4 warps)
// are added in order through shared memory; each block then pushes its sums
// into the shared memory of the block of the cluster that owns them, and
// after one cluster barrier the owner adds the splits in rank order. No
// float atomics: repeated calls are bitwise identical.
#include <cooperative_groups.h>
#include <stdint.h>

#include "mx_gemm.cuh"

namespace mxgemv {

namespace coop = cooperative_groups;

constexpr int MT = 4;             // activation rows per block (grid.z tiles M)
constexpr int MW = 2;             // rows per warp: they share its code lookups
constexpr int KW = 4;             // warps per row group: MX blocks at once
constexpr int NT = 32 * (MT / MW) * KW;  // threads: warp (row group, block)
constexpr int CG = 4;             // 16-column groups per block: 64 columns
constexpr int SUBS = 32 / CG;     // a group's lanes in a warp, 2 byte rows each
constexpr int PARTS = SUBS * KW;  // partial sums per output
constexpr int OUT = MT * CG * 16; // outputs per block
constexpr int MAX_M = 16;         // larger M takes the wgmma tile
constexpr int MAX_SPLIT = 8;      // K splits: the portable cluster size
constexpr int KCH = 5 * KW;       // MX blocks staged at once (a split of
                                  // Qwen2-0.5B's ffn_down, 19, in one chunk)
constexpr int MAX_INKERNEL_KBB = 2 * KW;  // two activation blocks a warp
static_assert(MAX_INKERNEL_KBB <= KCH, "the encode runs in the 1st chunk");

__device__ __forceinline__ uint32_t word_of(const uint4& w, int q) {
  return q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
}

// e8m0_scale(b) = 2^(b - 127) exactly, without a call: the exponent bits for
// b in 1..254, the subnormal 2^-127 for 0, and ldexpf's inf for 255.
__device__ __forceinline__ float e8m0_exact(uint32_t b) {
  return b == 0u ? __int_as_float(0x00400000)
                 : __int_as_float(b == 255u ? 0x7F800000 : (int)(b << 23));
}

// the 4-bit format tables of mx_gemm.cuh (shared with the activation pass)
using mxgemm::Tables;
using mxgemm::build_tables;

// R rows of one activation 32-block, spread over a warp (lane i holds
// element i of each).
template <int R>
struct Rows {
  float v[R][1];
};

// The T3 rotation of each row (mx_common.cuh's ``rotate_h32``, one element
// a lane), out of line; the rows' shuffles interleave.
template <int R>
__device__ __noinline__ Rows<R> rotate_rows(Rows<R> a, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) rotate_h32<1>(a.v[r], lane);
  return a;
}

// Q_mx of each row, encoded and decoded (mx_gemm.cuh's ``encode_lanes``,
// one element a lane, as the activation pass writes it), out of line.
template <int R>
__device__ __noinline__ Rows<R> encode_rows(const Tables& t, int fmt,
                                            Rows<R> a) {
  mxgemm::encode_lanes<false, R, 1>(t, fmt, true, a.v);
  return a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Copy the 16 bytes of byte row ``row`` at columns n0 .. n0 + 15 of a (rows,
// N) byte matrix into shared ``dst``; columns past N read ``fill``.
// ``kVec``: one 16-byte cp.async.
template <bool kVec>
__device__ __forceinline__ void stage_line(uint4* dst,
                                           const uint8_t* __restrict__ p,
                                           size_t row, int N, int n0,
                                           uint32_t fill) {
  if constexpr (kVec) {
    if (n0 < N) cp_async16(dst, p + row * N + n0);
    else *dst = make_uint4(fill, fill, fill, fill);
  } else {
    uint32_t w[4];
    for (int k = 0; k < 4; ++k) {
      uint32_t v = 0;
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + 4 * k + c;
        v |= (n < N ? (uint32_t)p[row * N + n] : (fill & 0xFFu)) << (8 * c);
      }
      w[k] = v;
    }
    *dst = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Float offset of column ``col`` (0..63) in a row of the reduction buffer:
// the 4-column quads are XOR-swizzled by the group and the parity of the
// partial, so the float4 stores of a quarter warp hit 8 distinct bank groups.
__device__ __forceinline__ int red_pos(int col, int part) {
  const int qd = ((col >> 2) & 3) ^ (((col >> 5) & 1) | ((part & 1) << 1));
  return (col & ~15) | (qd << 2) | (col & 3);
}

constexpr int WROW = 6;  // uint4 per staged byte row: 4 groups + 2 of padding,
                         // so a quarter warp's 16-byte reads hit 8 bank groups

// Dynamic shared memory of a block with ``kbb`` MX blocks per split: one
// chunk of at most KCH MX blocks, about 76 KB at most.
inline size_t smem_bytes(int kbb) {
  const int kch = min(kbb, KCH);
  const int nj = (kch + KW - 1) / KW;              // MX blocks per warp
  return sizeof(uint4) * (size_t)kch * (16 * WROW + CG) +   // weights, E8M0
         sizeof(float) * ((size_t)(NT / 32) * nj * MW * 32 +
                          PARTS * OUT + OUT + MAX_SPLIT) +  // sums, cluster
         sizeof(Tables);
}

// y (M, N) for the column tile blockIdx.x, rows MT * blockIdx.z ...; with
// ``kExperts``, rows MT * (blockIdx.z % mt) ... of expert blockIdx.z / mt
// (x, the weights and y at its offsets; a separate instantiation, so the
// 2-D call keeps its code and registers: the expert's offsets spilled
// there); the cluster (1, gridDim.y, 1) holds the K splits. For each chunk of the split
// (at most KCH MX blocks), the block copies the chunk's weight tile (MX
// blocks x 16 byte rows x 64 columns, and the E8M0 lines) into shared
// memory, all copies in flight at once. Warp (g, jw) takes rows MW * g .. MW
// * g + MW - 1 of the chunk's MX blocks jw, jw + KW, ...; lane = CG * sub +
// cg takes byte rows 2 sub and 2 sub + 1 of each for column group cg, the MW
// rows sharing each code lookup; its sums over each chunk are added, chunk
// by chunk, into row ``part`` of the reduction buffer. ``prequant``: x is
// already Q_mx(x). ``kVec``: N % 16 == 0 and 16-byte aligned weights, so a
// group's 16 columns are one 16-byte line of each byte row.
template <bool kVec, bool kExperts>
__global__ void __launch_bounds__(NT, 4)
gemv_kernel(const float* __restrict__ x_all,
            const uint8_t* __restrict__ wp_all,
            const uint8_t* __restrict__ ws_all, float* __restrict__ y_all,
            int M, int N, int K, int fmt, int t3, int kbb, int prequant) {
  extern __shared__ __align__(16) uint4 smem4[];
  const int kch = min(kbb, KCH), nj = (kch + KW - 1) / KW;
  uint4* wt = smem4;                                  // [kch][16][WROW]
  uint4* st = wt + (size_t)kch * 16 * WROW;           // [kch][CG]
  float* xs = reinterpret_cast<float*>(st + (size_t)kch * CG);
  float* red = xs + (NT / 32) * nj * MW * 32;         // [PARTS][OUT]
  float* recv = red + PARTS * OUT;                    // [OUT + MAX_SPLIT]
  Tables& tab = *reinterpret_cast<Tables*>(recv + OUT + MAX_SPLIT);
  coop::cluster_group cluster = coop::this_cluster();
  // this block has started: the other blocks of the cluster wait for that
  // (below) before they write into its shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int mg = (w / KW) * MW, jw = w % KW;          // rows mg .. + MW - 1
  const int cg = lane % CG, sub = lane / CG, part = jw * SUBS + sub;
  const int nkb = K / 32, kb0 = blockIdx.y * kbb;
  const int nkbs = min(kbb, nkb - kb0);               // MX blocks here
  const int mt = (M + MT - 1) / MT;
  const int ex = kExperts ? (int)blockIdx.z / mt : 0;
  const int nc0 = blockIdx.x * CG * 16;
  const int m0 = (kExperts ? (int)blockIdx.z % mt : (int)blockIdx.z) * MT;
  const float* __restrict__ x =
      kExperts ? x_all + (size_t)ex * M * K : x_all;
  const uint8_t* __restrict__ wp =
      kExperts ? wp_all + (size_t)ex * (K / 2) * N : wp_all;
  const uint8_t* __restrict__ ws =
      kExperts ? ws_all + (size_t)ex * (K / 32) * N : ws_all;
  float* __restrict__ y = kExperts ? y_all + (size_t)ex * M * N : y_all;
  const int center = fmt_center(fmt);
  const uint32_t zw = (uint32_t)(center | (center << 4)) * 0x01010101u;
  build_tables(tab, fmt, tid);
  float* xw = xs + w * nj * MW * 32;                  // [nj][MW][32]
  // the weight lines and E8M0 lines of the chunk's nb MX blocks from kb
  // in flight
  auto stage = [&](int kb, int nb) {
    for (int i = tid; i < nb * 16 * CG; i += NT) {
      const int r = i / CG, g = i % CG;               // byte row, group
      stage_line<kVec>(wt + r * WROW + g, wp, (size_t)kb * 16 + r, N,
                       nc0 + g * 16, zw);
    }
    for (int i = tid; i < nb * CG; i += NT)
      stage_line<kVec>(st + i, ws, kb + i / CG, N, nc0 + (i % CG) * 16,
                       0x7F7F7F7Fu);
    if constexpr (kVec) asm volatile("cp.async.commit_group;\n" ::);
  };
  // element ``lane`` of row mg + r of x in MX block jw + jj * KW of the
  // chunk (zero past the chunk or M)
  auto x_at = [&](int kb, int nb, int jj, int r) {
    const int j = jw + jj * KW;
    return jj < nj && j < nb && m0 + mg + r < M
               ? x[(size_t)(m0 + mg + r) * K + (size_t)(kb + j) * 32 + lane]
               : 0.0f;
  };
  auto load_prequant = [&](int kb, int nb) {
    for (int jj = 0; jj < nj; ++jj)
      for (int r = 0; r < MW; ++r)
        xw[(jj * MW + r) * 32 + lane] = x_at(kb, nb, jj, r);
  };

  // the first chunk; only it encodes in the kernel (a split of more than
  // MAX_INKERNEL_KBB <= KCH MX blocks is prequantized), before the
  // accumulators are live across the encode's calls
  int nb = min(kch, nkbs);
  stage(kb0, nb);
  __syncthreads();                                    // the tables
  // this warp's activation elements
  if (prequant) {
    load_prequant(kb0, nb);
  } else if (nj == 1) {                               // warp-uniform
    Rows<MW> a;
#pragma unroll
    for (int r = 0; r < MW; ++r) a.v[r][0] = x_at(kb0, nb, 0, r);
    if (t3) a = rotate_rows<MW>(a, lane);
    a = encode_rows<MW>(tab, fmt, a);
#pragma unroll
    for (int r = 0; r < MW; ++r) xw[r * 32 + lane] = a.v[r][0];
  } else {
    // two MX blocks per call, so their steps interleave; a block past the
    // chunk holds zeros, which encode to zeros
    for (int j0 = 0; j0 < nj; j0 += 2) {
      Rows<2 * MW> a;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < MW; ++r)
          a.v[h * MW + r][0] = x_at(kb0, nb, j0 + h, r);
      if (t3) a = rotate_rows<2 * MW>(a, lane);
      a = encode_rows<2 * MW>(tab, fmt, a);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (j0 + h >= nj) break;
#pragma unroll
        for (int r = 0; r < MW; ++r)
          xw[((j0 + h) * MW + r) * 32 + lane] = a.v[h * MW + r][0];
      }
    }
  }
  if constexpr (kVec) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int c0 = 0;;) {
    // this chunk's products, added to the earlier chunks' in row ``part``
    // of the reduction buffer (no accumulator is live while the next
    // chunk is staged)
    float acc[MW][16];
#pragma unroll
    for (int r = 0; r < MW; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.0f;
    for (int jj = 0; jj < nj; ++jj) {
      const int j = jw + jj * KW;
      if (j >= nb) break;                             // warp-uniform
      const uint4 w0 = wt[(j * 16 + 2 * sub) * WROW + cg];
      const uint4 w1 = wt[(j * 16 + 2 * sub + 1) * WROW + cg];
      const uint4 sl = st[j * CG + cg];
      float4 xq[MW];
#pragma unroll
      for (int r = 0; r < MW; ++r)
        xq[r] = *reinterpret_cast<const float4*>(xw + (jj * MW + r) * 32 +
                                                 4 * sub);
      // column c: this lane's 4 K values decoded through the code table,
      // the MW rows' dot products, then the block's E8M0 power of two
      // (exact)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int sh = 8 * (c & 3);
        const uint32_t b0 = (word_of(w0, c >> 2) >> sh) & 0xFFu;
        const uint32_t b1 = (word_of(w1, c >> 2) >> sh) & 0xFFu;
        const float v0 = tab.code[b0 & 0xF], v1 = tab.code[b0 >> 4];
        const float v2 = tab.code[b1 & 0xF], v3 = tab.code[b1 >> 4];
        const float sc = e8m0_exact((word_of(sl, c >> 2) >> sh) & 0xFFu);
#pragma unroll
        for (int r = 0; r < MW; ++r) {
          float p = xq[r].x * v0;
          p = fmaf(xq[r].y, v1, p);
          p = fmaf(xq[r].z, v2, p);
          p = fmaf(xq[r].w, v3, p);
          acc[r][c] = fmaf(p, sc, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MW; ++r)
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        float4* dst = reinterpret_cast<float4*>(
            red + part * OUT + (mg + r) * CG * 16 +
            red_pos(cg * 16 + qd * 4, part));
        float4 v = make_float4(acc[r][4 * qd], acc[r][4 * qd + 1],
                               acc[r][4 * qd + 2], acc[r][4 * qd + 3]);
        if (c0 > 0) {
          const float4 o = *dst;
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        *dst = v;
      }
    c0 += kch;
    if (c0 >= nkbs) break;
    // the next chunk (prequantized activations), once this one is read
    nb = min(kch, nkbs - c0);
    __syncthreads();
    stage(kb0 + c0, nb);
    load_prequant(kb0 + c0, nb);
    if constexpr (kVec) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  __syncthreads();
  // every block of the cluster has started (arrived above), so its shared
  // memory may be written; then push each sum of the PARTS partials (in
  // order) to the block of the cluster that owns it (outputs [k * per, (k +
  // 1) * per) belong to rank k), at this block's rank
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int rank = (int)cluster.block_rank(), nsp = (int)cluster.num_blocks();
  const int per = (OUT + nsp - 1) / nsp;
  for (int o = tid; o < OUT; o += NT) {
    const int mo = o / (CG * 16), col = o % (CG * 16);
    float s = 0.0f;
#pragma unroll 8
    for (int l = 0; l < PARTS; ++l)
      s += red[l * OUT + mo * CG * 16 + red_pos(col, l)];
    cluster.map_shared_rank(recv, o / per)[rank * per + o % per] = s;
  }
  cluster.sync();
  // this block's outputs: the splits added in rank order
  for (int i = tid; i < per && rank * per + i < OUT; i += NT) {
    const int o = rank * per + i;
    float s = 0.0f;
    for (int k = 0; k < nsp; ++k) s += recv[k * per + i];
    const int mo = o / (CG * 16), n = nc0 + o % (CG * 16);
    if (m0 + mo < M && n < N) y[(size_t)(m0 + mo) * N + n] = s;
  }
}

template <bool kVec, bool kExperts>
cudaError_t launch_gemv(cudaStream_t s, dim3 grid, int nsplit,
                        const float* x, const uint8_t* wp, const uint8_t* ws,
                        float* y, int M, int N, int K, int fmt, int t3,
                        int kbb, int prequant) {
  const size_t shm = smem_bytes(kbb);
  cudaError_t e = cudaFuncSetAttribute(
      gemv_kernel<kVec, kExperts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = nsplit;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemv_kernel<kVec, kExperts>, x, wp, ws,
                            y, M, N, K, fmt, t3, kbb, prequant);
}

int launch(const void* x, void* scratch, const void* wp, const void* ws,
           void* y, int E, int M, int N, int K, int fmt, int t3,
           void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int ncg = (N + 15) / 16, nkb = K / 32;
  const int ct = (ncg + CG - 1) / CG, mt = (M + MT - 1) / MT * E;
  // one MX block per warp of a split where K allows, at most a cluster's
  // worth of splits, and no more splits than about two blocks per SM need
  // (past that, the waves of blocks cost more than the longer splits)
  const int want = (2 * sms + ct * mt - 1) / (ct * mt);
  int nsplit = max(1, min(min(MAX_SPLIT, (nkb + KW - 1) / KW), want));
  const int kbb = (nkb + nsplit - 1) / nsplit;
  nsplit = (nkb + kbb - 1) / kbb;
  const int prequant = kbb > MAX_INKERNEL_KBB;
  const float* xin = static_cast<const float*>(x);
  if (prequant) {
    e = mxgemm::launch_act<false>(s, xin, static_cast<float*>(scratch),
                                  E * M, K, fmt, t3);
    if (e != cudaSuccess) return (int)e;
    xin = static_cast<const float*>(scratch);
  }
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0
                   && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  const dim3 grid(ct, nsplit, mt);
  const uint8_t* w8 = static_cast<const uint8_t*>(wp);
  const uint8_t* s8 = static_cast<const uint8_t*>(ws);
  float* yf = static_cast<float*>(y);
  auto run = [&](auto fn) {
    return fn(s, grid, nsplit, xin, w8, s8, yf, M, N, K, fmt, t3, kbb,
              prequant);
  };
  e = E > 1 ? (vec ? run(launch_gemv<true, true>)
                   : run(launch_gemv<false, true>))
            : (vec ? run(launch_gemv<true, false>)
                   : run(launch_gemv<false, false>));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace mxgemv

// E experts (1 for a plain 2-D call), each contiguous after the one before:
// x (E, M, K) f32, 16-byte aligned; scratch: at least 2*E*M*K bytes for M >
// 16 (the bf16 activations of the tile path), at least 4*E*M*K bytes for M
// <= 16 (the encoded f32 activations of the small-M kernel's prepass); wp (E,
// K/2, N) u8, ws (E, K/32, N) u8, y (E, M, N) f32. K % 32 == 0. Returns
// cudaGetLastError() after the launches.
extern "C" int mx_gemm_packed_launch(const void* x, void* xq, const void* wp,
                                     const void* ws, void* y, int E, int M,
                                     int N, int K, int fmt, int t3,
                                     void* stream) {
  if (E <= 0 || M <= 0 || N <= 0 || K % 32 != 0 || fmt_bits(fmt) != 4
      || (M + mxgemv::MT - 1) / mxgemv::MT * E > 65535)
    return (int)cudaErrorInvalidValue;
  if (M <= mxgemv::MAX_M)
    return mxgemv::launch(x, xq, wp, ws, y, E, M, N, K, fmt, t3, stream);
  mxgemm::PackedE8M0Weights w{static_cast<const uint8_t*>(wp),
                              static_cast<const uint8_t*>(ws)};
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0
                   && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  return mxgemm::launch(x, xq, w, vec, y, E, M, N, K, fmt, t3, stream);
}
