// Paged flash-prefill attention fused with the chunk's quantize-on-append,
// for Hopper's tensor cores.
//
// Replaces the Pallas kernel ``_flash_prefill_kernel`` of the JAX package
// (src/repro/kernels/mx_attention.py:393; its entry point
// ``mx_flash_prefill`` at :478, the ``pallas_call`` at :582).
//
// q (B, C, H, Dh) f32 — a C-token chunk per lane; K/V chunk (B, C, D) f32;
// K/V pools (N, P, D*bits/8) u8 + (N, P, D/32) u8 E8M0; block tables
// (B, maxp) i32; q_start, kv_len (B,) i32. Outputs: out (B, C, H, Dh) f32 and
// the chunk's bytes (B, C, D*bits/8) + (B, C, D/32) for K and V, equal to
// ``kv_encode`` of the chunk — the caller scatters them into the pool.
//
// What bounds it on an H100: the operations. A 1024-row chunk against up to
// a page of prefix does ~4 FLOPs per (query head, key, feature) over ~1e3
// keys per byte moved, far above the memory roofline. Exact products on the
// tensor cores take three times the bf16 work (below); the exps, masks and
// splits of the softmax and the K/V decode run on the CUDA cores beside
// them, and at one block of 12 warps per SM (registers) what is left is
// latency: each block's start and each tile's hand-offs
// (scripts/prefill_passes.py times the parts).
//
// Pass 1 (``kv_quant_kernel``, twice): encodes the chunk's K and V, a warp
// per four 32-blocks, and writes the byte outputs — exactly one writer per
// chunk row.
//
// Pass 2 (``flash_prefill_kernel``): a block owns one (lane, KV head) and
// up to ROWS consecutive rows r = i G + g of the lane's (query position i,
// head g of the KV head's G) — ROWS is 128 for heads up to 64 wide, 64 for
// heads up to 128 — whole positions where G <= ROWS, else ROWS rows of a
// position's heads: one decoded K/V tile serves every head of ROWS / G
// positions (18 for Qwen2-0.5B's G = 7, 9 for Qwen2-7B's). Its keys: the
// committed prefix through the block table (pool rows valid iff kp <
// q_start, so a mid-page resume never counts a row twice), then the chunk
// rows pass 1 wrote (row i at q_start + i) — attention reads the round trip
// of exactly the bytes the pool receives — in stages of TS keys aligned to
// TS (128 keys for heads up to 64 wide, 64 for wider ones), from the
// window's first key to the block's last position (wholly masked stages
// are never visited). With heads up to 64 wide every block ranks the
// (lane, row tile) items by their stages from q_start and kv_len, and the
// items start most work first; with wider heads they start in order of
// row tiles.
//
//   * Warps NCW .. NCW + 3, the decoder warpgroup: thread 0 keeps a ring of
//     four raw stages filled by TMA (the head's code bytes of TS key rows,
//     boxes of gcd(P, 64) rows from the pages the block table names — kept
//     in shared memory — or from the chunk's bytes; the rows' E8M0 bytes as
//     1D boxes), each ordered by a transaction-count mbarrier. Every
//     thread decodes its share of each stage once, through a 256-entry
//     table, into bf16 in a ring of two stages, in the layout wgmma reads
//     (K as 64-key rows of each 64-feature panel of the head, V transposed
//     as feature rows of 64 keys; 128-byte rows, 128-byte swizzle); rows
//     past the stage's last valid key decode to 0. No decoder thread has a
//     global load in flight at its proxy fence, which waits for all of them.
//   * Warps 0 .. NCW - 1, consumer warpgroups of 64 rows (two for heads up
//     to 64 wide, one for wider heads: its O accumulator has 64 registers a
//     thread), per 64 keys: S = Q K^T by ``wgmma`` m64n64k16 with Q from
//     shared memory (4 k16 steps per 64-feature panel), the online softmax
//     on the accumulator fragment in registers (row max and sum by quad
//     shuffles, masked scores at -inf and probabilities at 0, the causal,
//     fill and window masks per element only on tiles that cross a bound),
//     then O += P V by ``wgmma`` m64n{64,128}k16 with P from registers (the
//     S fragment re-packed as the A operand), V from the ring. A tile
//     wholly masked for a warpgroup's rows is skipped by it (an exact no-op
//     of the online softmax). O / max(l, 1e-30) goes out from registers.
//
// Exactness: every decoded K/V value is an MX code value (at most 4
// significant bits, 7 for int8) times an E8M0 power of two, exact in bf16
// (8 bits, f32's exponent range) whenever its f32 form is normal. Q and P are
// f32: each is split into hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
// - mid), which sum to x exactly, and each product runs three times, once
// per term. A bf16 x bf16 product is exact in f32, so S and P V differ from
// the plain version only in the order of f32 additions (two terms would
// leave ~2^-17 of each element). The score scale 1/sqrt(Dh) multiplies S in
// f32, as in the plain version.
//
// Shapes: Dh a multiple of 16 up to 128 (one or two 128-byte operand
// panels; a narrower head's columns are zero), G <= 128, P a multiple of
// 16. The kernel is instantiated per code width and per head width (up to
// 64, up to 128), so the narrow heads' build pays nothing for the wide.
// Why 64 rows a block for wide heads: two consumer warpgroups of 64 rows
// each would need 64 O registers a thread beside S and the split P, more
// than the 168 a thread that 384 threads leave, and Q's three terms and two
// 128-key decoded stages would fill shared memory. One consumer warpgroup
// (256 threads, up to 255 registers each) with 64-key stages keeps the
// narrow layout's shared memory; each decoded stage then serves 64 rows,
// not 128. (The other known fit, 128 rows with the decoder's registers
// handed to the consumers by ``setmaxnreg``, is untried.)
#include "mx_gemm.cuh"

namespace {

using mxgemm::bar_sync;
using mxgemm::desc_b128;
using mxgemm::fence_proxy_async;
using mxgemm::mbar_arrive;
using mxgemm::mbar_expect_tx;
using mxgemm::mbar_init;
using mxgemm::mbar_wait;
using mxgemm::smem_u32;
using mxgemm::swz;
using mxgemm::tma_load_2d;
using mxgemm::wgmma_commit;
using mxgemm::wgmma_fence;
using mxgemm::wgmma_wait0;

constexpr int TK = 64;                   // keys per wgmma operand tile
constexpr int RING = 2;                  // decoded K/V stages
constexpr int OP_BYTES = 64 * 128;       // a bf16 operand tile: 64 x 128 B
constexpr int MAX_ITEMS = 512;           // (lane, row tile) items ranked
constexpr int PGCAP = 1024;              // page ids a block keeps in smem

// The tiling of the instantiation for heads up to kDh (64 or 128) wide.
// Either way a decoded stage is four operand tiles (K and V, NH 64-key
// tiles of NP 64-feature panels) and Q three terms of NP panels for each
// consumer warpgroup: six tiles.
template <int kDh>
struct Tiling {
  static constexpr int NP = kDh / 64;              // 64-feature panels
  static constexpr int NCW = kDh == 64 ? 8 : 4;    // consumer warps
  static constexpr int NTH = 32 * (NCW + 4);       // + the decoder warpgroup
  static constexpr int ROWS = 16 * NCW;            // (position, head) rows
  static constexpr int NH = 2 / NP;                // 64-key tiles a stage
  static constexpr int TS = TK * NH;               // keys a stage
  static constexpr int NO = 32 * NP;               // O registers a thread
  static_assert(kDh == 64 || kDh == 128, "heads up to 64 or 128 wide");
};
constexpr float NEG_INF = -1e30f;

// For timing the kernel's parts (scripts/prefill_passes.py): built with
// -DMXPREFILL_LEAVE_OUT=bits, the attention leaves out the decoder's TMA
// loads (1), its decode (2), the wgmmas (4), the softmax (8), the
// decoder's proxy fence (32) or the ranking of the blocks' work (64), and
// its output is wrong (but for 64).
#ifndef MXPREFILL_LEAVE_OUT
#define MXPREFILL_LEAVE_OUT 0
#endif
constexpr int LEAVE_OUT = MXPREFILL_LEAVE_OUT;

constexpr size_t SMEM_BYTES = 1024 + (size_t)(6 + 4 * RING) * OP_BYTES +
                              (256 + PGCAP) * 4 + 2 * RING * sizeof(uint64_t);

// Pass 1: x (nblk 32-blocks of f32) -> codes + E8M0 bytes, ``kv_encode``'s
// bytes. A warp takes four 32-blocks at a time: lane l loads (16 bytes)
// elements 4 (l % 8) .. + 3 of block l / 8, so a block lies on 8 lanes and
// a warp's loads are 512 contiguous bytes; mx_common.cuh's
// ``mx_encode_quad`` (the standalone quantizers' encode) gives the codes
// and the scale exponent, so the bytes are the same.
constexpr int QWARPS = 8;        // warps per block of the encode
__global__ void __launch_bounds__(32 * QWARPS)
kv_quant_kernel(const float* __restrict__ x, uint8_t* __restrict__ codes,
                uint8_t* __restrict__ scales, long long nblk, int fmt) {
  __shared__ float mids[128];
  fill_snap_mids(mids, fmt, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const long long blk =
      ((long long)blockIdx.x * QWARPS + threadIdx.x / 32) * 4 + lane / 8;
  const int e = 4 * (lane % 8);
  float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (blk < nblk) f = __ldg(reinterpret_cast<const float4*>(x + blk * 32 + e));
  const float v[4] = {f.x, f.y, f.z, f.w};
  uint32_t c[4];
  const int sexp = mx_encode_quad(fmt, v, mids, c);
  if (blk >= nblk) return;
  if (lane % 8 == 0) scales[blk] = e8m0_byte(sexp);
  if (fmt_bits(fmt) == 8) {
    *reinterpret_cast<uint32_t*>(codes + blk * 32 + e) =
        c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
  } else {
    *reinterpret_cast<unsigned short*>(codes + blk * 16 + e / 2) =
        (unsigned short)(c[0] | (c[1] << 4) | (c[2] << 8) | (c[3] << 12));
  }
}

// d (64 x 64 f32, wgmma's fragment layout) (+)= A (64 x 16) B (16 x 64),
// both operands in shared memory.
__device__ __forceinline__ void wgmma64_ss(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16, bf16 from registers in the fragment layout
// of mma's m16k16 A per warp) B (16 x 64, shared memory).
__device__ __forceinline__ void wgmma64_rs(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16, bf16 from registers as above) B (16 x
// 128, shared memory): the P V product over V^T's two 64-feature panels.
__device__ __forceinline__ void wgmma128_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep the compiler from moving accesses of ``d`` across an asynchronous
// wgmma (it does not see that the tensor cores read or write ``d`` after
// issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + mid + lo exactly, each term a bf16 pair (x0 in the low
// half): the three-term split of an f32 operand.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 fh = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, fh.x), r1 = __fsub_rn(x1, fh.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 fm = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, fm.x), __fsub_rn(r1, fm.y));
  hi = bf2_bits(h);
  mid = bf2_bits(m);
  lo = bf2_bits(l);
}

// E8M0 byte -> its scale 2^(b - 127) as bf16 bits (exponent field b; 2^-127
// is the subnormal 0x0040); ``NO_ROW`` (a row past the tile's last valid
// key) -> 0.
constexpr uint32_t NO_ROW = 256;
__device__ __forceinline__ uint32_t scale_bits(uint32_t b) {
  return b == NO_ROW ? 0u : (b ? b << 7 : 0x40u);
}

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t lo16, uint32_t hi16) {
  return __halves2bfloat162(__ushort_as_bfloat16((unsigned short)lo16),
                            __ushort_as_bfloat16((unsigned short)hi16));
}

__device__ __forceinline__ uint32_t mul_bits(__nv_bfloat162 v,
                                             __nv_bfloat162 s) {
  return bf2_bits(__hmul2(v, s));
}

// A block's key stages: the prefix's, then the chunk's; each source's keys
// [t0, hi) in stages of TS from t0 (a multiple of TS).
template <int TS>
struct Plan {
  int npt, pt0, phi;     // prefix: stages, first key, end (key = position)
  int nct, ct0, chi;     // chunk: stages, first row, end (row i at q_start + i)
  // the keys of query rows i0 .. i1 - 1 of a lane at q_start st, kv_len kl:
  // the window's first key to the last row's position
  __device__ Plan(int st, int kl, int i0, int i1, int C, int window,
                  int limit) {
    const int qp_lo = st + i0, qp_hi = st + i1 - 1;
    const int plo = window > 0 ? max(0, qp_lo - window + 1) : 0;
    phi = min(min(st, kl), min(qp_hi + 1, limit));
    pt0 = plo & ~(TS - 1);
    npt = phi > plo ? (phi - pt0 + TS - 1) / TS : 0;
    const int clo = window > 0 ? max(0, i0 - window + 1) : 0;
    chi = min(min(C, i1), kl - st);
    ct0 = clo & ~(TS - 1);
    nct = chi > clo ? (chi - ct0 + TS - 1) / TS : 0;
  }
  __device__ int n() const { return npt + nct; }
  __device__ void at(int t, int& src, int& k0, int& hi) const {
    if (t < npt) {
      src = 0; k0 = pt0 + TS * t; hi = phi;
    } else {
      src = 1; k0 = ct0 + TS * (t - npt); hi = chi;
    }
  }
};

// The query positions [i0, i1) of the block's rows [rb, rb + R) (row r of
// the lane: position r / G, head r % G).
__device__ __forceinline__ void row_span(int rb, int R, int G, int& i0,
                                         int& i1) {
  i0 = rb / G;
  i1 = (rb + R - 1) / G + 1;
}

// One 64-key tile's bytes of one 64-feature panel for one decoder thread:
// K rows (w >> 3) + 16 j, features 8 (w & 7) .. + 7; V rows 8 (w >> 4) ..
// + 7, features 4 (w & 15) .. + 3 (of the panel).
struct Raw {
  uint32_t k[4][2];   // 8 codes (8-bit) or 8 nibbles in k[j][0]
  uint32_t v[8];      // 4 codes (8-bit) or 4 nibbles in the low half
  uint32_t ks[4], vs[8];   // E8M0 bytes, NO_ROW past the last valid key
};

// TMA: the 1D box of ``map`` at element c0 into shared ``dst``; its bytes
// complete on ``bar``. Boxes past the end read zeros.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// The TMA maps of the K/V bytes a block reads: the pools' (N P rows) and
// the chunk's (B C rows, as pass 1 wrote them). Codes: rows of D*bits/8
// bytes, boxes of BH rows x CB bytes; scales: one run of bytes, boxes of
// SR rows x D/32 bytes.
struct Maps {
  CUtensorMap kc[2], vc[2], ks[2], vs[2];   // [0] the pools, [1] the chunk
};

// How a stage's bytes land in a raw stage: K codes, V codes (TS rows of CB
// bytes each: the head's bytes where they are a multiple of 16, else whole
// rows), then the K and V scales, each box of SR rows in a 128-byte slot of
// SP bytes. A stage takes TS / BH code boxes per operand, BH = gcd(P, 64).
struct Geo {
  int CB, BH, SR, SP, RB, RAWST;
  bool per_head;      // CB holds only the head's bytes
};

// O (64 x 64 NP f32) += P V for one k16 step: m64n64k16, or m64n128k16 over
// the two panels of V^T (128 feature rows, contiguous).
template <int NP>
__device__ __forceinline__ void wgmma_pv(float (&d)[32 * NP],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NP == 1) wgmma64_rs(d, a, db); else wgmma128_rs(d, a, db);
}

// RPB: rows of a block (a multiple of G where G <= ROWS: whole positions);
// nrt: row tiles of a lane.
template <int kBits, int kDh>
__global__ void __launch_bounds__(Tiling<kDh>::NTH, 1)
flash_prefill_kernel(const __grid_constant__ Maps maps, const Geo geo,
                     const float* __restrict__ q,
                     const int* __restrict__ tables,
                     const int* __restrict__ q_start,
                     const int* __restrict__ kv_len, float* __restrict__ out,
                     int B, int C, int H, int Dh, int D, int P, int maxp,
                     int fmt, int window, int RPB, int nrt) {
  using T = Tiling<kDh>;
  constexpr int NP = T::NP, NCW = T::NCW, NTH = T::NTH, NH = T::NH;
  constexpr int TS = T::TS, NO = T::NO;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // [consumer warpgroups][3 terms][NP panels][OP]
  uint8_t* Qs = base;
  // [RING][K tiles, V tiles][OP]: the NH x NP K tiles (64-key rows of a
  // 64-feature panel; tile h NP + p) then the V tiles (V^T: panel p's 64
  // feature rows of tile h's 64 keys)
  uint8_t* ring = Qs + 6 * OP_BYTES;
  uint8_t* raw = ring + RING * 4 * OP_BYTES;   // [RAWST][RB]: TMA's bytes
  uint32_t* tab = reinterpret_cast<uint32_t*>(raw + geo.RAWST * geo.RB);
  int* pgs = reinterpret_cast<int*>(tab + 256);   // [PGCAP] the block's pages
  uint64_t* full = reinterpret_cast<uint64_t*>(pgs + PGCAP);
  uint64_t* empty = full + RING;
  uint64_t* rawfull = empty + RING;            // [RAWST]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = D / Dh, G = H / kvh;
  constexpr int bits = kBits;
  const int ns = D / 32;
  const int CG = C * G;                        // rows of a lane

  // The block's (lane, row tile) item: the kvh blocks of an item are
  // consecutive, and the items go in order of their key stages, most first
  // (ties: the later row tile, then the lower lane), which every block
  // ranks alike from q_start and kv_len; past MAX_ITEMS items, and for
  // heads over 64 wide, in order of row tiles alone (there every block
  // ranks twice the items with two thirds of the threads, and the ranking
  // cost more than the order saved: PERF.md). Scratch: the ring, before
  // the decoder writes it.
  const int items = B * nrt, rank = blockIdx.x / kvh, hk = blockIdx.x % kvh;
  int item = rank;                            // item (nrt - 1 - rt) B + b
  if (kDh == 64 && items <= MAX_ITEMS && !(LEAVE_OUT & 64)) {
    int* work = reinterpret_cast<int*>(ring);
    int* pick = work + MAX_ITEMS;
    for (int i = tid; i < items; i += NTH) {
      const int bi = i % B, a = (nrt - 1 - i / B) * RPB;
      int a0, a1;
      row_span(a, min(RPB, CG - a), G, a0, a1);
      work[i] = Plan<TS>(q_start[bi], kv_len[bi], a0, a1, C, window,
                         maxp * P).n();
    }
    __syncthreads();
    for (int i = tid; i < items; i += NTH) {
      const int wi = work[i];
      int r = 0;
#pragma unroll 8
      for (int j = 0; j < items; ++j) {
        const int wj = work[j];
        r += wj > wi || (wj == wi && j < i);
      }
      if (r == rank) *pick = i;
    }
    __syncthreads();
    item = *pick;
  }
  const int b = item % B, rt = nrt - 1 - item / B;
  const int rb = rt * RPB, R = min(RPB, CG - rb);   // the block's lane rows
  int i0, i1;
  row_span(rb, R, G, i0, i1);
  const int st = q_start[b], kl = kv_len[b];
  const Plan<TS> pl(st, kl, i0, i1, C, window, maxp * P);
  const int ntiles = pl.n();

  // decode table: 8-bit formats, code -> bf16 value; 4-bit formats, byte ->
  // bf16 pair of its two nibbles' values (low nibble first)
  for (int i = tid; i < 256; i += NTH)
    tab[i] = bf2_bits(bits == 8
        ? __floats2bfloat162_rn(decode_code(fmt, i), 0.0f)
        : __floats2bfloat162_rn(decode_code(fmt, i & 15),
                                decode_code(fmt, i >> 4)));
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 4);          // lane 0 of each decoder warp
      mbar_init(&empty[s], NCW);       // lane 0 of each consumer warp
    }
    for (int s = 0; s < geo.RAWST; ++s) mbar_init(&rawfull[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCW) {
    // ---------------- decoder warpgroup ----------------
    // Thread 0 keeps the raw ring full: the TMA boxes of stage t + RAWST go
    // out once every decoder thread has read stage t's. Every thread
    // decodes its share of each stage from shared memory; no decoder thread
    // has a global load in flight at its proxy fence (which waits for all
    // of them).
    const int w = tid - 32 * NCW;
    const int c8 = w & 7, grp = w >> 3;        // K: feature chunk, key rows
    const int vk8 = w >> 4, vf4 = w & 15;      // V: key chunk, features
    const int hb = Dh * bits / 8;              // the head's bytes in a row
    const int cin = geo.per_head ? 0 : hk * hb;
    const int CB = geo.CB, BH = geo.BH, SR = geo.SR, SP = geo.SP;
    const int nbox = TS / BH;                  // code boxes a stage
    const int npc = BH / SR;                   // scale boxes a code box
    const int sreg = nbox * npc * SP;          // a stage's scale bytes
    const int srs = __ffs(SR) - 1;             // SR = 2^srs
    // the page ids of the block's prefix keys, from shared memory where
    // they fit (else from the table), so thread 0 has no global load in
    // flight at its fence
    const int pg0 = pl.pt0 / P;
    const int npg = pl.npt > 0 ? (pl.phi - 1) / P - pg0 + 1 : 0;
    const int* pages = tables + b * maxp;      // page id of page p:
    int poff = 0;                              // pages[p - poff]
    if (npg <= PGCAP) {
      for (int i = w; i < npg; i += 128) pgs[i] = __ldg(pages + pg0 + i);
      bar_sync(3, 128);
      pages = pgs;
      poff = pg0;
    }
    auto issue = [&](int t, int slot) {
      int src, k0, hi;
      pl.at(t, src, k0, hi);
      uint8_t* rs = raw + slot * geo.RB;
      uint64_t* bar = &rawfull[slot];
      if constexpr (LEAVE_OUT & 1) {
        mbar_arrive(bar);
        return;
      }
      const int nb = min(nbox, (hi - k0 + BH - 1) / BH);   // boxes with a key
      const int pb = SR * ns + (src ? 16 : 0);               // scale box bytes
      mbar_expect_tx(bar, (uint32_t)nb * 2 * (BH * CB + npc * pb));
      const int cx = geo.per_head ? hk * hb : 0;
      for (int j = 0; j < nb; ++j) {
        const int k = k0 + j * BH;
        const int row = src ? b * C + k : pages[k / P - poff] * P + k % P;
        tma_load_2d(rs + j * BH * CB, &maps.kc[src], bar, cx, row);
        tma_load_2d(rs + (TS + j * BH) * CB, &maps.vc[src], bar, cx, row);
        for (int p = 0; p < npc; ++p) {
          // a box starts on 16 bytes: the chunk's from the 16 below
          const int slot_off = 2 * TS * CB + (j * npc + p) * SP;
          const int c0 = ((row + p * SR) * ns) & ~(src ? 15 : 0);
          tma_load_1d(rs + slot_off, &maps.ks[src], bar, c0);
          tma_load_1d(rs + slot_off + sreg, &maps.vs[src], bar, c0);
        }
      }
    };
    // this thread's bytes of tile h (keys 64 h ..), panel pn (features
    // 64 pn ..) of stage t, from raw stage ``rs``
    auto fetch = [&](int t, int h, int pn, const uint8_t* rs, Raw& r) {
      int src, k0, hi;
      pl.at(t, src, k0, hi);
      const uint8_t* kc = rs;
      const uint8_t* vc = rs + TS * CB;
      const uint8_t* kss = rs + 2 * TS * CB;
      const uint8_t* vss = kss + sreg;
      const int f0 = hk * Dh + 64 * pn;        // the panel's first feature
      const int ksi = (f0 + 8 * c8) >> 5, vsi = (f0 + 4 * vf4) >> 5;
      const int cp = cin + 64 * pn * bits / 8;  // the panel's first byte
      // scale bytes of stage row ``row``: its box's slot, the box's offset
      // from 16 bytes (chunk rows b C + k need not start on 16), the row
      auto srow = [&](int row) {
        const int pc = row >> srs;
        const int lead = src ? ((b * C + k0 + pc * SR) * ns) & 15 : 0;
        return pc * SP + lead + (row & (SR - 1)) * ns;
      };
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = TK * h + grp + 16 * j;
        const uint8_t* p = kc + row * CB + cp;
        if constexpr (bits == 8) {
          const uint2 u = *reinterpret_cast<const uint2*>(p + 8 * c8);
          r.k[j][0] = u.x;
          r.k[j][1] = u.y;
        } else {
          r.k[j][0] = *reinterpret_cast<const uint32_t*>(p + 4 * c8);
          r.k[j][1] = 0;
        }
        r.ks[j] = k0 + row < hi ? kss[srow(row) + ksi] : NO_ROW;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = TK * h + 8 * vk8 + i;
        const uint8_t* p = vc + row * CB + cp;
        r.v[i] = bits == 8
            ? *reinterpret_cast<const uint32_t*>(p + 4 * vf4)
            : (uint32_t)*reinterpret_cast<const unsigned short*>(p + 2 * vf4);
        r.vs[i] = k0 + row < hi ? vss[srow(row) + vsi] : NO_ROW;
      }
    };
    auto decode = [&](const Raw& raw, int pn, uint8_t* Kd, uint8_t* Vd) {
      const bool kcol = 64 * pn + 8 * c8 < Dh, vcol = 64 * pn + 4 * vf4 < Dh;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sb = scale_bits(raw.ks[j]);
        const __nv_bfloat162 s = bf2(sb, sb);
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (bits == 8) {
            const uint32_t wd = raw.k[j][i >> 1], sh = 16 * (i & 1);
            o[i] = mul_bits(bf2(tab[(wd >> sh) & 0xFF],
                                tab[(wd >> (sh + 8)) & 0xFF]), s);
          } else {
            const uint32_t e = tab[(raw.k[j][0] >> (8 * i)) & 0xFF];
            o[i] = mul_bits(bf2(e & 0xFFFF, e >> 16), s);
          }
        }
        *reinterpret_cast<uint4*>(Kd + swz(grp + 16 * j, c8)) =
            kcol ? make_uint4(o[0], o[1], o[2], o[3]) : make_uint4(0, 0, 0, 0);
      }
      // V transposed: feature 4 vf4 + f, keys 8 vk8 .. + 7 in one chunk
      uint32_t val[8][4];     // bf16 bits of (row i, feature f), unscaled
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (bits == 8) {
#pragma unroll
          for (int f = 0; f < 4; ++f)
            val[i][f] = tab[(raw.v[i] >> (8 * f)) & 0xFF] & 0xFFFF;
        } else {
          const uint32_t e0 = tab[raw.v[i] & 0xFF];
          const uint32_t e1 = tab[(raw.v[i] >> 8) & 0xFF];
          val[i][0] = e0 & 0xFFFF; val[i][1] = e0 >> 16;
          val[i][2] = e1 & 0xFFFF; val[i][3] = e1 >> 16;
        }
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        uint32_t o[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          o[m] = mul_bits(bf2(val[2 * m][f], val[2 * m + 1][f]),
                          bf2(scale_bits(raw.vs[2 * m]),
                              scale_bits(raw.vs[2 * m + 1])));
        *reinterpret_cast<uint4*>(Vd + swz(4 * vf4 + f, vk8)) =
            vcol ? make_uint4(o[0], o[1], o[2], o[3]) : make_uint4(0, 0, 0, 0);
      }
    };

    const int RAWST = geo.RAWST;
    if (w == 0)
      for (int t = 0; t < min(RAWST, ntiles); ++t) issue(t, t);
    for (int t = 0; t < ntiles; ++t) {
      const int rs = t % RAWST, s = t % RING;
      int src, k0, hi;
      pl.at(t, src, k0, hi);
      mbar_wait(&rawfull[rs], (t / RAWST) & 1);
      if (t >= RING) mbar_wait(&empty[s], ((t / RING) - 1) & 1);
      if constexpr (!(LEAVE_OUT & 2)) {
        uint8_t* st4 = ring + s * 4 * OP_BYTES;
        for (int h = 0; h < NH && k0 + TK * h < hi; ++h)
#pragma unroll
          for (int pn = 0; pn < NP; ++pn) {
            Raw r;
            fetch(t, h, pn, raw + rs * geo.RB, r);
            decode(r, pn, st4 + (h * NP + pn) * OP_BYTES,
                   st4 + (2 + h * NP + pn) * OP_BYTES);
          }
      }
      // the stores above before wgmma reads them, and the reads of the raw
      // stage before TMA writes it again
      if constexpr (!(LEAVE_OUT & 32)) fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
      bar_sync(3, 128);
      if (w == 0 && t + RAWST < ntiles) issue(t + RAWST, rs);
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  const int g = warp / 4, t128 = tid % 128;
  uint8_t* Qg = Qs + g * 3 * NP * OP_BYTES;
  {
    // rows 64 g + (t128 >> 3) + 16 j, features 64 pn + 8 (t128 & 7) .. + 7:
    // the three bf16 terms of each, into their swizzled operand tiles
    const int c8 = t128 & 7;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = (t128 >> 3) + 16 * j, r = 64 * g + rl;
        const int f = 64 * pn + 8 * c8;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (r < R && f < Dh) {
          const int i = (rb + r) / G, h = hk * G + (rb + r) % G;
          const float4* p = reinterpret_cast<const float4*>(
              q + (((size_t)b * C + i) * H + h) * Dh + f);
          const float4 a0 = __ldg(p), a1 = __ldg(p + 1);
          v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
          v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
        }
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split3(v[2 * i], v[2 * i + 1], hi[i], mid[i], lo[i]);
        const int off = swz(rl, c8);
        uint8_t* Qp = Qg + pn * OP_BYTES;
        *reinterpret_cast<uint4*>(Qp + off) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(Qp + NP * OP_BYTES + off) =
            make_uint4(mid[0], mid[1], mid[2], mid[3]);
        *reinterpret_cast<uint4*>(Qp + 2 * NP * OP_BYTES + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    fence_proxy_async();
    bar_sync(1 + g, 128);
  }

  // this thread's fragment rows ra, rb8 = ra + 8 and their query positions;
  // the warpgroup's first and last position
  const int ra = 64 * g + 16 * (warp % 4) + lane / 4, rb8 = ra + 8;
  const int qpa = st + (rb + ra) / G, qpb = st + (rb + rb8) / G;
  const bool has_rows = 64 * g < R;
  const int qmin = st + (rb + 64 * g) / G;
  const int qmax = st + (rb + min(64 * g + 63, R - 1)) / G;
  const float sm = 1.0f / sqrtf((float)Dh);
  const uint32_t qa = smem_u32(Qg);

  float o[NO], s[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  float ma = NEG_INF, mb = NEG_INF, la = 0.0f, lb = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    const int slot = t % RING;
    int src, k0t, hi;
    pl.at(t, src, k0t, hi);
    const int kb = src ? st : 0;               // position of key k: kb + k
    mbar_wait(&full[slot], (t / RING) & 1);
    for (int hf = 0; hf < NH; ++hf) {          // the stage's 64-key tiles
      const int k0 = k0t + TK * hf;
      if (k0 >= hi) break;
      const int kpf = kb + k0, kpl = kb + min(k0 + TK, hi) - 1;
      if (!has_rows || kpf > qmax || (window > 0 && kpl <= qmin - window))
        continue;
      const bool masked = !(k0 + TK <= hi && kpf + TK - 1 <= qmin &&
                            (window == 0 || kpf > qmax - window));
      const uint32_t ka = smem_u32(ring + (4 * slot + hf * NP) * OP_BYTES);
      const uint32_t va =
          smem_u32(ring + (4 * slot + 2 + hf * NP) * OP_BYTES);
      // S = (Q_hi + Q_mid + Q_lo) K^T
      fence_regs(s);
      if constexpr (!(LEAVE_OUT & 4)) {
        wgmma_fence();
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int pn = 0; pn < NP; ++pn)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma64_ss(s,
                         desc_b128(qa + (term * NP + pn) * OP_BYTES + 32 * kk),
                         desc_b128(ka + pn * OP_BYTES + 32 * kk),
                         term > 0 || pn > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait0();
      }
      fence_regs(s);

      if constexpr (!(LEAVE_OUT & 8)) {
        // online softmax on the fragment: element 4 j + e is row (e < 2 ?
        // ra : rb8), key column c = 8 j + 2 (lane % 4) + (e & 1) of the
        // tile. On a tile that crosses a bound, column c of a row is valid
        // iff lo <= c < hi for the row's bounds (the source's end, causal,
        // window); a masked score is -inf, whose exp is 0.
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= sm;
        if (masked) {
          // bounds less this thread's first column 2 (lane % 4)
          const int c0 = 2 * (lane % 4), base = kb + k0;
          const int hia = min(hi - k0, qpa - base + 1) - c0;
          const int hib = min(hi - k0, qpb - base + 1) - c0;
          const int loa = (window > 0 ? qpa - window - base + 1 : 0) - c0;
          const int lob = (window > 0 ? qpb - window - base + 1 : 0) - c0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * j + (e & 1);
              const bool ok = e < 2 ? c >= loa && c < hia
                                    : c >= lob && c < hib;
              s[4 * j + e] = ok ? s[4 * j + e] : -INFINITY;
            }
        }
        float mxa = NEG_INF, mxb = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mxa = fmaxf(mxa, fmaxf(s[4 * j], s[4 * j + 1]));
          mxb = fmaxf(mxb, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
          mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
        }
        const float mna = fmaxf(ma, mxa), mnb = fmaxf(mb, mxb);
        float suma = 0.0f, sumb = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(s[4 * j + e] - (e < 2 ? mna : mnb));
            s[4 * j + e] = p;
            if (e < 2) suma += p; else sumb += p;
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          suma += __shfl_xor_sync(0xffffffffu, suma, off);
          sumb += __shfl_xor_sync(0xffffffffu, sumb, off);
        }
        const float ca = expf(ma - mna), cb = expf(mb - mnb);
        la = la * ca + suma;
        lb = lb * cb + sumb;
        ma = mna;
        mb = mnb;
#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
          o[4 * j] *= ca; o[4 * j + 1] *= ca;
          o[4 * j + 2] *= cb; o[4 * j + 3] *= cb;
        }
      }

      // P as the A operand: k16 step kk holds keys 16 kk .. + 15, i.e.
      // fragment columns j = 2 kk, 2 kk + 1 (mma's m16k16 A layout)
      uint32_t pa[3][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pa[0][kk][r],
                 pa[1][kk][r], pa[2][kk][r]);
      // O += (P_hi + P_mid + P_lo) V
      fence_regs(o);
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[term][kk]);
      if constexpr (!(LEAVE_OUT & 4)) {
        wgmma_fence();
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<NP>(o, pa[term][kk], desc_b128(va + 32 * kk));
        wgmma_commit();
        wgmma_wait0();
      }
      fence_regs(o);
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[term][kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // out = O / max(l, 1e-30): element 4 j + e is row (e < 2 ? ra : rb8),
  // feature 8 j + 2 (lane % 4) + (e & 1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb8 : ra;
    if (r >= R) continue;
    const float l = fmaxf(half ? lb : la, 1e-30f);
    const int i = (rb + r) / G, h = hk * G + (rb + r) % G;
    float* dst = out + (((size_t)b * C + i) * H + h) * Dh;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < Dh)
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(o[4 * j + 2 * half] / l, o[4 * j + 2 * half + 1] / l);
    }
  }
}

// A 1D tensor map (TMA descriptor) of ``n`` bytes at ``base``, read in
// boxes of ``box`` bytes (cuTensorMapEncodeTiled through the CUDA runtime,
// as ``mxgemm::tensor_map`` finds it for 2D maps).
cudaError_t tensor_map_1d(CUtensorMap* map, const void* base, uint64_t n,
                          uint32_t box) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static const Encode fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                   cudaEnableDefault, &found) == cudaSuccess
                   && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(f)
               : nullptr;
  }();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {n}, strides[1] = {0};
  const cuuint32_t boxd[1] = {box}, unit[1] = {1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, const_cast<void*>(base), dims,
      strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

}  // namespace

extern "C" int mx_flash_prefill_launch(
    const void* q, const void* k_chunk, const void* v_chunk, const void* kcp,
    const void* ksp, const void* vcp, const void* vsp, const void* tables,
    const void* q_start, const void* kv_len, void* out, void* kc, void* ks,
    void* vc, void* vs, int B, int C, int H, int Dh, int D, int P, int maxp,
    int fmt, int window, void* stream) {
  // shapes the tiling takes: a head fits one or two 128-byte bf16 operand
  // panels in k16 steps, at most 128 heads share a KV head, pages of a
  // multiple of 16 rows; TMA reads 16-byte aligned bytes, the loads 16-byte
  // aligned f32 inputs
  if (Dh <= 0 || Dh % 16 != 0 || Dh > 128 || D % Dh != 0 || D % 32 != 0 ||
      H % (D / Dh) != 0 || P <= 0 || P % 16 != 0 || maxp <= 0)
    return (int)cudaErrorInvalidValue;
  const int kvh = D / Dh, G = H / kvh, bits = fmt_bits(fmt);
  const int db = D * bits / 8, ns = D / 32, hb = Dh * bits / 8;
  if (G > 128) return (int)cudaErrorInvalidValue;
  const bool wide = Dh > 64;
  const int TS = wide ? Tiling<128>::TS : Tiling<64>::TS;
  const int ROWS = wide ? Tiling<128>::ROWS : Tiling<64>::ROWS;
  Geo geo;
  geo.per_head = hb % 16 == 0;
  geo.CB = geo.per_head ? hb : db;
  geo.BH = gcd(P, TK);
  geo.SR = geo.BH;                 // a chunk's scale box has 16 bytes more
  while (geo.SR * ns + 16 > 256 && geo.SR > 1) geo.SR /= 2;
  geo.SP = (geo.SR * ns + 16 + 127) / 128 * 128;
  geo.RB = 2 * TS * geo.CB + 2 * (TS / geo.SR) * geo.SP;
  if (geo.CB > 256 || geo.SR * ns % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto smem = [&](int rawst) {
    return SMEM_BYTES + (size_t)rawst * (geo.RB + sizeof(uint64_t));
  };
  geo.RAWST = 4;
  while (geo.RAWST > 2 && smem(geo.RAWST) > 227 * 1024) --geo.RAWST;
  if (smem(geo.RAWST) > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto at = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if ((at(kcp) | at(vcp) | at(kc) | at(vc) | at(ksp) | at(vsp) | at(ks) |
       at(vs) | at(q) | at(k_chunk) | at(v_chunk)) % 16 != 0 ||
      at(out) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long nblk = (long long)B * C * (D / 32);
  const unsigned qgrid = (unsigned)((nblk + 4 * QWARPS - 1) / (4 * QWARPS));
  kv_quant_kernel<<<qgrid, 32 * QWARPS, 0, s>>>(
      static_cast<const float*>(k_chunk), static_cast<uint8_t*>(kc),
      static_cast<uint8_t*>(ks), nblk, fmt);
  kv_quant_kernel<<<qgrid, 32 * QWARPS, 0, s>>>(
      static_cast<const float*>(v_chunk), static_cast<uint8_t*>(vc),
      static_cast<uint8_t*>(vs), nblk, fmt);
  // The pools' maps span the largest row count a map may have: the pool's
  // own size is not an argument, and every row read is one the block table
  // names.
  Maps maps;
  const uint64_t pool_rows = (1ull << 31) / ns, rows = (uint64_t)B * C;
  const void* pools[2][2] = {{kcp, vcp}, {ksp, vsp}};
  const void* chunk[2][2] = {{kc, vc}, {ks, vs}};
  cudaError_t e = cudaSuccess;
  for (int kv = 0; kv < 2 && e == cudaSuccess; ++kv) {
    CUtensorMap* cm = kv ? maps.vc : maps.kc;
    CUtensorMap* sm = kv ? maps.vs : maps.ks;
    e = mxgemm::tensor_map(&cm[0], CU_TENSOR_MAP_DATA_TYPE_UINT8,
                           pools[0][kv], db, pool_rows, db, geo.CB, geo.BH,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e == cudaSuccess)
      e = mxgemm::tensor_map(&cm[1], CU_TENSOR_MAP_DATA_TYPE_UINT8,
                             chunk[0][kv], db, rows, db, geo.CB, geo.BH,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e == cudaSuccess)
      e = tensor_map_1d(&sm[0], pools[1][kv], pool_rows * ns,
                        geo.SR * ns);
    if (e == cudaSuccess)
      e = tensor_map_1d(&sm[1], chunk[1][kv], rows * ns, geo.SR * ns + 16);
  }
  if (e != cudaSuccess) return (int)e;
  // a block's rows: whole positions where a position's G heads fit, else
  // ROWS consecutive (position, head) rows
  const int RPB = G <= ROWS ? ROWS / G * G : ROWS;
  const int nrt = (int)(((long long)C * G + RPB - 1) / RPB);
  auto kernel = wide ? (bits == 8 ? flash_prefill_kernel<8, 128>
                                  : flash_prefill_kernel<4, 128>)
                     : (bits == 8 ? flash_prefill_kernel<8, 64>
                                  : flash_prefill_kernel<4, 64>);
  const int nth = wide ? Tiling<128>::NTH : Tiling<64>::NTH;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem(geo.RAWST));
  if (e != cudaSuccess) return (int)e;
  kernel<<<nrt * B * kvh, nth, smem(geo.RAWST), s>>>(
      maps, geo, static_cast<const float*>(q),
      static_cast<const int*>(tables), static_cast<const int*>(q_start),
      static_cast<const int*>(kv_len), static_cast<float*>(out), B, C, H, Dh,
      D, P, maxp, fmt, window, RPB, nrt);
  return (int)cudaGetLastError();
}
