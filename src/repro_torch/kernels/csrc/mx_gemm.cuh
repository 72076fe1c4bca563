// The fused MX GEMM of the port at M > 16, y = Q_mx(x [· blockdiag(H32)])
// @ deq(w), f32 out, templated over the layout of the weight operand:
//
//   * ``PackedE8M0Weights``: (K/2, N) u8 nibble codes (code 2i in the low
//     nibble of byte i along K) + (K/32, N) u8 E8M0 bytes — the artifact
//     layout (mx_gemm.cu); replaces the Pallas ``mx_matmul_packed``
//     (src/repro/kernels/mx_matmul.py:170) at every prefill linear;
//   * ``ByteF32Weights``: (K, N) u8, one code per byte, + (K/32, N) f32
//     scales — the unpacked layout (mx_matmul.cu); replaces the Pallas
//     ``mx_matmul`` (mx_matmul.py:96).
//
// What bounds it on an H100: bytes. At M = 4096 the f32 activations in and
// the f32 outputs out (15-80 MB) take 5-29 us at 3.35 TB/s; the products,
// 2 M N K operations, take 3-36 us even at the bf16 tensor rate. What the
// tile spends most on is the weight decode (PERF.md).
//
// Pass 1 (``act_quant_kernel``): a warp per (two rows, 128 columns), lane l
// on columns 4 l .. 4 l + 3 (16-byte loads, 8-byte stores), so a 32-block
// lies on 8 lanes: its amax by shuffles, the snap through mx_common.cuh's
// ``block_scale_exp`` / ``quant_code`` / ``decode_code`` steps (for 4-bit
// formats ``snap_index``'s midpoint count over a per-block table), the T3
// rotation through mx_common.cuh's ``rotate_h32`` (the f64 Walsh-Hadamard
// butterfly every kernel's T3 runs). It writes the dequantized activations
// as bf16, row-major (M, K): exact, since every MX grid value has at most 4
// significant bits (int8: 7) and the block scale is a power of two. Each
// activation block is encoded once, not once per column tile. The small-M
// GEMV's prepass (mx_gemm.cu) is the same kernel with f32 output.
//
// Pass 2 (``gemm_kernel``): a block owns BM x 128 outputs of Y (BM = 256,
// or 128 where 256-row tiles would leave more than half the SMs idle, and
// for the unpacked layout) and walks K in stages of 64 (two MX blocks).
// Warp 8 is the producer: for each stage one lane starts TMA copies of the
// bf16 activation box (BM rows x 128 bytes, 128-byte swizzle) and of the
// stage's raw weight bytes and scales into a ring of ST = 4 shared-memory
// stages, each ordered by a ``full`` (transaction bytes) and an ``empty``
// mbarrier. Warps 0-7 are two consumer warpgroups of BM / 2 rows: they
// issue ``wgmma.mma_async`` m64n128k16 (bf16 in, f32 accumulators in
// registers) on stage s and, while the tensor cores run, decode stage
// s + 1's weight bytes once into the bf16 operand wgmma reads (B as N rows
// of 64 K values, K-major, 128-byte swizzle; double-buffered): for the
// packed layout a 256-entry table maps a byte to the bf16 pair of its two
// codes (a copy per bank) and one bf16 multiply applies the column's E8M0
// scale; the byte codes look up a 256-entry f32 table. Stage s's products
// stay in flight while stage s + 1 is decoded into the buffer stage s - 1
// read: each warpgroup retires its stage s - 1 wgmmas and the two meet at
// a barrier before that decode starts, and again before stage s + 1's
// wgmmas.
// No dense weight exists outside shared memory; each decoded weight tile
// serves BM rows of Y. Y goes out through shared memory (the ring, once
// consumed) in 16-byte stores of whole rows, masked at the ragged M and N
// edges.
//
// Where the scale goes: E8M0 scales are powers of two, so the packed loader
// folds them into the bf16 weight (exact). The unpacked layout's f32 scales
// need not be powers of two (the JAX package builds them with an f32
// ``exp2`` that is an ulp off outside 2^+-12), and code x scale is then not
// exact in bf16. So that loader decodes bare codes (exact in bf16); each
// MX block's two k16 wgmmas go into a fresh accumulator fragment, which is
// scaled per column in registers (the fragment layout gives each thread its
// 32 columns) and added to the running f32 sum.
//
// Why bf16 and not fp8: the bf16 operands are exact for all five formats.
// fp8 e4m3 cannot hold mxint8's codes (7 significant bits), and an fp8 k32
// product would need a per-block rescale of both operands' partial sums on
// the CUDA cores, which costs about as much as the tensor-core work saved.
//
// Expert-stacked calls (the MoE family's ``qeinsum``): E independent GEMMs
// of the same (M, K, N), each operand contiguous so expert e sits at a fixed
// stride, run as one launch of each pass. The activation pass takes the E·M
// rows at once (it works row by row); the tile takes e as grid z: its TMA
// maps view A as (E·M, K) and the weights as (E·K/2, N) and (E·K/32, N),
// and a block adds e's row offset to its coordinates. A box near an expert's
// last row or K stage reads rows of the next expert; those land in output
// rows masked by the expert's own M, or in K values the decode and the
// wgmmas of the stage skip.
//
// Numerics: fixed K order, no float atomics, so repeated calls are bitwise
// equal; the products differ from the f32 plain versions only in summation
// order (within each k16 step the tensor core's, then stage by stage).
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <atomic>

#include "mx_common.cuh"

namespace mxgemm {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 4-bit format's tables, built by each block from mx_common.cuh's own
// expressions: ``code[c]`` = decode_code(fmt, c) of each nibble, ``gv[k]``
// = grid_value(fmt, k) of the 8 grid magnitudes and ``mid[k]`` = (gv[k] +
// gv[k + 1]) * 0.5f, the midpoints ``snap_index`` compares |z| with. Also
// the small-M GEMV's (mx_gemm.cu).
struct Tables {
  float code[16];
  float gv[8];
  float mid[8];
};

// Threads 0 .. 23 of a block fill ``t`` (then a barrier).
__device__ __forceinline__ void build_tables(Tables& t, int fmt, int tid) {
  if (tid < 16) {
    t.code[tid] = decode_code(fmt, tid);
  } else if (tid < 24) {
    const int k = tid - 16;
    t.gv[k] = grid_value(fmt, k);
    t.mid[k] = k < 7 ? (grid_value(fmt, k) + grid_value(fmt, k + 1)) * 0.5f
                     : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// Pass 1: x (M, K) f32 -> xq (M, K) bf16 (or f32) = Q_mx(x [· blockdiag(H32)])
// ---------------------------------------------------------------------------

constexpr int QW = 8;          // warps per block of the activation pass
constexpr int QR = 2;          // rows of a unit (their loads in flight at once)
constexpr int QBLOCKS = 1056;  // at most 8 blocks on each of 132 SMs

// Q_mx of R rows of a 32-block held E elements a lane by 32 / E lanes
// (``rotate_h32``'s layout), encoded and decoded in place:
// ``mx_encode_quad``'s steps (mx_common.cuh) — the max magnitude across
// the lanes, ``block_scale_exp``, ``quant_code``'s quotient and snap,
// ``decode_code`` times the scale. For a 4-bit format (``four``) the snap is
// ``snap_index``'s count of the midpoints at or below |z|, a 3-step search
// over the 7 midpoints of ``t``; otherwise ``quant_code`` itself. The
// activation pass below (E = 4) and the small-M GEMV's in-kernel encode
// (mx_gemm.cu, E = 1) share it.
template <bool kFp6, int R, int E>
__device__ __forceinline__ void encode_lanes(const Tables& t, int fmt,
                                             bool four, float (&v)[R][E]) {
  float amax[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    amax[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < E; ++i) amax[r] = fmaxf(amax[r], fabsf(v[r][i]));
  }
#pragma unroll
  for (int o = 1; o < 32 / E; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(FULL, amax[r], o));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float scale = ldexpf(1.0f, block_scale_exp(fmt, amax[r]));
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (!kFp6 || four) {
        const float z = __fdiv_rn(v[r][i], scale), mag = fabsf(z);
        int idx = 0;
#pragma unroll
        for (int step = 4; step > 0; step >>= 1)
          if (t.mid[idx + step - 1] <= mag) idx += step;
        v[r][i] = (z < 0.0f && idx > 0 ? -t.gv[idx] : t.gv[idx]) * scale;
      } else {
        v[r][i] = decode_code<kFp6>(fmt, quant_code<kFp6>(fmt, v[r][i],
                                                          scale)) * scale;
      }
    }
  }
}

// Four encoded values to xq: 16 bytes of f32 or 8 of bf16.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// x (M, K) f32 -> xq (M, K) = Q_mx(x [· blockdiag(H32)]) as T: bf16 for the
// tile, f32 for the small-M GEMV (mx_gemm.cu). Warp w of the grid takes
// units w, w + (warps of the grid), ...; unit u is rows QR (u / nch) .. + QR
// - 1 of the 128 columns 128 (u % nch) ..: lane l loads (16 bytes) and
// stores columns 4 l .. 4 l + 3, so a 32-block lies on 8 lanes. The next
// unit's loads are in flight during the encode.
template <bool kFp6, class T>
__global__ void __launch_bounds__(32 * QW)
act_quant_kernel(const float* __restrict__ x, T* __restrict__ xq, int M,
                 int K, int fmt, int t3) {
  __shared__ Tables tab;
  const int lane = threadIdx.x % 32;
  build_tables(tab, fmt, threadIdx.x);
  __syncthreads();
  const bool four = fmt_bits<kFp6>(fmt) == 4;
  const int nch = (K + 127) / 128, units = (M + QR - 1) / QR * nch;
  const int step = gridDim.x * QW;
  auto load = [&](int u, float (&v)[QR][4]) {
    const int m = u / nch * QR, k = u % nch * 128 + 4 * lane;
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (u < units && m + r < M && k < K)
        f = *reinterpret_cast<const float4*>(x + (size_t)(m + r) * K + k);
      v[r][0] = f.x; v[r][1] = f.y; v[r][2] = f.z; v[r][3] = f.w;
    }
  };
  float next[QR][4];
  load(blockIdx.x * QW + threadIdx.x / 32, next);
  for (int u = blockIdx.x * QW + threadIdx.x / 32; u < units; u += step) {
    const int m = u / nch * QR, k = u % nch * 128 + 4 * lane;  // warp-uniform u
    float v[QR][4];
#pragma unroll
    for (int r = 0; r < QR; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[r][i] = next[r][i];
    load(u + step, next);
    if (t3) {
#pragma unroll
      for (int r = 0; r < QR; ++r) rotate_h32<4>(v[r], lane);
    }
    encode_lanes<kFp6, QR, 4>(tab, fmt, four, v);
#pragma unroll
    for (int r = 0; r < QR; ++r)
      if (m + r < M && k < K) store4(xq + (size_t)(m + r) * K + k, v[r]);
  }
}

// The activation pass on ``s``: x (M, K) f32, 16-byte aligned, K % 32 == 0.
template <bool kFp6, class T>
cudaError_t launch_act(cudaStream_t s, const float* x, T* xq, int M, int K,
                       int fmt, int t3) {
  const int units = (M + QR - 1) / QR * ((K + 127) / 128);
  const int qb = min(QBLOCKS, (units + QW - 1) / QW);
  act_quant_kernel<kFp6, T><<<qb, 32 * QW, 0, s>>>(x, xq, M, K, fmt, t3);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Pass 2: the wgmma tile
// ---------------------------------------------------------------------------

constexpr int BN = 128, BK = 64;            // BK: two MX blocks, 128 bytes
constexpr int ST = 4;                       // stages of the ring
constexpr int NCW = 8;                      // consumer warps (2 warpgroups)
constexpr int NT = 32 * (NCW + 1);          // + the producer warp
constexpr int B_BYTES = BN * BK * 2;        // a decoded bf16 weight tile
constexpr int OUT_LD = BN + 8;              // floats per staged output row

// For timing the tile's parts (scripts/gemm_passes.py): built with
// -DMXGEMM_LEAVE_OUT=bits, the tile leaves out its copies (1), its weight
// decode (2) or the packed layout's wgmmas (4), and its output is wrong.
#ifndef MXGEMM_LEAVE_OUT
#define MXGEMM_LEAVE_OUT 0
#endif
constexpr int LEAVE_OUT = MXGEMM_LEAVE_OUT;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(smem_u32(bar))
      : "memory");
}

// Arrives on ``bar`` and adds ``bytes`` to the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes)
      : "memory");
}

// TMA: the box of ``map`` at (column c0, row c1) into shared ``dst``; its
// bytes complete on ``bar``. Boxes past the matrix's edge read zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Waits until the phase of ``bar`` with parity ``parity`` has completed.
// (No timeout: a trap would end the process's CUDA context, every later
// call included, and a correct kernel starved by other work on the card
// could trip one.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The generic-proxy writes (and reads acquired) by this thread are ordered
// before the async proxy's (wgmma's) accesses that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma operand descriptor of a K-major tile with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), 1024-byte-aligned
// groups; the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of 16-byte chunk ``ch`` (0..7) of row ``row`` in such a tile.
__device__ __forceinline__ int swz(int row, int ch) {
  return row * 128 + ((ch ^ (row & 7)) << 4);
}

// d (64 x 128 f32, wgmma's fragment layout) (+)= A (64 x 16) B (16 x 128).
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of ``d`` across the asynchronous
// wgmma (it does not see that the tensor cores write ``d`` after issue).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 16 bytes of byte row ``row`` at byte column ``col`` of a matrix with
// ``ld`` bytes per row, byte by byte (bytes past ``width`` read ``fill``),
// stored to shared ``dst`` (16-byte aligned).
__device__ __forceinline__ void copy_line(uint8_t* dst, const uint8_t* p,
                                          size_t row, size_t ld, int col,
                                          int width, uint32_t fill) {
  uint32_t w[4];
  for (int k = 0; k < 4; ++k) {
    uint32_t v = 0;
    for (int c = 0; c < 4; ++c) {
      const int b = col + 4 * k + c;
      v |= (b < width ? (uint32_t)p[row * ld + b] : (fill >> (8 * c)) & 0xFFu)
           << (8 * c);
    }
    w[k] = v;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A 2D tensor map (TMA descriptor) of a row-major matrix: ``cols`` x
// ``rows`` elements of ``type``, ``row_bytes`` apart, read in boxes of
// ``box_cols`` x ``box_rows``. cuTensorMapEncodeTiled is looked up through
// the CUDA runtime once per process, so the library links against nothing
// more.
inline cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                              const void* base, uint64_t cols, uint64_t rows,
                              uint64_t row_bytes, uint32_t box_cols,
                              uint32_t box_rows, CUtensorMapSwizzle swizzle) {
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
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  const CUresult r = fn(
      map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The weight loaders. A stage's raw weight bytes (raw: [RAW_ROWS][BN]
// bytes in the 128-byte swizzle, ``swz``) and scales (sc: [2][BN]) come by
// TMA (``maps`` builds the two tensor maps) where N % 16 == 0 and the
// operands are 16-byte aligned, else the producer warp stores them byte by
// byte (``stage``, ``nb`` MX blocks). ``decode`` (thread ``t`` of the 256
// consumers: K values 8 c .. 8 c + 7, c = t % 8, of columns 4 q .. 4 q + 3,
// q = t / 8) writes the bf16 operand tile Bd.
struct PackedE8M0Weights {
  const uint8_t* wp;   // (K/2, N)
  const uint8_t* ws;   // (K/32, N) E8M0
  static constexpr bool kScaleAfter = false;
  static constexpr bool kFp6 = false;
  static constexpr int RAW_ROWS = BK / 2;        // byte rows of a stage
  static constexpr int RAW_BYTES = RAW_ROWS * BN;
  static constexpr int SC_BYTES = 2 * BN;
  // byte -> bf16x2 of its two codes' values (low nibble first), one copy
  // per bank (entry e of bank l at e * 32 + l): conflict-free lookups
  static constexpr int TAB = 256 * 32;

  // the E experts' weights as one (E·K/2, N) and one (E·K/32, N) matrix
  cudaError_t maps(CUtensorMap* tw, CUtensorMap* ts, int N, int K,
                   int E) const {
    cudaError_t e = tensor_map(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, N,
                               (uint64_t)E * (K / 2), N, BN, RAW_ROWS,
                               CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
    return tensor_map(ts, CU_TENSOR_MAP_DATA_TYPE_UINT8, ws, N,
                      (uint64_t)E * (K / 32), N, BN, 2,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  }

  // expert e's weights (its byte rows start at row e·K/2 of the maps)
  __device__ PackedE8M0Weights expert(int e, int N, int K) const {
    return {wp + (size_t)e * (K / 2) * N, ws + (size_t)e * (K / 32) * N};
  }

  // Every thread of the block; ``t16`` is 16 floats of free shared memory.
  __device__ void build_table(float* tab, float* t16, int fmt, int tid) const {
    if (tid < 16) t16[tid] = decode_code(fmt, tid);
    __syncthreads();
    uint32_t* t = reinterpret_cast<uint32_t*>(tab);
    for (int i = tid; i < TAB; i += NT)
      t[i] = pack_bf16x2(t16[(i >> 5) & 15], t16[i >> 9]);
  }

  __device__ void stage(uint8_t* raw, uint8_t* sc, int s, int nb, int n0,
                        int N, int lane, int fmt) const {
    const int center = fmt_center(fmt);
    const uint32_t zw = (uint32_t)(center | (center << 4)) * 0x01010101u;
    for (int i = lane; i < nb * 16 * 8; i += 32) {
      const int j = i >> 3, g = i & 7;
      copy_line(raw + swz(j, g), wp, (size_t)s * RAW_ROWS + j, (size_t)N,
                n0 + 16 * g, N, zw);
    }
    for (int i = lane; i < nb * 8; i += 32) {
      const int j = i >> 3, g = i & 7;
      copy_line(sc + j * BN + 16 * g, ws, (size_t)2 * s + j, (size_t)N,
                n0 + 16 * g, N, 0x7F7F7F7Fu);
    }
  }

  __device__ __forceinline__ void decode(uint8_t* Bd, const uint8_t* raw,
                                         const uint8_t* sc, const float* tab,
                                         int nb, int t) const {
    const int c = t % 8, q = t / 8, lane = t % 32;
    if (c >= 4 * nb) return;                  // past K in the last stage
    uint32_t wd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)               // byte row 4 c + j: K 8c + 2j
      wd[j] = *reinterpret_cast<const uint32_t*>(raw + swz(4 * c + j, q >> 2) +
                                                 4 * (q & 3));
    const uint32_t sw =
        *reinterpret_cast<const uint32_t*>(sc + (c >> 2) * BN + 4 * q);
    const __nv_bfloat162* tl = reinterpret_cast<const __nv_bfloat162*>(tab)
                               + lane;
    uint32_t o[4][4];                         // every load before any store
#pragma unroll
    for (int i = 0; i < 4; ++i) {             // column 4 q + i
      // its E8M0 scale 2^(b - 127) as bf16 (exponent field b; 2^-127 is the
      // subnormal 0x0040), times each byte's two code values: exact
      const uint32_t b = (sw >> (8 * i)) & 0xFFu;
      const __nv_bfloat16 s1 =
          __ushort_as_bfloat16((unsigned short)(b ? b << 7 : 0x40u));
      const __nv_bfloat162 s = __halves2bfloat162(s1, s1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 v = __hmul2(tl[((wd[j] >> (8 * i)) & 0xFFu) * 32],
                                         s);
        o[i][j] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(Bd + swz(4 * q + i, c)) =
          make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
  }
};

struct ByteF32Weights {
  const uint8_t* wc;   // (K, N), one code per byte
  const float* ws;     // (K/32, N)
  static constexpr bool kScaleAfter = true;
  static constexpr bool kFp6 = true;
  static constexpr int RAW_ROWS = BK;
  static constexpr int RAW_BYTES = RAW_ROWS * BN;
  static constexpr int SC_BYTES = 2 * BN * 4;
  static constexpr int TAB = 256;      // every byte code's value

  cudaError_t maps(CUtensorMap* tw, CUtensorMap* ts, int N, int K,
                   int E) const {
    cudaError_t e = tensor_map(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wc, N,
                               (uint64_t)E * K, N, BN, RAW_ROWS,
                               CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
    return tensor_map(ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, N,
                      (uint64_t)E * (K / 32), 4ull * N, BN, 2,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  }

  __device__ ByteF32Weights expert(int e, int N, int K) const {
    return {wc + (size_t)e * K * N, ws + (size_t)e * (K / 32) * N};
  }

  __device__ void build_table(float* tab, float*, int fmt, int tid) const {
    for (int i = tid; i < TAB; i += NT) tab[i] = decode_code<kFp6>(fmt, i);
  }

  __device__ void stage(uint8_t* raw, uint8_t* sc, int s, int nb, int n0,
                        int N, int lane, int fmt) const {
    const uint32_t zw = (uint32_t)fmt_center<kFp6>(fmt) * 0x01010101u;
    for (int i = lane; i < nb * 32 * 8; i += 32) {
      const int j = i >> 3, g = i & 7;
      copy_line(raw + swz(j, g), wc, (size_t)s * RAW_ROWS + j, (size_t)N,
                n0 + 16 * g, N, zw);
    }
    // f32 scales: 16-byte lines of 4 columns (columns past N scale by 0)
    const uint8_t* ws8 = reinterpret_cast<const uint8_t*>(ws);
    for (int i = lane; i < nb * 32; i += 32) {
      const int j = i >> 5, g = i & 31;
      copy_line(sc + j * BN * 4 + 16 * g, ws8, (size_t)2 * s + j,
                (size_t)N * 4, 4 * (n0 + 4 * g), 4 * N, 0u);
    }
  }

  __device__ __forceinline__ void decode(uint8_t* Bd, const uint8_t* raw,
                                         const uint8_t*, const float* tab,
                                         int nb, int t) const {
    const int c = t % 8, q = t / 8;
    if (c >= 4 * nb) return;
    uint32_t wd[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)               // byte row 8 c + j: K 8 c + j
      wd[j] = *reinterpret_cast<const uint32_t*>(raw + swz(8 * c + j, q >> 2) +
                                                 4 * (q & 3));
    uint32_t o[4][4];                         // every load before any store
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[i][j] = pack_bf16x2(tab[(wd[2 * j] >> (8 * i)) & 0xFFu],
                              tab[(wd[2 * j + 1] >> (8 * i)) & 0xFFu]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(Bd + swz(4 * q + i, c)) =
          make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
  }
};

template <class W, int BM>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)ST * BM * BK * 2 + 2 * B_BYTES +
         (size_t)ST * (W::RAW_BYTES + W::SC_BYTES) + W::TAB * 4 +
         2 * ST * sizeof(uint64_t);
}

// Y (M, N) f32 = A (M, K) bf16 @ W, tile (blockIdx.y, blockIdx.x) of BM
// (128 or 256) rows x BN columns of expert blockIdx.z (A, W and Y at that
// expert's offset); ``tma`` maps A (BM x 64 boxes, 128-byte swizzle) and,
// with ``kTma``, the weight bytes and scales (W::maps); without it the
// producer warp stores those.
template <class W, int BM, bool kTma>
__global__ void __launch_bounds__(NT, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tma,
            const __grid_constant__ CUtensorMap tmw,
            const __grid_constant__ CUtensorMap tms, W w_all,
            float* __restrict__ Y_all, int M, int N, int K, int fmt) {
  constexpr int MT = BM / 128;               // m64 sub-tiles per warpgroup
  constexpr int A_BYTES = BM * BK * 2;       // a stage's bf16 activations
  static_assert(!W::kScaleAfter || MT == 1, "one fragment per scaled sum");
  static_assert(BM * OUT_LD * 4 <= ST * A_BYTES + 2 * B_BYTES,
                "the output staging overlays the activation ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* As = base;                                  // [ST][A_BYTES]
  uint8_t* Bd = As + ST * A_BYTES;                     // [2][B_BYTES]
  uint8_t* raw = Bd + 2 * B_BYTES;                     // [ST][RAW_BYTES]
  uint8_t* sc = raw + ST * W::RAW_BYTES;               // [ST][SC_BYTES]
  float* tab = reinterpret_cast<float*>(sc + ST * W::SC_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + W::TAB);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, ex = blockIdx.z;
  const int nkb = K / 32, ns = (nkb + 1) / 2;
  const W w = w_all.expert(ex, N, K);
  float* __restrict__ Y = Y_all + (size_t)ex * M * N;
  // the expert's first rows in the maps: A's row of m0, its weights' first
  // byte row (RAW_ROWS per 64 K values) and its first scale row
  const int arow = ex * M + m0;
  const int wrow = ex * (K / 32) * (W::RAW_ROWS / 2), srow = ex * (K / 32);
  w.build_table(tab, reinterpret_cast<float*>(Bd), fmt, tid);
  if (tid == 0) {
    for (int r = 0; r < ST; ++r) {
      mbar_init(&full[r], kTma ? 1 : 33);    // + the producer's lanes
      mbar_init(&empty[r], NCW);             // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {
    // producer: stage by stage, once its ring slot is free, the activation
    // box (rows past M and columns past K read zeros) and the weights
    if (kTma && lane != 0) return;
    constexpr uint32_t tx = A_BYTES + (kTma ? W::RAW_BYTES + W::SC_BYTES : 0);
    for (int s = 0; s < ns; ++s) {
      const int r = s % ST;
      if (s >= ST) mbar_wait(&empty[r], ((s / ST) - 1) & 1);
      if (lane == 0 && (LEAVE_OUT & 1)) {
        mbar_arrive(&full[r]);
      } else if (lane == 0) {
        mbar_expect_tx(&full[r], tx);
        tma_load_2d(As + r * A_BYTES, &tma, &full[r], s * BK, arow);
        if constexpr (kTma) {
          tma_load_2d(raw + r * W::RAW_BYTES, &tmw, &full[r], n0,
                      wrow + s * W::RAW_ROWS);
          tma_load_2d(sc + r * W::SC_BYTES, &tms, &full[r], n0,
                      srow + 2 * s);
        }
      }
      if constexpr (!kTma) {
        if constexpr (!(LEAVE_OUT & 1))
          w.stage(raw + r * W::RAW_BYTES, sc + r * W::SC_BYTES, s,
                  min(2, nkb - 2 * s), n0, N, lane, fmt);
        mbar_arrive(&full[r]);                 // release: the stores above
      }
    }
    return;
  }

  // consumers: warpgroup g computes rows BM / 2 g .. BM / 2 (g + 1) - 1 of
  // the tile, as MT fragments of 64 rows
  const int g = warp / 4;
  float acc[MT][64];
  float racc[W::kScaleAfter ? 64 : 1];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (W::kScaleAfter ? 64 : 1); ++i) racc[i] = 0.0f;
  // wait for stage s's copies and decode its weights into Bd[s & 1]
  auto decode_stage = [&](int s) {
    const int r = s % ST;
    mbar_wait(&full[r], (s / ST) & 1);
    if constexpr (!(LEAVE_OUT & 2))
      w.decode(Bd + (s & 1) * B_BYTES, raw + r * W::RAW_BYTES,
               sc + r * W::SC_BYTES, tab, min(2, nkb - 2 * s), tid);
  };
  decode_stage(0);
  fence_proxy_async();
  bar_sync(1, 32 * NCW);

  for (int s = 0; s < ns; ++s) {
    const int r = s % ST, nb = min(2, nkb - 2 * s);
    const uint32_t a0 = smem_u32(As + r * A_BYTES + g * (BM / 2) * 128);
    const uint32_t b0 = smem_u32(Bd + (s & 1) * B_BYTES);
    if constexpr (!W::kScaleAfter) {
      // stage s's products stay in flight while stage s + 1 is decoded:
      // wait only for stage s - 1's, whose operands the decode of s + 1
      // and the producer overwrite
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= 2 * nb) break;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if constexpr (!(LEAVE_OUT & 4))
            wgmma128(acc[mt], desc_b128(a0 + mt * 64 * 128 + 32 * kk),
                     desc_b128(b0 + 32 * kk), 1);
      }
      wgmma_commit();
      // Bd[(s + 1) & 1] is stage s - 1's B operand: both warpgroups retire
      // their stage s - 1 wgmmas and meet before a thread writes it
      wgmma_wait1();
      if (s + 1 < ns) {
        if (s > 0) bar_sync(1, 32 * NCW);
        decode_stage(s + 1);                 // while the tensor cores run
      }
    } else {
      const float* scl = reinterpret_cast<const float*>(sc + r * W::SC_BYTES);
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        if (blk < nb) {
          // this MX block's product into a fresh fragment
          fence_acc(acc[0]);
          wgmma_fence();
          wgmma128(acc[0], desc_b128(a0 + 64 * blk), desc_b128(b0 + 64 * blk),
                   0);
          wgmma128(acc[0], desc_b128(a0 + 64 * blk + 32),
                   desc_b128(b0 + 64 * blk + 32), 1);
          wgmma_commit();
        }
        if (blk == 0 && s + 1 < ns) decode_stage(s + 1);
        if (blk < nb) {
          wgmma_wait0();
          fence_acc(acc[0]);
          // scaled per column (fragment element 4 j + e: column 8 j + 2
          // (lane % 4) + e % 2) and added to the running sum
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 sv = *reinterpret_cast<const float2*>(
                scl + blk * BN + 8 * j + 2 * (lane % 4));
            racc[4 * j] = fmaf(acc[0][4 * j], sv.x, racc[4 * j]);
            racc[4 * j + 1] = fmaf(acc[0][4 * j + 1], sv.y, racc[4 * j + 1]);
            racc[4 * j + 2] = fmaf(acc[0][4 * j + 2], sv.x, racc[4 * j + 2]);
            racc[4 * j + 3] = fmaf(acc[0][4 * j + 3], sv.y, racc[4 * j + 3]);
          }
        }
      }
    }
    // Bd[(s + 1) & 1] for wgmma; the generic reads of the slot released
    // below before the producer's next TMA writes into it
    fence_proxy_async();
    if constexpr (!W::kScaleAfter) {
      if (lane == 0 && s > 0) mbar_arrive(&empty[(s - 1) % ST]);
    } else {
      if (lane == 0) mbar_arrive(&empty[r]);
    }
    bar_sync(1, 32 * NCW);
  }
  if constexpr (!W::kScaleAfter) {
    wgmma_wait0();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    bar_sync(1, 32 * NCW);     // both warpgroups' last products are done
  }

  // epilogue: the fragment through shared memory (the ring is free: every
  // stage was consumed), then 16-byte stores of whole rows
  float* out = reinterpret_cast<float*>(base) + g * (BM / 2) * OUT_LD;
  auto stage_out = [&](const float (&res)[64], int mt) {
    const int wr = mt * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(out + wr * OUT_LD + col) =
          make_float2(res[4 * j], res[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (wr + 8) * OUT_LD + col) =
          make_float2(res[4 * j + 2], res[4 * j + 3]);
    }
  };
  if constexpr (W::kScaleAfter) {
    stage_out(racc, 0);
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) stage_out(acc[mt], mt);
  }
  bar_sync(2 + g, 128);
  const int n = n0 + 4 * lane;
  for (int rr = warp % 4; rr < BM / 2; rr += 4) {
    const int m = m0 + g * (BM / 2) + rr;
    if (m >= M) break;
    const float4 v = *reinterpret_cast<const float4*>(out + rr * OUT_LD +
                                                      4 * lane);
    float* dst = Y + (size_t)m * N + n;
    if (N % 4 == 0 && n + 3 < N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4 && n + i < N; ++i) dst[i] = e[i];
    }
  }
}

template <class W, int BM, bool kTma>
cudaError_t launch_rows(cudaStream_t s, const __nv_bfloat16* A, W w, float* Y,
                        int E, int M, int N, int K, int fmt) {
  CUtensorMap tma, tmw = {}, tms = {};
  cudaError_t e = tensor_map(&tma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A, K,
                             (uint64_t)E * M, 2ull * K, BK, BM,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess && kTma) e = w.maps(&tmw, &tms, N, K, E);
  const size_t shm = smem_bytes<W, BM>();
  // Raised on every call: a "done" flag here would be a function-local
  // static of a template, which the dynamic linker merges across every
  // loaded library that instantiates this kernel (two builds of it in one
  // process would share one flag, and the second would launch without it).
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_kernel<W, BM, kTma>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shm);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  gemm_kernel<W, BM, kTma><<<grid, NT, shm, s>>>(tma, tmw, tms, w, Y, M, N, K,
                                                 fmt);
  return cudaGetLastError();
}

// The tile's height: 256 rows decode each weight tile for twice as many
// outputs as 128 (the decode is the tile's largest cost), unless M fits in
// 128 rows (a taller tile would only add idle rows: an expert's 32 rows at
// decode) or 256-row tiles leave fewer blocks than half the SMs, as at
// (896, 128). The unpacked layout's scaled sums need the registers of a
// second fragment: 128.
template <class W, bool kTma>
cudaError_t launch_tile(cudaStream_t s, const __nv_bfloat16* A, W w, float* Y,
                        int E, int M, int N, int K, int fmt) {
  if constexpr (!W::kScaleAfter) {
    // the SM count, asked once per device (ordinals below 64; the same
    // whichever library asks)
    static std::atomic<int> sms_of[64];
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && dev < 64) sms = sms_of[dev].load();
    if (e == cudaSuccess && sms == 0) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess && dev < 64) sms_of[dev].store(sms);
    }
    if (e != cudaSuccess) return e;
    if (M > 128 && 2 * ((M + 255) / 256) * ((N + BN - 1) / BN) * E >= sms)
      return launch_rows<W, 256, kTma>(s, A, w, Y, E, M, N, K, fmt);
  }
  return launch_rows<W, 128, kTma>(s, A, w, Y, E, M, N, K, fmt);
}

// Both passes on ``stream``, over E experts of M rows each (x (E, M, K), W
// E stacked (K, N) weights, y (E, M, N), all contiguous). ``vec``: N % 16
// == 0 and 16-byte aligned weight operands (their bytes then come by TMA).
// ``xq`` holds E·M x K bf16, 16-byte aligned. Returns the first launch
// error.
template <class W>
int launch(const void* x, void* xq, W w, bool vec, void* y, int E, int M,
           int N, int K, int fmt, int t3, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* a = static_cast<__nv_bfloat16*>(xq);
  cudaError_t e = launch_act<W::kFp6>(s, static_cast<const float*>(x), a,
                                      E * M, K, fmt, t3);
  if (e != cudaSuccess) return (int)e;
  float* yf = static_cast<float*>(y);
  e = vec ? launch_tile<W, true>(s, a, w, yf, E, M, N, K, fmt)
          : launch_tile<W, false>(s, a, w, yf, E, M, N, K, fmt);
  return (int)e;
}

}  // namespace mxgemm
