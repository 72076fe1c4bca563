// Paged flash-decode attention over a packed MX KV pool, for Hopper.
//
// Replaces the Pallas kernel ``mx_flash_decode_paged`` of the JAX package
// (src/repro/kernels/mx_attention.py:270, its ``pallas_call`` at :323).
//
// K/V pools (N, P, D*bits/8) u8 codes + (N, P, D/32) u8 E8M0 bytes; block
// tables (B, maxp) i32 — page ``tables[b, c]`` holds positions
// [c*P, (c+1)*P) of lane b. The kernel body, its bound on the card and its
// design are in mx_decode.cuh (shared with the contiguous layout).
#include "mx_decode.cuh"

// part: f32 scratch of B * H * nsplit * (Dh + 2); keys [s * chunk, (s + 1) *
// chunk) of each lane go to split s, with chunk % 64 == 0 and chunk * nsplit
// >= maxp * P.
extern "C" int mx_flash_decode_paged_launch(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* tables, const void* q_pos, const void* kv_len,
    void* part, void* out, int B, int H, int Dh, int D, int P, int maxp,
    int fmt, int window, int chunk, int nsplit, void* stream) {
  if (P <= 0 || maxp <= 0) return (int)cudaErrorInvalidValue;
  mxdecode::PagedRows rows{static_cast<const int*>(tables), P, maxp};
  return mxdecode::launch(q, kc, ks, vc, vs, rows, q_pos, kv_len, part, out,
                          B, H, Dh, D, fmt, window, chunk, nsplit, stream);
}
