// Flash-decode attention over a contiguous packed MX KV cache, for Hopper.
//
// Replaces the Pallas kernel ``mx_flash_decode`` of the JAX package
// (src/repro/kernels/mx_attention.py:180, its ``pallas_call`` at :211) —
// every decode step of the contiguous ``PackedKV`` cache under the fused
// backend (models/layers.py ``_attention_packed``).
//
// K/V codes (B, S, D*bits/8) u8 + scales (B, S, D/32) u8 E8M0: key position
// kp of lane b is row b*S + kp. The kernel body, its bound on the card and
// its design are in mx_decode.cuh (shared with the paged layout).
#include "mx_decode.cuh"

// part: f32 scratch of B * H * nsplit * (Dh + 2); keys [s * chunk, (s + 1) *
// chunk) of each lane go to split s, with chunk % 64 == 0 and chunk * nsplit
// >= S.
extern "C" int mx_flash_decode_launch(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* q_pos, const void* kv_len, void* part,
    void* out, int B, int H, int Dh, int D, int S, int fmt, int window,
    int chunk, int nsplit, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  mxdecode::ContiguousRows rows{S};
  return mxdecode::launch(q, kc, ks, vc, vs, rows, q_pos, kv_len, part, out,
                          B, H, Dh, D, fmt, window, chunk, nsplit, stream);
}
