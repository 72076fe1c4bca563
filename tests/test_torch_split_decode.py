"""The split-key flash-decode of the port (``csrc/mx_decode.cuh``), modelled
in plain PyTorch on the CPU.

The CUDA kernel splits each lane's keys over blocks at the boundaries of
``ops.decode_splits``, runs the online softmax over 64-key tiles inside each
split, and merges the per-split (m, l, acc) in split order. The model below
repeats that arithmetic — the same boundaries, the NEG_INF running max and
-inf masked scores, the same merge — and is held against the plain versions
of both layouts (``ref.mx_attention_ref``, ``ref.mx_attention_paged_ref``)
within 1e-6, in all four KV formats. The kernel itself is held against the
same plain versions on the card (``test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import packing as tpk
from repro_torch.kernels import ref as tref

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

SMS = 132                      # streaming multiprocessors of an H100 SXM
NEG_INF = -1e30
TILE = tops.DECODE_TILE


def _split_merge(q, k, v, q_pos, kv_len, window, limit):
    """q (B, H, Dh); k, v (B, L, D) each lane's decoded keys in position
    order (L >= limit). Returns (B, H, Dh) f32 as the two kernel passes
    compute it."""
    B, H, Dh = q.shape
    D = k.shape[-1]
    kvh = D // Dh
    G = H // kvh
    nsplit, chunk = tops.decode_splits(limit, B, kvh, SMS)
    sm = tref.sm_scale(Dh)
    out = torch.empty(B, H, Dh)
    for b in range(B):
        qp, kl = int(q_pos[b]), int(kv_len[b])
        kend = min(kl, qp + 1, limit)
        kbeg = max(0, qp - window + 1) if window > 0 else 0
        qg = q[b].reshape(kvh, G, Dh)
        kh = k[b].reshape(-1, kvh, Dh)
        vh = v[b].reshape(-1, kvh, Dh)
        parts = []
        for s in range(nsplit):                 # pass 1, one block per split
            lo, hi = max(kbeg, s * chunk), min(kend, (s + 1) * chunk)
            m = torch.full((kvh, G), NEG_INF)
            l = torch.zeros(kvh, G)
            acc = torch.zeros(kvh, G, Dh)
            for k0 in range(lo, hi, TILE):
                t = torch.arange(k0, k0 + TILE)
                ok = t < hi
                t = t.clamp(max=kh.shape[0] - 1)
                sc = torch.einsum("kgd,tkd->kgt", qg, kh[t]) * sm
                sc = torch.where(ok, sc, torch.full_like(sc, -torch.inf))
                m_new = torch.maximum(m, sc.amax(-1).clamp(min=NEG_INF))
                p = torch.where(ok, torch.exp(sc - m_new[..., None]),
                                torch.zeros_like(sc))
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                vt = torch.where(ok[:, None, None], vh[t],
                                 torch.zeros_like(vh[t]))
                acc = acc * corr[..., None] + torch.einsum("kgt,tkd->kgd",
                                                           p, vt)
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([p[0] for p in parts]).amax(0)    # pass 2, in order
        L = torch.zeros(kvh, G)
        o = torch.zeros(kvh, G, Dh)
        for m, l, acc in parts:
            e = torch.exp(m - M)
            L = L + l * e
            o = o + acc * e[..., None]
        out[b] = (o / L.clamp(min=1e-30)[..., None]).reshape(H, Dh)
    return out


S = 2048
# (lanes' fills, window, query heads per KV head); q_pos = fill - 1
CASES = {
    "short": ([1, 63, 64], 0, 7),
    "long": ([65, 1330, S], 0, 7),
    "window": ([1330, S, 700], 100, 7),     # empties every split before it
    "g1": ([S, 65, 1], 0, 1),
    "one-short-lane": ([S] * 7 + [3] + [S - 64 * i for i in range(8)], 0, 7),
}


def _lanes(case, fmt, rng):
    fills, window, G = CASES[case]
    B, kvh, Dh = len(fills), 2, 64
    kv_len = torch.tensor(fills, dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, kvh * G, Dh))
                         .astype(np.float32))
    return B, kvh, Dh, kv_len, kv_len - 1, window, q


@pytest.mark.parametrize("fmt", tpk.KV_FMTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_merge_matches_contiguous_plain_version(case, fmt):
    rng = np.random.default_rng(20)
    B, kvh, Dh, kv_len, q_pos, window, q = _lanes(case, fmt, rng)
    k = torch.from_numpy(rng.standard_normal((B, S, kvh * Dh))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, kvh * Dh))
                         .astype(np.float32))
    kc, ks = tpk.kv_encode(k, fmt)
    vc, vs = tpk.kv_encode(v, fmt)
    want = tref.mx_attention_ref(q, kc, ks, vc, vs, q_pos, kv_len, fmt,
                                 window)
    got = _split_merge(q, tpk.kv_decode(kc, ks, fmt),
                       tpk.kv_decode(vc, vs, fmt), q_pos, kv_len, window, S)
    assert (got - want).abs().max() <= 1e-6


@pytest.mark.parametrize("fmt", tpk.KV_FMTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_merge_matches_paged_plain_version(case, fmt):
    rng = np.random.default_rng(21)
    B, kvh, Dh, kv_len, q_pos, window, q = _lanes(case, fmt, rng)
    P, maxp = 16, 128
    n_pages = 1 + B * maxp
    k = torch.from_numpy(rng.standard_normal((n_pages, P, kvh * Dh))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((n_pages, P, kvh * Dh))
                         .astype(np.float32))
    kc, ks = tpk.kv_encode(k, fmt)
    vc, vs = tpk.kv_encode(v, fmt)
    bt = torch.from_numpy(rng.permutation(np.arange(1, n_pages))
                          .reshape(B, maxp).astype(np.int32))
    for b, f in enumerate(kv_len.tolist()):
        bt[b, -(-f // P):] = 0          # past the fill: the scrap page
    want = tref.mx_attention_paged_ref(q, kc, ks, vc, vs, bt, q_pos, kv_len,
                                       fmt, window)
    pool_k = tpk.PagedKV(kc, ks, fmt).gather_dense(bt)
    pool_v = tpk.PagedKV(vc, vs, fmt).gather_dense(bt)
    got = _split_merge(q, pool_k, pool_v, q_pos, kv_len, window, maxp * P)
    assert (got - want).abs().max() <= 1e-6


@pytest.mark.parametrize("B", (1, 4, 16))
@pytest.mark.parametrize("limit", (64, 2048, 16 * 16, 128 * 16),
                         ids=("S=64", "S=2048", "pool=16x16", "pool=128x16"))
def test_decode_splits_cover_every_key_once(limit, B):
    """Every key below the layout's row count falls in exactly one split,
    each split is whole tiles and none lies wholly past the last row."""
    kvh = 2
    nsplit, chunk = tops.decode_splits(limit, B, kvh, SMS)
    assert chunk % TILE == 0 and nsplit >= 1
    assert (nsplit - 1) * chunk < limit <= nsplit * chunk
    kp = torch.arange(limit)
    hits = torch.zeros(limit, dtype=torch.int64)
    for s in range(nsplit):
        hits += ((kp >= s * chunk) & (kp < (s + 1) * chunk)).long()
    assert torch.equal(hits, torch.ones(limit, dtype=torch.int64))
    tiles = -(-limit // TILE)
    # about two blocks per SM, where the keys have that many tiles
    assert B * kvh * nsplit >= min(2 * SMS, B * kvh * tiles) // 2


def test_decode_splits_fill_the_card_at_four_lanes():
    """Four lanes of Qwen2-0.5B (2 KV heads) over 2048 rows: 32 splits of
    one tile, 256 blocks on 132 SMs."""
    assert tops.decode_splits(2048, 4, 2, SMS) == (32, 64)
