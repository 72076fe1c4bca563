"""A CPU model of the arithmetic of the port's paged flash-prefill
(``kernels/csrc/mx_prefill.cu``), held against the plain version and the JAX
package's Pallas ``mx_flash_prefill``.

The kernel multiplies bf16 operands on the tensor cores with f32
accumulators. K and V are decoded once per 64-key tile into bf16: an MX
code value times an E8M0 power of two, exact. Q and the probabilities P are
f32 and are split into three bf16 terms, hi = bf16(x), mid = bf16(x - hi),
lo = bf16(x - hi - mid), which sum to x exactly; every bf16 x bf16 product
is exact in f32, so S = Q K^T and P V differ from the plain version only in
the order of f32 additions.

The model follows the kernel's tiling (``tiling``): a block owns up to ROWS
consecutive (position, head) rows of a lane (whole positions where the G
heads of a KV head fit) and walks the keys its rows can see in stages of TS
keys aligned to TS — the prefix's (pool rows valid below q_start), then
the chunk's (row i at q_start + i) — from the window's first key to its
last position; each stage is NH tiles of 64 keys. (A consumer warpgroup
also skips a tile none of its 64 rows can see: an exact no-op of the
online softmax, so the model takes a block's rows together.) S sums the
k16 products of each 64-feature panel of Q and K. Heads up to 64 wide:
128 rows, 128-key stages, one panel; up to 128 wide: 64 rows, 64-key
stages, two panels.

Tolerance: each output is sum_k p_k v_k / l with 0 <= p_k <= 1, and the
model and the plain version round the same exact products' sums in f32 at
different places, on the scores (through exp) and on the P V sums. On
these unit-normal inputs max |out| is about 2-3.5 and the two agree to at
most 4.1e-7 of it (measured; the plain version and the Pallas kernel to
1.9e-7). They are held to TOL = 1e-6 of max |out|, 28-48x below the 1e-4
absolute bar that ``chip_smoke.py`` and the gpu tests hold the CUDA kernel
to. The bound separates rounding from wiring: a two-term split (which
leaves about 2^-17 of each Q and P element) lands at 2.1e-6 to 3.8e-6 of
max |out|, and a mask off by one row (the diagonal key dropped, or the
pool row at q_start counted a second time beside the chunk's) at 0.5 or
more.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import packing as jpk
from repro_torch.core import mx as mxlib
from repro_torch.kernels import packing as tpk
from repro_torch.kernels import ref as tref

KV_FMTS = ("mxfp8", "mxint8", "mxfp4", "mxint4")
TOL = 1e-6          # of max |out|, argued in the module docstring
# Heads of 128: each score sums twice the products, in six partial sums (3
# terms x 2 panels), and the model lands at up to 1.05e-6 of max |out| from
# the plain version on the WIDE cases (measured; the Pallas kernel 8.0e-7),
# a two-term split at 2.2e-6 or more: held to 1.5e-6.
TOL_WIDE = 1.5e-6
TK = 64             # keys per tile


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_exact(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the bf16 operand the kernel stages; asserts the cast is
    exact."""
    b = t.to(torch.bfloat16).float()
    assert torch.equal(b, t), "operand not exact in bf16"
    return b


def split_terms(x: torch.Tensor, terms: int = 3):
    """x (f32) as ``terms`` bf16 terms, each the bf16 rounding of what the
    ones before leave."""
    out, r = [], x
    for _ in range(terms):
        h = r.to(torch.bfloat16).float()
        out.append(h)
        r = r - h
    return out


def tiling(Dh):
    """(ROWS, TS, NP) of the kernel's instantiation for a head of Dh: rows a
    block, keys a stage, 64-feature panels."""
    return (128, 128, 1) if Dh <= 64 else (64, 64, 2)


def stages(st, kl, i0, i1, C, window, limit, TS, pool_extra=0):
    """The kernel's ``Plan``: the (source, first key, end) of each stage of
    the query positions [i0, i1) of a lane at q_start st, kv_len kl; source
    0 the pool (key = position), 1 the chunk (row i at st + i).
    ``pool_extra`` = 1 counts the pool row at q_start too (a fault)."""
    plo = max(0, st + i0 - window + 1) if window > 0 else 0
    phi = min(st + pool_extra, kl, st + i1, limit)
    out = [(0, k0, phi) for k0 in range(plo & ~(TS - 1), phi, TS)
           if phi > plo]
    clo = max(0, i0 - window + 1) if window > 0 else 0
    chi = min(C, i1, kl - st)
    out += [(1, k0, chi) for k0 in range(clo & ~(TS - 1), chi, TS)
            if chi > clo]
    return out


def prefill_model(*args, **kw):
    """The kernel's arithmetic, in its tiling, in plain PyTorch: returns
    out (B, C, H, Dh); the arguments of :func:`_prefill_model`. Its many
    small products run on one thread (restored after): with the suite's
    test workers sharing the machine's cores, a thread pool per product
    cost more than the products."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _prefill_model(*args, **kw)
    finally:
        torch.set_num_threads(threads)


def _prefill_model(q, k_chunk, v_chunk, k_codes, k_scales, v_codes,
                   v_scales, block_tables, q_start, kv_len, fmt="mxfp8",
                   window=0, terms=3, off_by_one=None):
    """``off_by_one`` ("causal": the diagonal key masked; "pool": the pool
    row at q_start counted too) models a wiring fault, for the negative
    checks."""
    B, C, H, Dh = q.shape
    kc, ks = tpk.kv_encode(k_chunk, fmt)
    vc, vs = tpk.kv_encode(v_chunk, fmt)
    P = k_codes.shape[1]
    maxp = block_tables.shape[1]
    D = k_chunk.shape[-1]
    kvh = D // Dh
    G = H // kvh
    ROWS, TS, NP = tiling(Dh)
    RPB = ROWS // G * G if G <= ROWS else ROWS
    sm = tref.sm_scale(Dh)
    out = torch.zeros(B, C, H, Dh)

    def dec(codes, scales):
        return _bf16_exact(tpk.kv_decode(codes, scales, fmt))

    for b in range(B):
        st, kl = int(q_start[b]), int(kv_len[b])
        pages = block_tables[b].long()
        pool_k = dec(k_codes[pages], k_scales[pages]).reshape(maxp * P, D)
        pool_v = dec(v_codes[pages], v_scales[pages]).reshape(maxp * P, D)
        src_kv = [(pool_k, pool_v, 0),
                  (dec(kc[b], ks[b]), dec(vc[b], vs[b]), st)]
        limit = maxp * P
        for hk in range(kvh):
            cols = slice(hk * Dh, (hk + 1) * Dh)
            qk = q[b, :, hk * G:(hk + 1) * G].reshape(C * G, Dh).float()
            for rb in range(0, C * G, RPB):          # a block's rows
                R = min(RPB, C * G - rb)
                i0, i1 = rb // G, (rb + R - 1) // G + 1
                plan = stages(st, kl, i0, i1, C, window, limit, TS,
                              int(off_by_one == "pool"))
                rows = torch.arange(rb, rb + R)
                qp = st + rows // G
                qt = split_terms(qk[rows], terms)
                m = torch.full((R,), tref.NEG_INF)
                l = torch.zeros(R)
                acc = torch.zeros(R, Dh)
                for src, k0s, hi in plan:
                    kk, vv, kb = src_kv[src]
                    for k0 in range(k0s, min(k0s + TS, hi), TK):
                        k = torch.arange(k0, k0 + TK)
                        valid = k < hi
                        kt = torch.zeros(TK, Dh)
                        vt = torch.zeros(TK, Dh)
                        kt[valid] = kk[k[valid], cols]
                        vt[valid] = vv[k[valid], cols]
                        s = sum(t[:, f:f + 64] @ kt[:, f:f + 64].T
                                for t in qt
                                for f in range(0, 64 * NP, 64)) * sm
                        kp = kb + k
                        ok = valid[None, :] & (kp[None, :] <= qp[:, None])
                        if off_by_one == "causal":
                            ok = valid[None, :] & (kp[None, :] < qp[:, None])
                        if window:
                            ok = ok & (kp[None, :] > qp[:, None] - window)
                        s = torch.where(ok, s, torch.tensor(-torch.inf))
                        m_new = torch.maximum(m, s.amax(dim=1))
                        p = torch.where(ok, torch.exp(s - m_new[:, None]),
                                        torch.zeros(()))
                        corr = torch.exp(m - m_new)
                        l = l * corr + p.sum(dim=1)
                        acc = acc * corr[:, None] + sum(
                            t @ vt for t in split_terms(p, terms))
                        m = m_new
                o = acc / torch.clamp(l, min=1e-30)[:, None]
                out[b, qp - st, hk * G + rows % G] = o
    return out


def _pool(rng, n_pages, P, D, fmt):
    k = rng.standard_normal((n_pages, P, D)).astype(np.float32)
    v = rng.standard_normal((n_pages, P, D)).astype(np.float32)
    kc, ks = jpk.kv_encode(jnp.asarray(k), fmt)
    vc, vs = jpk.kv_encode(jnp.asarray(v), fmt)
    return [np.asarray(a) for a in (kc, ks, vc, vs)]


def _scattered_tables(rng, B, maxp, n_pages, fills, P):
    bt = rng.permutation(np.arange(1, n_pages))[:B * maxp].reshape(B, maxp)
    bt = bt.astype(np.int32)
    for b, f in enumerate(fills):
        bt[b, -(-f // P):] = 0        # past the fill: the scrap page
    return bt


# (C, q_start, kv_len - q_start - C, window): mid-page chunk starts (P = 16),
# a sliding window, a fill that stops short of the chunk's end; every C
# leaves the kernel's last row tile (18 positions at G = 7) part empty
CASES = {"midpage": (40, (8, 37), (0, 0), 0),
         "window": (40, (0, 70), (0, 0), 20),
         "ragged": (23, (5, 64), (0, -6), 0)}


# the query heads over the KV heads, and the head width, of the wide
# cases: Qwen2-7B's G = 7 at head_dim 128 on every CASES entry, and G = 72,
# more heads than a block's 64 rows, so a position's heads span two blocks
WIDE = {"midpage": (14, 2, 128), "window": (14, 2, 128),
        "ragged": (14, 2, 128), "g72": (72, 1, 128)}


def _case(name, fmt, seed=30, heads=(14, 2, 64)):
    C, starts, short, window = CASES["midpage" if name == "g72" else name]
    rng = np.random.default_rng(seed)
    (H, kvh, Dh), P, maxp = heads, 16, 8
    B = 2
    D, n_pages = kvh * Dh, 1 + B * maxp
    q_start = np.array(starts, np.int32)
    kv_len = (q_start + C + np.array(short)).astype(np.int32)
    pool = _pool(rng, n_pages, P, D, fmt)
    bt = _scattered_tables(rng, B, maxp, n_pages, q_start + C, P)
    q = rng.standard_normal((B, C, H, Dh)).astype(np.float32)
    kd = rng.standard_normal((B, C, D)).astype(np.float32)
    vd = rng.standard_normal((B, C, D)).astype(np.float32)
    return q, kd, vd, pool, bt, q_start, kv_len, window


def _model(args, fmt, **kw):
    q, kd, vd, pool, bt, q_start, kv_len, window = args
    return prefill_model(_t(q), _t(kd), _t(vd), *map(_t, pool), _t(bt),
                         q_start, kv_len, fmt, window, **kw)


def _plain(args, fmt):
    q, kd, vd, pool, bt, q_start, kv_len, window = args
    return tref.mx_prefill_ref(_t(q), _t(kd), _t(vd), *map(_t, pool), _t(bt),
                               _t(q_start), _t(kv_len), fmt, window)[0]


def _err(y, ref):
    """max |y - ref| as a share of max |ref|."""
    return ((y - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("fmt", KV_FMTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_model_matches_plain_and_pallas(fmt, case):
    """Three-term splits, bf16 K/V, 64-key tiles: within TOL of max |out| of
    the plain version and of the Pallas kernel (interpret mode, called as
    test_torch_kernels does)."""
    args = _case(case, fmt)
    q, kd, vd, pool, bt, q_start, kv_len, window = args
    y = _model(args, fmt)
    assert _err(y, _plain(args, fmt)) <= TOL
    oj = jops.mx_flash_prefill(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
        *map(jnp.asarray, pool), jnp.asarray(bt), jnp.asarray(q_start),
        jnp.asarray(kv_len), fmt, window=window, interpret=True)[0]
    assert _err(y, _t(oj)) <= TOL


@pytest.mark.parametrize("fmt", ("mxfp8", "mxint4"))
@pytest.mark.parametrize("case", sorted(WIDE))
def test_wide_head_model_matches_plain_and_pallas(fmt, case):
    """The tiling of heads up to 128 wide (64 rows a block, 64-key stages,
    two 64-feature panels), in an 8-bit and a 4-bit KV format (the decode
    of each format is the narrow tiling's, tested in all four above):
    within TOL_WIDE of max |out| of the plain version and of the Pallas
    kernel, and a two-term split or a mask off by one row still outside
    it."""
    args = _case(case, fmt, heads=WIDE[case])
    q, kd, vd, pool, bt, q_start, kv_len, window = args
    y = _model(args, fmt)
    ref = _plain(args, fmt)
    assert _err(y, ref) <= TOL_WIDE
    oj = jops.mx_flash_prefill(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
        *map(jnp.asarray, pool), jnp.asarray(bt), jnp.asarray(q_start),
        jnp.asarray(kv_len), fmt, window=window, interpret=True)[0]
    assert _err(y, _t(oj)) <= TOL_WIDE
    if fmt == "mxfp8":
        assert _err(_model(args, fmt, terms=2), ref) > TOL_WIDE
        for fault in ("causal", "pool"):
            assert _err(_model(args, fmt, off_by_one=fault), ref) > 1e3 * TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_1e4_bar_as_a_share_of_max_out(case):
    """The chip's bar, 1e-4 absolute, is 2e-5 to 1e-4 of max |out| on these
    unit-normal inputs; the model's distance from the plain version is at
    most TOL, far inside it."""
    args = _case(case, "mxfp8")
    ref = _plain(args, "mxfp8")
    bar = 1e-4 / ref.abs().max().item()
    assert 2e-5 <= bar <= 1e-4
    assert _err(_model(args, "mxfp8"), ref) <= TOL < bar


@pytest.mark.parametrize("fmt", KV_FMTS)
def test_decoded_kv_exact_in_bf16(fmt):
    """Every code value times every E8M0 scale whose product is a normal
    f32, and the decode of blocks spread over 2^-100 .. 2^100 (the encoder's
    scale exponents there), are exact in bf16: the kernel's K/V operands
    lose nothing."""
    bits = tpk.kv_fmt_bits(fmt)
    n = 32 if bits == 8 else 16                 # code bytes per 32-block
    codes = torch.arange(len(mxlib.FORMATS[fmt].full_grid()),
                         dtype=torch.uint8)     # every code of the format
    if bits == 4:
        codes = codes | (codes << 4)            # in both nibbles
    rows = codes.repeat(n * 256 // len(codes) + 1)[:n * 256].reshape(-1, n)
    for sbyte in range(0, 256, 5):
        sc = torch.full((rows.shape[0], 1), sbyte, dtype=torch.uint8)
        v = tpk.kv_decode(rows, sc, fmt)
        normal = (v == 0) | (v.abs() >= 2.0 ** -126)
        assert torch.isfinite(v).all() or sbyte >= 250
        fin = normal & torch.isfinite(v)
        assert torch.equal(v[fin].to(torch.bfloat16).float(), v[fin])
    rng = np.random.default_rng(31)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    e = rng.integers(-100, 101, (64, 8, 1))
    x = torch.from_numpy((x.reshape(64, 8, 32) * np.exp2(e)).reshape(64, 256)
                         .astype(np.float32))
    v = tpk.kv_decode(*tpk.kv_encode(x, fmt), fmt)
    assert torch.equal(v.to(torch.bfloat16).float(), v)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_term_split_misses_the_bound(case):
    """Two bf16 terms leave about 2^-17 of each Q and P element: far
    outside TOL, so the bound tells the three-term split from it."""
    args = _case(case, "mxfp8")
    assert _err(_model(args, "mxfp8", terms=2), _plain(args, "mxfp8")) > TOL


@pytest.mark.parametrize("fault", ("causal", "pool"))
@pytest.mark.parametrize("case", sorted(CASES))
def test_mask_off_by_one_misses_the_bound(case, fault):
    """The diagonal key masked, or the pool row at q_start counted beside
    the chunk's own row: outside TOL by orders of magnitude."""
    args = _case(case, "mxfp8")
    y = _model(args, "mxfp8", off_by_one=fault)
    assert _err(y, _plain(args, "mxfp8")) > 1e3 * TOL
