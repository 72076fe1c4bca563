"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU every ``repro_torch.kernels.ops`` wrapper runs its kernel's
plain PyTorch version; the JAX side runs the Pallas kernels in interpret
mode. Same numpy inputs into both, tolerances stated per kernel. The CUDA
kernels themselves are held against the plain versions in
``test_torch_gpu.py``, on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import packing as jpk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packing as tpk
from repro_torch.kernels import ref as tref


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed_weight(rng, shape, fmt="mxfp4"):
    w = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    b = jpk.pack_weight(jnp.asarray(w), fmt)
    return np.asarray(b["codes_packed"]), np.asarray(b["scales_e8m0"])


@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
@pytest.mark.parametrize("t3", (False, True))
def test_gemm_packed_matches_pallas(fmt, t3):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    wp, ws = _packed_weight(rng, (96, 40), fmt)
    yj = np.asarray(jops.mx_gemm_packed(jnp.asarray(x), jnp.asarray(wp),
                                        jnp.asarray(ws), fmt, t3=t3,
                                        interpret=True))
    yt = tops.mx_gemm_packed(_t(x), _t(wp), _t(ws), fmt, t3=t3).numpy()
    scale = np.abs(yj).max()
    if t3:
        # the rotation's summation order can move a value across a snap
        # midpoint: one code step of one element
        assert np.abs(yt - yj).max() <= 1e-3 * scale
    else:
        np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6 * scale)


def test_gemm_packed_stacked_weights():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    wp, ws = _packed_weight(rng, (3, 64, 24))
    yj = np.asarray(jops.mx_gemm_packed(jnp.asarray(x), jnp.asarray(wp),
                                        jnp.asarray(ws), interpret=True))
    yt = tops.mx_gemm_packed(_t(x), _t(wp), _t(ws)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5,
                               atol=1e-6 * np.abs(yj).max())


@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
def test_quantizers_match_pallas(fmt):
    """The plain MX encoders — the tile bodies the GEMM and prefill kernels
    share — against the Pallas quantizers: codes byte-equal, scales equal;
    with T3 the rotation's summation order may flip a rare snap."""
    x = np.random.default_rng(6).standard_normal((8, 128)).astype(np.float32)
    cj, sj = jops.mx_quantize(jnp.asarray(x), fmt, interpret=True)
    ct, st = tref.mx_quant_ref(_t(x), fmt)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    cj, sj = jops.t3_quantize(jnp.asarray(x), fmt, interpret=True)
    ct, st = tref.hadamard_quant_ref(_t(x), fmt)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (ct.numpy() != np.asarray(cj)).mean() <= 1e-2


MX_FMTS = ("mxfp4", "mxint4", "mxfp6", "mxfp8", "mxint8")


def _spread(rng, shape):
    """Normal values whose 32-blocks span several binades (every block
    scale inside 2^+-12, where XLA's f32 exp2 is exact), one block zero."""
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp2(rng.integers(-3, 6, shape[:-1] + (shape[-1] // 32, 1))
                 ).astype(np.float32).repeat(32, axis=-1).reshape(shape)
    x.reshape(-1)[:32] = 0.0
    return x


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_standalone_quantizers_match_pallas(fmt):
    """ops.mx_quantize / ops.t3_quantize against the Pallas mx_quant /
    hadamard_quant in every MX format: mx_quantize codes and f32 scales
    byte-equal; t3_quantize scales equal and at most 1% of codes moved by
    the rotation's summation order."""
    x = _spread(np.random.default_rng(8), (24, 256))
    cj, sj = jops.mx_quantize(jnp.asarray(x), fmt, interpret=True)
    ct, st = tops.mx_quantize(_t(x), fmt)
    assert ct.dtype == torch.uint8 and st.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    cj, sj = jops.t3_quantize(jnp.asarray(x), fmt, interpret=True)
    ct, st = tops.t3_quantize(_t(x), fmt)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (ct.numpy() != np.asarray(cj)).mean() <= 1e-2


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_unpacked_gemm_matches_pallas(fmt):
    """ops.mx_gemm against the Pallas mx_matmul, with the weight codes and
    f32 scales made by the JAX package's encoder: rtol 1e-5."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / np.sqrt(96)).astype(np.float32)
    cj, sj = jops.mx_quantize(jnp.asarray(w.T.copy()), fmt, interpret=True)
    wc, ws = np.asarray(cj).T.copy(), np.asarray(sj).T.copy()
    yj = np.asarray(jops.mx_gemm(jnp.asarray(x), jnp.asarray(wc),
                                 jnp.asarray(ws), fmt, interpret=True))
    yt = tops.mx_gemm(_t(x), _t(wc), _t(ws), fmt).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5,
                               atol=1e-6 * np.abs(yj).max())


@pytest.mark.parametrize("fmt", jpk.KV_FMTS)
@pytest.mark.parametrize("window", (0, 7))
def test_flash_decode_matches_pallas(fmt, window):
    """ops.mx_flash_decode over a contiguous packed cache (GQA 14 over 2
    heads, ragged fills) against the Pallas kernel run with a multi-chunk
    grid (bs=16): atol 1e-5."""
    rng = np.random.default_rng(10)
    B, H, kvh, Dh, S = 3, 14, 2, 32, 64
    D = kvh * Dh
    kv_len = np.array([37, 64, 5], np.int32)
    q_pos = kv_len - 1
    caches = []
    for _ in range(2):
        c, sc = jpk.kv_encode(jnp.asarray(
            rng.standard_normal((B, S, D)).astype(np.float32)), fmt)
        caches += [np.asarray(c), np.asarray(sc)]
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    oj = np.asarray(jops.mx_flash_decode(
        jnp.asarray(q), *map(jnp.asarray, caches), jnp.asarray(q_pos),
        jnp.asarray(kv_len), fmt, window=window, bs=16, interpret=True))
    ot = tops.mx_flash_decode(_t(q), *map(_t, caches), _t(q_pos),
                              _t(kv_len), fmt, window=window).numpy()
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5)


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


@pytest.mark.parametrize("fmt", jpk.KV_FMTS)
@pytest.mark.parametrize("window", (0, 7))
def test_flash_decode_paged_matches_pallas(fmt, window):
    rng = np.random.default_rng(2)
    B, H, kvh, Dh, P, maxp = 3, 14, 2, 32, 16, 4
    n_pages = 1 + B * maxp
    kv_len = np.array([37, 64, 5], np.int32)          # ragged fills
    q_pos = kv_len - 1
    pool = _pool(rng, n_pages, P, kvh * Dh, fmt)
    bt = _scattered_tables(rng, B, maxp, n_pages, kv_len, P)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    oj = np.asarray(jops.mx_flash_decode_paged(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(bt),
        jnp.asarray(q_pos), jnp.asarray(kv_len), fmt, window=window,
        interpret=True))
    ot = tops.mx_flash_decode_paged(_t(q), *map(_t, pool), _t(bt),
                                    _t(q_pos), _t(kv_len), fmt,
                                    window=window).numpy()
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt", ("mxfp8", "mxfp4"))
def test_flash_prefill_matches_pallas(fmt):
    """Mid-page chunk starts: pool rows count only below q_start, chunk
    row i sits at q_start + i, and the byte outputs equal kv_encode."""
    _flash_prefill_vs_pallas(fmt, Dh=32)


@pytest.mark.parametrize("fmt", ("mxfp8", "mxfp4"))
def test_flash_prefill_matches_pallas_at_head_dim_128(fmt):
    """The same at Qwen2-7B's head width (two 64-feature operand panels in
    the kernel), G = 7."""
    _flash_prefill_vs_pallas(fmt, Dh=128)


def _flash_prefill_vs_pallas(fmt, Dh):
    rng = np.random.default_rng(3)
    B, C, H, kvh, P, maxp = 2, 16, 14, 2, 16, 3
    D, n_pages = kvh * Dh, 1 + B * maxp
    q_start = np.array([8, 24], np.int32)
    kv_len = q_start + C
    pool = _pool(rng, n_pages, P, D, fmt)
    bt = _scattered_tables(rng, B, maxp, n_pages, kv_len, P)
    q = rng.standard_normal((B, C, H, Dh)).astype(np.float32)
    kd = rng.standard_normal((B, C, D)).astype(np.float32)
    vd = rng.standard_normal((B, C, D)).astype(np.float32)
    outs_j = jops.mx_flash_prefill(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
        *map(jnp.asarray, pool), jnp.asarray(bt), jnp.asarray(q_start),
        jnp.asarray(kv_len), fmt, interpret=True)
    outs_t = tops.mx_flash_prefill(_t(q), _t(kd), _t(vd), *map(_t, pool),
                                   _t(bt), _t(q_start), _t(kv_len), fmt)
    np.testing.assert_allclose(outs_t[0].numpy(), np.asarray(outs_j[0]),
                               rtol=0, atol=1e-5)
    for a, b in zip(outs_t[1:], outs_j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kc, ks = jpk.kv_encode(jnp.asarray(kd), fmt)
    np.testing.assert_array_equal(outs_t[1].numpy(), np.asarray(kc))
    np.testing.assert_array_equal(outs_t[2].numpy(), np.asarray(ks))


def test_off_contract_inputs_raise():
    rng = np.random.default_rng(4)
    wp, ws = _packed_weight(rng, (64, 8))
    with pytest.raises(ValueError):
        tops.mx_gemm_packed(torch.zeros(2, 32), _t(wp), _t(ws))   # K
    with pytest.raises(ValueError):
        tops.mx_gemm_packed(torch.zeros(2, 64), _t(wp), _t(ws), "mxfp8")
    with pytest.raises(ValueError):
        tops.mx_gemm_packed(torch.zeros(2, 2, 64), _t(wp), _t(ws))  # rank
    codes = torch.zeros(5, 16, 64, dtype=torch.uint8)
    scales = torch.zeros(5, 16, 2, dtype=torch.uint8)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):           # 14 heads over 64/24 kv heads
        tops.mx_flash_decode_paged(torch.zeros(2, 14, 24), codes, scales,
                                   codes, scales, bt, lens, lens)
    with pytest.raises(ValueError):           # not a KV format
        tops.mx_flash_decode_paged(torch.zeros(2, 4, 16), codes, scales,
                                   codes, scales, bt, lens, lens, "mxfp6")
    with pytest.raises(ValueError):           # chunk width != D
        tops.mx_flash_prefill(torch.zeros(2, 4, 4, 16), torch.zeros(2, 4, 32),
                              torch.zeros(2, 4, 32), codes, scales, codes,
                              scales, bt, lens, lens)
    with pytest.raises(ValueError):           # no table slot
        tops.mx_flash_prefill(torch.zeros(2, 4, 4, 16), torch.zeros(2, 4, 64),
                              torch.zeros(2, 4, 64), codes, scales, codes,
                              scales, bt[:, :0], lens, lens)
    cc = torch.zeros(2, 16, 64, dtype=torch.uint8)
    cs = torch.zeros(2, 16, 2, dtype=torch.uint8)
    with pytest.raises(ValueError):           # 14 heads over 64/24 kv heads
        tops.mx_flash_decode(torch.zeros(2, 14, 24), cc, cs, cc, cs, lens,
                             lens)
    with pytest.raises(ValueError):           # lanes of q and cache differ
        tops.mx_flash_decode(torch.zeros(3, 4, 16), cc, cs, cc, cs, lens,
                             lens)
    with pytest.raises(ValueError):           # not a KV format
        tops.mx_flash_decode(torch.zeros(2, 4, 16), cc, cs, cc, cs, lens,
                             lens, "mxfp6")
    for quantize in (tops.mx_quantize, tops.t3_quantize):
        with pytest.raises(ValueError):       # K not a multiple of 32
            quantize(torch.zeros(2, 48))
        with pytest.raises(ValueError):       # not (M, K)
            quantize(torch.zeros(2, 2, 64))
        with pytest.raises(ValueError):       # unknown format
            quantize(torch.zeros(2, 64), "mxfp3")
    wc = torch.zeros(64, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):           # K of x and w differ
        tops.mx_gemm(torch.zeros(2, 32), wc, torch.ones(2, 8))
    with pytest.raises(ValueError):           # scales not (K//32, N)
        tops.mx_gemm(torch.zeros(2, 64), wc, torch.ones(2, 4))
    with pytest.raises(ValueError):           # codes not uint8
        tops.mx_gemm(torch.zeros(2, 64), wc.float(), torch.ones(2, 8))


def test_cpu_calls_do_not_count_as_launches():
    tops.reset_launches()
    rng = np.random.default_rng(5)
    wp, ws = _packed_weight(rng, (32, 8))
    tops.mx_gemm_packed(torch.ones(1, 32), _t(wp), _t(ws))
    x = torch.ones(2, 32)
    c, s = tops.mx_quantize(x)
    tops.t3_quantize(x)
    tops.mx_gemm(x, c.T.contiguous(), s.T.contiguous())
    kc, ks = tpk.kv_encode(torch.ones(2, 4, 32))
    tops.mx_flash_decode(torch.ones(2, 2, 16), kc, ks, kc, ks, 3, 4)
    assert set(tops.launches) >= {"mx_flash_decode", "mx_quantize",
                                  "t3_quantize", "mx_gemm"}
    assert tops.launches == {k: 0 for k in tops.launches}
