"""The port's MX numerics and byte layouts against the JAX package: the
same numpy inputs through ``repro`` and ``repro_torch`` must give the same
codes, scale bytes and decoded values, byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.kernels import packing as jpk
from repro_torch.core import mx as tmx
from repro_torch.kernels import packing as tpk

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

FMTS = ("mxfp4", "mxint4", "mxfp8", "mxint8", "mxfp6")

# k in [-20, 20) where the JAX package's block exponent (its E8M0 byte)
# differs from the exact one the port uses. For amax = nextafter(2^k, 0)
# the f32 log2 rounds up to k before the floor (exact: k - 1); for
# amax = 2^k exactly, XLA's log2 lands just below k at these two k.
JAX_EDGE_KS_BELOW = [-20, -19, -18, -17, -16, -14, -12, -11, -10, -9, -8,
                     -7, -6, -5, -4, -3, -2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                     12, 14, 16, 17, 18, 19]
JAX_EDGE_KS_POW2 = [13, 15]


def _x(seed, shape, spread=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if spread:   # blocks over many binades, plus an all-zero block
        # (kept where every block scale is 2^e with |e| <= 12: XLA's f32
        # exp2 is exact there, and outside it the JAX package's scales
        # are off by an ulp)
        x *= np.exp2(rng.integers(-3, 6, shape[:-1] + (1,))).astype(
            np.float32)
        x.reshape(-1)[:32] = 0.0
    return x


@pytest.mark.parametrize("fmt", FMTS)
def test_encode_decode_quantize_match(fmt):
    x = _x(0, (16, 128))
    cj = jmx.MXConfig(fmt=fmt)
    ct = tmx.MXConfig(fmt=fmt)
    codes_j, sc_j = jmx.encode(jnp.asarray(x), cj)
    codes_t, sc_t = tmx.encode(torch.from_numpy(x), ct)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    np.testing.assert_array_equal(
        tmx.decode(codes_t, sc_t, ct).numpy(),
        np.asarray(jmx.decode(codes_j, sc_j, cj)))
    np.testing.assert_array_equal(
        tmx.quantize(torch.from_numpy(x), ct).numpy(),
        np.asarray(jmx.quantize(jnp.asarray(x), cj, ste=False)))


def test_nvfp4_scales_match():
    x = _x(1, (8, 64))
    np.testing.assert_array_equal(
        tmx.quantize(torch.from_numpy(x), tmx.NVFP4).numpy(),
        np.asarray(jmx.quantize(jnp.asarray(x), jmx.NVFP4, ste=False)))


@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
def test_pack_weight_stacked(fmt):
    w = _x(2, (3, 96, 40), spread=False)
    bj = jpk.pack_weight(jnp.asarray(w), fmt)
    bt = tpk.pack_weight(torch.from_numpy(w), fmt)
    for key in ("codes_packed", "scales_e8m0"):
        assert bt[key].dtype == torch.uint8
        np.testing.assert_array_equal(bt[key].numpy(), np.asarray(bj[key]))
    np.testing.assert_array_equal(tpk.unpack_weight(bt).numpy(),
                                  np.asarray(jpk.unpack_weight(bj)))
    pw = tpk.PackedWeight.from_dense(torch.from_numpy(w), fmt)
    assert pw.shape == (3, 96, 40)
    np.testing.assert_array_equal(pw[1].to_dense().numpy(),
                                  np.asarray(jpk.unpack_weight(bj))[1])


@pytest.mark.parametrize("fmt", jpk.KV_FMTS)
def test_kv_encode_decode_match(fmt):
    x = _x(3, (2, 5, 128))
    cj, sj = jpk.kv_encode(jnp.asarray(x), fmt)
    ct, st = tpk.kv_encode(torch.from_numpy(x), fmt)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tpk.kv_decode(ct, st, fmt).numpy(),
                                  np.asarray(jpk.kv_decode(cj, sj, fmt)))


@pytest.mark.parametrize("fmt", ("none", "mxfp8", "mxfp4"))
def test_paged_pool_zeros_and_gather(fmt):
    shape = (6, 8, 64)
    pj = jpk.PagedKV.zeros(shape, fmt)
    pt = tpk.PagedKV.zeros(shape, fmt, device="cpu")
    np.testing.assert_array_equal(pt.codes.numpy(), np.asarray(pj.codes))
    x = _x(4, shape)
    if fmt != "none":
        cj, sj = jpk.kv_encode(jnp.asarray(x), fmt)
        pj = jpk.PagedKV(cj, sj, fmt)
        pt = tpk.PagedKV(torch.from_numpy(np.array(cj)),
                         torch.from_numpy(np.array(sj)), fmt)
    else:
        pj = jpk.PagedKV(jnp.asarray(x), None)
        pt = tpk.PagedKV(torch.from_numpy(x), None)
    bt = np.array([[3, 1, 0], [5, 2, 4]], np.int32)
    np.testing.assert_array_equal(
        pt.gather_dense(torch.from_numpy(bt)).numpy(),
        np.asarray(pj.gather_dense(jnp.asarray(bt))))


def test_block_exponent_edges_pinned():
    """The port takes the block exponent exactly from the float's bits
    (amax = 0 -> scale 1). The k in [-20, 20) where the JAX package's f32
    log2 lands elsewhere are pinned here and in ROADMAP.md Queue 3."""
    ks = list(range(-20, 20))
    below = [np.nextafter(np.float32(2.0 ** k), np.float32(0)) for k in ks]
    for amax, delta, pinned in ((below, 1, JAX_EDGE_KS_BELOW),
                                ([2.0 ** k for k in ks], 0, JAX_EDGE_KS_POW2)):
        x = np.zeros((len(ks), 32), np.float32)
        x[:, 0] = amax
        x[:, 1] = -np.asarray(amax, np.float32) / 3
        for fmt in ("mxfp4", "mxfp8"):
            r_max = tmx.FORMATS[fmt].r_max
            st = tmx.compute_scales(torch.from_numpy(x),
                                    tmx.MXConfig(fmt=fmt))
            exact = np.array([2.0 ** (k - delta - r_max) for k in ks],
                             np.float32)
            np.testing.assert_array_equal(st.numpy()[:, 0], exact)
            bt = tpk.pack_scales_e8m0(st).numpy()[:, 0]
            bj = np.asarray(jpk.pack_scales_e8m0(jmx.compute_scales(
                jnp.asarray(x), jmx.MXConfig(fmt=fmt))))[:, 0]
            assert [k for k, a, b in zip(ks, bj, bt) if a != b] == pinned
    assert tmx.compute_scales(torch.zeros(1, 32), tmx.MXConfig()).item() == 1.0


def test_e8m0_round_trip_and_packed_nbytes():
    e = np.arange(-40, 40)
    s = torch.from_numpy(np.exp2(e).astype(np.float32))
    b = tpk.pack_scales_e8m0(s)
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(jpk.pack_scales_e8m0(jnp.asarray(s.numpy()))))
    np.testing.assert_array_equal(tpk.unpack_scales_e8m0(b).numpy(),
                                  s.numpy())
    for fmt in FMTS:
        assert tmx.packed_nbytes((4, 64, 96), tmx.MXConfig(fmt=fmt)) == \
            jmx.packed_nbytes((4, 64, 96), jmx.MXConfig(fmt=fmt))


@pytest.mark.parametrize("fmt", jpk.KV_FMTS)
def test_packed_kv_zeros_from_dense_and_slices(fmt):
    """PackedKV: a fresh cache, ``from_dense`` of a cache whose tail rows
    are zeros (a wave's padded cache: amax 0 maps to scale 1), the decode
    back and a layer slice — byte-equal to the JAX package."""
    shape = (2, 3, 8, 64)
    zj = jpk.PackedKV.zeros(shape, fmt)
    zt = tpk.PackedKV.zeros(shape, fmt, device="cpu")
    np.testing.assert_array_equal(zt.codes.numpy(), np.asarray(zj.codes))
    np.testing.assert_array_equal(zt.scales.numpy(), np.asarray(zj.scales))
    x = _x(5, shape)
    x[..., 5:, :] = 0.0
    pj = jpk.PackedKV.from_dense(jnp.asarray(x), fmt)
    pt = tpk.PackedKV.from_dense(torch.from_numpy(x), fmt)
    assert pt.shape == tuple(pj.shape) == shape
    np.testing.assert_array_equal(pt.codes.numpy(), np.asarray(pj.codes))
    np.testing.assert_array_equal(pt.scales.numpy(), np.asarray(pj.scales))
    np.testing.assert_array_equal(pt.to_dense().numpy(),
                                  np.asarray(pj.to_dense()))
    np.testing.assert_array_equal(pt[1].codes.numpy(),
                                  np.asarray(pj.codes)[1])
    assert torch.equal(pt.to("cpu").scales, pt.scales)


@pytest.mark.parametrize("fmt", ("none",) + jpk.KV_FMTS)
def test_contiguous_cache_writes_match(fmt):
    """kv_write_rows (one row per lane at its own position) and
    kv_write_slice (a chunk at a shared start) leave the same bytes as the
    JAX package's writes; the port writes in place."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    B, S, D = 3, 16, 64
    base = _x(6, (B, S, D))
    if fmt == "none":
        cj, ct = jnp.asarray(base), torch.from_numpy(base.copy())
    else:
        cj = jpk.PackedKV.from_dense(jnp.asarray(base), fmt)
        ct = tpk.PackedKV.from_dense(torch.from_numpy(base), fmt)
    new = _x(7, (B, 1, D))
    rows = np.array([0, 9, 15], np.int32)
    cj = jl.kv_write_rows(cj, jnp.asarray(new), jnp.asarray(rows))
    assert tl.kv_write_rows(ct, torch.from_numpy(new),
                            torch.from_numpy(rows)) is ct
    chunk = _x(8, (B, 4, D))
    cj = jl.kv_write_slice(cj, jnp.asarray(chunk), jnp.int32(6))
    ct = tl.kv_write_slice(ct, torch.from_numpy(chunk), 6)
    if fmt == "none":
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    else:
        np.testing.assert_array_equal(ct.codes.numpy(), np.asarray(cj.codes))
        np.testing.assert_array_equal(ct.scales.numpy(),
                                      np.asarray(cj.scales))
