"""A CPU model of the arithmetic of the port's large-M MX GEMM tile
(``kernels/csrc/mx_gemm.cuh``), held against the plain versions and the JAX
package's Pallas kernels.

The tile multiplies bf16 operands on the tensor cores with f32 accumulators:
the MX-quantized activations and the decoded weights, both exact in bf16;
the products of two bf16 values are exact in f32, so the tile differs from
the plain versions only in where f32 sums round. The packed layout folds
each E8M0 scale (a power of two) into the bf16 weight and sums k16 step by
k16 step into one accumulator; the unpacked layout (f32 scales that need not
be powers of two) sums each 32-deep MX block into a fresh f32 fragment,
multiplies it by the column's scale and adds it to the running sum with one
rounding (fmaf). The T3 rotation (mx_common.cuh's ``rotate_h32``, which
every kernel's T3 runs) is a Walsh-Hadamard butterfly in f64, multiplied by
f32(1/sqrt(32)) and rounded to f32 once.

Tolerance: each path sums the same exact products in f32, so each is
within gamma_n * sum_k |x_k w_k| of the exact result, with n <= 32 + K/32 =
37 roundings here (gamma_n = n 2^-24, about 2.2e-6), and on these unit-normal
inputs sum_k |x_k w_k| <= 3.7 max |y|: the two may differ by 1.6e-5 of
max |y| at worst, and differ by at most 4e-8 of it as measured. The model
is held to 1e-5 of max |y|, the bound ``chip_smoke.py`` and the gpu tests
hold the CUDA tile to; a scale applied to the wrong MX block moves y by
about half of max |y| (checked below), so the bound separates rounding
from a wiring fault.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import packing as jpk
from repro_torch.core import mx as mxlib
from repro_torch.core import transforms as tfm
from repro_torch.kernels import packing as tpk
from repro_torch.kernels import ref as tref

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

MX_FMTS = ("mxfp4", "mxint4", "mxfp6", "mxfp8", "mxint8")
TOL = 1e-5          # of max |y|, argued in the module docstring


def _t(a):
    return torch.from_numpy(np.array(a))


def _spread(rng, shape):
    """Normal values whose 32-blocks span several binades."""
    x = rng.standard_normal(shape).astype(np.float32)
    e = rng.integers(-3, 6, (*shape[:-1], shape[-1] // 32, 1))
    return (x.reshape(*shape[:-1], -1, 32) * np.exp2(e)).reshape(
        shape).astype(np.float32)


def _bf16_exact(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the bf16 operand the tile stages; asserts the cast is exact."""
    b = t.to(torch.bfloat16)
    assert torch.equal(b.float(), t), "operand not exact in bf16"
    return b


def rotate_h32_fwht(x: torch.Tensor) -> torch.Tensor:
    """The kernels' T3: per 32-block, the Walsh-Hadamard butterfly
    (Sylvester order, index bit 0 first, each step (lower + upper, lower -
    upper)) in f64, times f32(1/sqrt(32)), rounded to f32 once."""
    *lead, K = x.shape
    d = x.double().reshape(*lead, K // 32, 32).clone()
    idx = torch.arange(32)
    for bit in (1, 2, 4, 8, 16):
        lo = idx[(idx & bit) == 0]
        a, b = d[..., lo], d[..., lo + bit]
        d[..., lo], d[..., lo + bit] = a + b, a - b
    h = float(np.float32(1.0 / np.sqrt(32.0)))
    return (d * h).reshape(*lead, K).float()


def tile_model_packed(x, w_packed, w_scales_e8m0, fmt="mxfp4", t3=False):
    """y = Q_mx(x [T3]) @ deq(w) as the packed tile sums it: bf16 operands
    (E8M0 scale folded into the weight), one f32 accumulator, k16 steps in
    K order."""
    xf = rotate_h32_fwht(x.float()) if t3 else x.float()
    a = _bf16_exact(mxlib.quantize(xf, mxlib.MXConfig(fmt=fmt))).float()
    codes = tpk.unpack_codes(w_packed.mT).mT
    scales = tpk.unpack_scales_e8m0(w_scales_e8m0)
    b = _bf16_exact(tref.mx_dequant_ref(codes.mT, scales.mT, fmt).mT).float()
    y = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        y = y + a[:, k:k + 16] @ b[k:k + 16]
    return y


def tile_model_unpacked(x, w_codes, w_scales, fmt, block_shift=0):
    """y = Q_mx(x) @ deq(w) as the unpacked tile sums it: bf16 operands (the
    bare code values), each MX block's product in a fresh f32 fragment,
    scaled per column and added with one rounding (f64 holds the exact
    product). ``block_shift`` applies block kb + shift's scales to block kb:
    a wiring fault, for the negative check."""
    K = x.shape[1]
    a = _bf16_exact(mxlib.quantize(x.float(), mxlib.MXConfig(fmt=fmt))
                    ).float()
    vals = mxlib.decode(w_codes.mT, torch.ones(w_codes.shape[1], K // 32),
                        mxlib.MXConfig(fmt=fmt)).mT
    b = _bf16_exact(vals).float()
    y = torch.zeros(a.shape[0], b.shape[1])
    nkb = K // 32
    for kb in range(nkb):
        part = a[:, 32 * kb:32 * kb + 32] @ b[32 * kb:32 * kb + 32]
        s = w_scales[(kb + block_shift) % nkb].float()
        y = (y.double() + part.double() * s.double()).float()
    return y


def _unpacked_weight(rng, K, N, fmt):
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    cj, sj = jops.mx_quantize(jnp.asarray(w.T.copy()), fmt, interpret=True)
    return np.asarray(cj).T.copy(), np.asarray(sj).T.copy()


def _close(y, ref, tol=TOL):
    scale = ref.abs().max()
    return (y - ref).abs().max() <= tol * scale


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_activation_values_exact_in_bf16(fmt):
    """Q_mx(x) in every format: grid values of at most 4 significant bits
    (int8: 7) times a power of two — the bf16 operand loses nothing."""
    x = torch.from_numpy(_spread(np.random.default_rng(20), (48, 256)))
    xq = mxlib.quantize(x, mxlib.MXConfig(fmt=fmt))
    assert torch.equal(xq.to(torch.bfloat16).float(), xq)


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_weight_values_exact_in_bf16(fmt):
    """Every code value of the format (the unpacked tile's B operand), and
    for the 4-bit formats every code times every E8M0 scale of the packed
    layout's normal range."""
    grid = torch.as_tensor(mxlib.FORMATS[fmt].full_grid(), dtype=torch.float32)
    assert torch.equal(grid.to(torch.bfloat16).float(), grid)
    if mxlib.FORMATS[fmt].bits == 4:
        s = torch.exp2(torch.arange(-126, 126, dtype=torch.float32))
        v = grid[:, None] * s[None, :]
        assert torch.equal(v.to(torch.bfloat16).float(), v)


@pytest.mark.parametrize("seed", (21, 22, 23))
def test_fwht_rotation_equals_plain_t3(seed):
    """The butterfly T3 lands on the same f32 values as the plain version's
    f64 product with blockdiag(H32), bit for bit."""
    x = torch.from_numpy(_spread(np.random.default_rng(seed), (64, 256)))
    plain = tfm.apply_blockwise(x, tfm.hadamard_matrix(32))
    assert torch.equal(rotate_h32_fwht(x), plain)


@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
@pytest.mark.parametrize("t3", (False, True))
def test_packed_tile_model(fmt, t3):
    """The packed tile's order against the plain version and the Pallas
    ``mx_matmul_packed`` (interpret mode): K = 160 is two full 64-deep stages
    and a half one."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal((20, 160)).astype(np.float32)
    w = (rng.standard_normal((160, 40)) / np.sqrt(160)).astype(np.float32)
    b = jpk.pack_weight(jnp.asarray(w), fmt)
    wp, ws = np.asarray(b["codes_packed"]), np.asarray(b["scales_e8m0"])
    y = tile_model_packed(_t(x), _t(wp), _t(ws), fmt, t3)
    assert _close(y, tref.mx_matmul_packed_ref(_t(x), _t(wp), _t(ws), fmt, t3))
    yj = np.asarray(jops.mx_gemm_packed(jnp.asarray(x), jnp.asarray(wp),
                                        jnp.asarray(ws), fmt, t3=t3,
                                        interpret=True))
    assert _close(y, _t(yj))


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_unpacked_tile_model(fmt):
    """The unpacked tile's per-block scale-after order against the plain
    version and the Pallas ``mx_matmul`` (interpret mode, called as
    test_torch_kernels does), with the JAX encoder's f32 scales and with
    scales an ulp off a power of two; a scale on the wrong block fails."""
    rng = np.random.default_rng(25)
    x = rng.standard_normal((20, 160)).astype(np.float32)
    wc, ws = _unpacked_weight(rng, 160, 40, fmt)
    for scales in (ws, ws * np.float32(1 + 2.0 ** -23)):
        y = tile_model_unpacked(_t(x), _t(wc), _t(scales), fmt)
        assert _close(y, tref.mx_matmul_ref(_t(x), _t(wc), _t(scales), fmt))
        yj = np.asarray(jops.mx_gemm(jnp.asarray(x), jnp.asarray(wc),
                                     jnp.asarray(scales), fmt,
                                     interpret=True))
        assert _close(y, _t(yj))
    wrong = tile_model_unpacked(_t(x), _t(wc), _t(ws), fmt, block_shift=1)
    assert not _close(wrong, tref.mx_matmul_ref(_t(x), _t(wc), _t(ws), fmt),
                      1e-2)
