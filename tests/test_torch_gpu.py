"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU. Every test here needs the card: it carries the ``gpu`` marker
and skips, from inside the fixture, where there is none. This file
imports no JAX, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.packing import PackedWeight, kv_encode


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda_device):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(40, 128, generator=g, device=dev)
    w = torch.randn(128, 96, generator=g, device=dev) / 128 ** 0.5
    pw = PackedWeight.from_dense(w)
    for t3 in (False, True):
        y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
        yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0,
                                       t3=t3)
        assert (y - yp).abs().max() <= 1e-4 * yp.abs().max()
    B, H, kvh, Dh, P, maxp = 3, 14, 2, 64, 32, 3
    D, n_pages = kvh * Dh, 1 + 3 * 3
    kc, ks = kv_encode(torch.randn(n_pages, P, D, generator=g, device=dev))
    vc, vs = kv_encode(torch.randn(n_pages, P, D, generator=g, device=dev))
    bt = (torch.arange(B * maxp, device=dev, dtype=torch.int32) + 1
          ).reshape(B, maxp)
    kl = torch.tensor([70, 33, 9], dtype=torch.int32, device=dev)
    q = torch.randn(B, H, Dh, generator=g, device=dev)
    out = tops.mx_flash_decode_paged(q, kc, ks, vc, vs, bt, kl - 1, kl)
    ref = tref.mx_attention_paged_ref(q, kc, ks, vc, vs, bt, kl - 1, kl)
    assert (out - ref).abs().max() <= 1e-4
    C = 24
    st = torch.tensor([0, 40, 5], dtype=torch.int32, device=dev)
    qc = torch.randn(B, C, H, Dh, generator=g, device=dev)
    kd = torch.randn(B, C, D, generator=g, device=dev)
    vd = torch.randn(B, C, D, generator=g, device=dev)
    outs = tops.mx_flash_prefill(qc, kd, vd, kc, ks, vc, vs, bt, st, st + C)
    refs = tref.mx_prefill_ref(qc, kd, vd, kc, ks, vc, vs, bt, st, st + C)
    assert (outs[0] - refs[0]).abs().max() <= 1e-4
    for a, b in zip(outs[1:], refs[1:]):
        assert torch.equal(a, b)


MX_FMTS = ("mxfp4", "mxint4", "mxfp6", "mxfp8", "mxint8")


def _spread(g, shape, dev):
    """Normal values whose 32-blocks span several binades, one block zero."""
    x = torch.randn(*shape, generator=g, device=dev)
    e = torch.randint(-3, 6, (*shape[:-1], shape[-1] // 32, 1), generator=g,
                      device=dev).float()
    x = (x.reshape(*shape[:-1], -1, 32) * torch.exp2(e)).reshape(shape)
    x.reshape(-1)[:32] = 0.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", MX_FMTS)
def test_cuda_quantizers_byte_equal_to_plain_versions(cuda_device, fmt):
    """mx_quantize / t3_quantize: codes and scales equal to the plain
    versions, byte for byte, in every MX format."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = _spread(g, (40, 256), cuda_device)
    for kernel, plain in ((tops.mx_quantize, tref.mx_quant_ref),
                          (tops.t3_quantize, tref.hadamard_quant_ref)):
        c, s = kernel(x, fmt)
        cp, sp = plain(x, fmt)
        assert c.dtype == torch.uint8 and s.dtype == torch.float32
        assert torch.equal(c, cp) and torch.equal(s, sp)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", MX_FMTS)
def test_cuda_unpacked_gemm_matches_plain_version(cuda_device, fmt):
    """mx_gemm within 1e-5 of max |y| of the plain version, with power-of-two
    scales and with scales an ulp off a power of two."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(37, 160, generator=g, device=cuda_device)
    w = torch.randn(160, 72, generator=g, device=cuda_device) / 160 ** 0.5
    wc, ws = tref.mx_quant_ref(w.T.contiguous(), fmt)
    wc, ws = wc.T.contiguous(), ws.T.contiguous()
    for scales in (ws, ws * (1 + 2.0 ** -23)):
        y = tops.mx_gemm(x, wc, scales, fmt)
        yp = tref.mx_matmul_ref(x, wc, scales, fmt)
        assert (y - yp).abs().max() <= 1e-5 * yp.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("mxfp8", "mxint8", "mxfp4", "mxint4"))
def test_cuda_contiguous_flash_decode_matches_plain_version(cuda_device,
                                                            fmt):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, H, kvh, Dh, S = 3, 14, 2, 64, 200
    kc, ks = kv_encode(torch.randn(B, S, kvh * Dh, generator=g,
                                   device=cuda_device), fmt)
    vc, vs = kv_encode(torch.randn(B, S, kvh * Dh, generator=g,
                                   device=cuda_device), fmt)
    kl = torch.tensor([200, 131, 9], dtype=torch.int32, device=cuda_device)
    q = torch.randn(B, H, Dh, generator=g, device=cuda_device)
    for window in (0, 7):
        out = tops.mx_flash_decode(q, kc, ks, vc, vs, kl - 1, kl, fmt,
                                   window=window)
        ref = tref.mx_attention_ref(q, kc, ks, vc, vs, kl - 1, kl, fmt,
                                    window=window)
        assert (out - ref).abs().max() <= 1e-5
