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
@pytest.mark.parametrize("t3", (False, True))
@pytest.mark.parametrize("fmt", MX_FMTS)
@pytest.mark.parametrize("M,K", ((1, 32), (3, 96), (7, 1056), (33, 4864)))
def test_cuda_quantizers_odd_shapes(cuda_device, M, K, fmt, t3):
    """Block counts the kernel's tiling does not divide: one 32-block (a
    warp with one block), 9 (not a multiple of 4), 231 (a warp part full),
    5016 (a part-full thread block); codes and scales byte-equal to the
    plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = _spread(g, (M, K), cuda_device)
    kernel, plain = ((tops.t3_quantize, tref.hadamard_quant_ref) if t3
                     else (tops.mx_quantize, tref.mx_quant_ref))
    c, s = kernel(x, fmt)
    cp, sp = plain(x, fmt)
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


# The small-M (decode) GEMM: every M up to ops.GEMV_MAX_M runs it, M + 1 the
# tile. Qwen2-0.5B's four decode projections, and widths that are not a
# multiple of 16 (byte-wise loads instead of 16-byte lines).
GEMV_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 136),
               (896, 4872))
GEMV_MS = (1, 2, 3, 4, 5, tops.GEMV_MAX_M, tops.GEMV_MAX_M + 1)


def _gemm_operands(dev, M, K, N, fmt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev)
    w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
    return x, PackedWeight.from_dense(w, fmt)


@pytest.mark.gpu
@pytest.mark.parametrize("t3", (False, True))
@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
@pytest.mark.parametrize("K,N", GEMV_SHAPES)
@pytest.mark.parametrize("M", GEMV_MS)
def test_cuda_small_m_gemm_matches_plain_version(cuda_device, M, K, N, fmt,
                                                 t3):
    x, pw = _gemm_operands(cuda_device, M, K, N, fmt, 4)
    y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, fmt, t3=t3)
    yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0, fmt,
                                   t3=t3)
    assert y.shape == (M, N)
    assert (y - yp).abs().max() <= 1e-4 * yp.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,t3", ((896, 896, False), (896, 128, False),
                                    (896, 4864, False), (4864, 896, True)))
def test_cuda_small_m_gemm_is_bitwise_repeatable(cuda_device, K, N, t3):
    """Split-K partials are summed in a fixed order: two calls agree bit for
    bit."""
    x, pw = _gemm_operands(cuda_device, 4, K, N, "mxfp4", 5)
    y1 = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    y2 = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    assert torch.equal(y1, y2)


# MLP widths of larger configurations of the JAX package (Qwen2-7B,
# InternVL2-26B, DeepSeek-67B): a split of K holds more MX blocks than the
# kernel stages in shared memory at once, so it walks K in chunks.
LARGE_GEMV_SHAPES = ((3584, 18944, False), (18944, 3584, True),
                     (6144, 16384, False), (8192, 22016, False),
                     (22016, 8192, True))


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,t3", LARGE_GEMV_SHAPES)
def test_cuda_small_m_gemm_large_widths(cuda_device, K, N, t3):
    x, pw = _gemm_operands(cuda_device, 4, K, N, "mxfp4", 7)
    y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0,
                                   t3=t3)
    assert y.shape == (4, N)
    assert (y - yp).abs().max() <= 1e-4 * yp.abs().max()
    assert torch.equal(
        y, tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3))


# The large-M tile (M > 16): ragged row tiles of 128 (17, 63, 64, 65, 129,
# 1000 rows), a ragged column tile and a half last K stage (160, 72: K is 5
# MX blocks, N is not a multiple of 16, so the weights are staged byte by
# byte), and Qwen2-0.5B's prefill widths.
TILE_MS = (17, 63, 64, 65, 129, 1000)
TILE_SHAPES = ((160, 72), (896, 128), (896, 4864), (4864, 896))


@pytest.mark.gpu
@pytest.mark.parametrize("t3", (False, True))
@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
@pytest.mark.parametrize("K,N", TILE_SHAPES)
@pytest.mark.parametrize("M", TILE_MS)
def test_cuda_tile_gemm_matches_plain_version(cuda_device, M, K, N, fmt, t3):
    """Within 1e-4 of max |y| of the plain version (f32 sums in another
    order over bf16-exact operands), and two calls bitwise equal."""
    x, pw = _gemm_operands(cuda_device, M, K, N, fmt, 8)
    y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, fmt, t3=t3)
    yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0, fmt,
                                   t3=t3)
    assert y.shape == (M, N)
    assert (y - yp).abs().max() <= 1e-4 * yp.abs().max()
    assert torch.equal(y, tops.mx_gemm_packed(x, pw.codes_packed,
                                              pw.scales_e8m0, fmt, t3=t3))


@pytest.mark.gpu
@pytest.mark.parametrize("t3", (False, True))
@pytest.mark.parametrize("M,K,N", ((300, 896, 4864), (1000, 160, 8200)))
def test_cuda_tile_gemm_256_row_tiles(cuda_device, M, K, N, t3):
    """Grids of at least half as many 256-row tiles as the card has SMs take
    the 256-row tile: a ragged last row tile (300 rows), and a ragged column
    tile with weights staged byte by byte (N % 16 != 0) and a half last K
    stage (160)."""
    x, pw = _gemm_operands(cuda_device, M, K, N, "mxfp4", 11)
    y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0,
                                   t3=t3)
    assert (y - yp).abs().max() <= 1e-4 * yp.abs().max()
    assert torch.equal(y, tops.mx_gemm_packed(x, pw.codes_packed,
                                              pw.scales_e8m0, t3=t3))


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", ((160, 72), (896, 128)))
def test_cuda_tile_gemm_stacked_weights(cuda_device, K, N):
    """Stacked (L, K/2, N) weights with x (L, M, K): each layer's product
    against the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    L, M = 3, 129
    x = torch.randn(L, M, K, generator=g, device=cuda_device)
    w = torch.randn(L, K, N, generator=g, device=cuda_device) / K ** 0.5
    pw = PackedWeight.from_dense(w)
    for t3 in (False, True):
        y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
        yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0,
                                       t3=t3)
        assert y.shape == (L, M, N)
        assert (y - yp).abs().max() <= 1e-4 * yp.abs().max()


# Expert-stacked calls (the MoE family's qeinsum): E experts of M rows in
# one launch, on both routes (M <= 16: the small-M kernel; above: the tile).
# Qwen1.5-MoE-A2.7B's expert widths (60 experts, d 2048, f 1408; M = 32 is
# its decode step's 4 groups x capacity 8, M = 8 the reduced configs'),
# Moonlight's 64 experts, a ragged N of 60 (byte-wise staging), half last K
# stages (160, 96: the box reads the next expert's first rows), and ragged
# M (100, 17), where the last expert's row tile runs past the array's end.
EXPERT_CASES = ((60, 8, 2048, 1408, False), (60, 32, 2048, 1408, False),
                (60, 32, 1408, 2048, True), (60, 8, 1408, 2048, True),
                (64, 8, 2048, 1408, False), (6, 8, 128, 60, False),
                (6, 32, 128, 60, True), (6, 100, 160, 72, False),
                (4, 17, 96, 48, True), (3, 129, 896, 128, True))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("mxfp4", "mxint4"))
@pytest.mark.parametrize("E,M,K,N,t3", EXPERT_CASES)
def test_cuda_expert_stacked_gemm(cuda_device, E, M, K, N, t3, fmt):
    """One launch for the E products, each within 1e-4 of its max |y| of
    the plain version; two calls bitwise equal."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.randn(E, M, K, generator=g, device=cuda_device)
    w = torch.randn(E, K, N, generator=g, device=cuda_device) / K ** 0.5
    pw = PackedWeight.from_dense(w, fmt)
    tops.reset_launches()
    y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, fmt, t3=t3)
    assert tops.launches["mx_gemm_packed"] == 1
    yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0, fmt,
                                   t3=t3)
    assert y.shape == (E, M, N)
    err = (y - yp).abs().amax(dim=(1, 2))
    assert (err <= 1e-4 * yp.abs().amax(dim=(1, 2))).all()
    assert torch.equal(y, tops.mx_gemm_packed(x, pw.codes_packed,
                                              pw.scales_e8m0, fmt, t3=t3))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", MX_FMTS)
@pytest.mark.parametrize("K,N", ((160, 72), (896, 4864)))
@pytest.mark.parametrize("M", (17, 300))
def test_cuda_tile_unpacked_gemm_matches_plain_version(cuda_device, M, K, N,
                                                       fmt):
    """mx_gemm through the tile: each MX block's partial product scaled in
    registers; within 1e-5 of max |y| with power-of-two scales and with
    scales an ulp off one, and two calls bitwise equal."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(M, K, generator=g, device=cuda_device)
    w = torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5
    wc, ws = tref.mx_quant_ref(w.T.contiguous(), fmt)
    wc, ws = wc.T.contiguous(), ws.T.contiguous()
    for scales in (ws, ws * (1 + 2.0 ** -23)):
        y = tops.mx_gemm(x, wc, scales, fmt)
        yp = tref.mx_matmul_ref(x, wc, scales, fmt)
        assert (y - yp).abs().max() <= 1e-5 * yp.abs().max()
        assert torch.equal(y, tops.mx_gemm(x, wc, scales, fmt))


def _decode_case(dev, case, fmt, layout, Dh=64, seed=6):
    """q, the packed KV of ``layout`` and the plain version's output, for a
    case of test_torch_split_decode.CASES."""
    from test_torch_split_decode import CASES, S
    fills, window, G = CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    B, kvh = len(fills), 2
    kl = torch.tensor(fills, dtype=torch.int32, device=dev)
    q = torch.randn(B, kvh * G, Dh, generator=g, device=dev)
    if layout == "contiguous":
        kc, ks = kv_encode(torch.randn(B, S, kvh * Dh, generator=g,
                                       device=dev), fmt)
        vc, vs = kv_encode(torch.randn(B, S, kvh * Dh, generator=g,
                                       device=dev), fmt)
        args = (q, kc, ks, vc, vs, kl - 1, kl, fmt)
        return (tops.mx_flash_decode(*args, window=window),
                tref.mx_attention_ref(*args, window=window))
    P, maxp = 16, S // 16
    n_pages = 1 + B * maxp
    kc, ks = kv_encode(torch.randn(n_pages, P, kvh * Dh, generator=g,
                                   device=dev), fmt)
    vc, vs = kv_encode(torch.randn(n_pages, P, kvh * Dh, generator=g,
                                   device=dev), fmt)
    bt = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).reshape(
        B, maxp).to(torch.int32)
    for b, f in enumerate(fills):
        bt[b, -(-f // P):] = 0
    args = (q, kc, ks, vc, vs, bt, kl - 1, kl, fmt)
    return (tops.mx_flash_decode_paged(*args, window=window),
            tref.mx_attention_paged_ref(*args, window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("contiguous", "paged"))
@pytest.mark.parametrize("fmt", ("mxfp8", "mxint8", "mxfp4", "mxint4"))
@pytest.mark.parametrize("case", ("short", "long", "window", "g1",
                                  "one-short-lane"))
def test_cuda_split_decode_matches_plain_version(cuda_device, case, fmt,
                                                 layout):
    """Both flash-decode layouts against their plain versions: fills of 1,
    63, 64, 65, 1330 and the full 2048 rows, a window that empties whole
    splits, G = 7 and G = 1, one lane far shorter than the rest."""
    out, ref = _decode_case(cuda_device, case, fmt, layout)
    assert (out - ref).abs().max() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("contiguous", "paged"))
@pytest.mark.parametrize("Dh", (16, 32, 128))
def test_cuda_split_decode_head_widths(cuda_device, Dh, layout):
    """One load item per key row slice (Dh = 16) up to eight (Dh = 128)."""
    for fmt in ("mxfp8", "mxfp4"):
        out, ref = _decode_case(cuda_device, "long", fmt, layout, Dh=Dh)
        assert (out - ref).abs().max() <= 1e-5


def _prefill_case(dev, fmt, C, starts, short=None, window=0, P=64, maxp=32,
                  H=14, kvh=2, Dh=64, seed=8):
    """(kernel outputs, plain outputs, call) of a chunk of C rows per lane at
    ``starts`` over a pool of P-row pages, each lane's table slots
    scattered over the pool (slots past its fill on the scrap page 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, D = len(starts), kvh * Dh
    n_pages = 1 + B * maxp
    kc, ks = kv_encode(torch.randn(n_pages, P, D, generator=g, device=dev),
                       fmt)
    vc, vs = kv_encode(torch.randn(n_pages, P, D, generator=g, device=dev),
                       fmt)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    kl = st + C - torch.tensor(short or [0] * B, dtype=torch.int32,
                               device=dev)
    bt = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).reshape(
        B, maxp).to(torch.int32)
    for b, s in enumerate(starts):
        bt[b, -(-(s + C) // P):] = 0
    q = torch.randn(B, C, H, Dh, generator=g, device=dev)
    kd = torch.randn(B, C, D, generator=g, device=dev)
    vd = torch.randn(B, C, D, generator=g, device=dev)
    args = (q, kd, vd, kc, ks, vc, vs, bt, st, kl, fmt)

    def call():
        return tops.mx_flash_prefill(*args, window=window)
    return call(), tref.mx_prefill_ref(*args, window=window), call


def _prefill_close(outs, refs):
    assert (outs[0] - refs[0]).abs().max() <= 1e-4
    for a, b in zip(outs[1:], refs[1:]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("mxfp8", "mxint8", "mxfp4", "mxint4"))
@pytest.mark.parametrize("case", ("full", "window", "ragged"))
def test_cuda_prefill_on_64_row_pages(cuda_device, fmt, case):
    """The flash-prefill on 64-row pages (the engine's page at attn_chunk
    64) through 32-slot scattered tables, G = 7: whole 1024-row chunks over
    prefixes of 0 to 1024 rows (one mid-page); a 300-key window; a 77-row
    chunk at mid-page starts with fills short of the chunk's end. Within
    1e-4 of the plain version, chunk bytes equal to kv_encode, two calls
    bitwise equal."""
    C, starts, short, window = {
        "full": (1024, [0, 1024, 640, 337], None, 0),
        "window": (512, [0, 900, 333], None, 300),
        "ragged": (77, [5, 1100, 205], [0, 3, 40], 0)}[case]
    outs, refs, call = _prefill_case(cuda_device, fmt, C, starts, short,
                                     window)
    _prefill_close(outs, refs)
    assert torch.equal(outs[0], call()[0])


@pytest.mark.gpu
@pytest.mark.parametrize("Dh,H,kvh", ((16, 8, 2), (32, 4, 4), (64, 28, 1),
                                      (80, 4, 2), (96, 12, 2), (112, 4, 2),
                                      (128, 128, 1)))
def test_cuda_prefill_head_shapes(cuda_device, Dh, H, kvh):
    """Heads narrower than the 64-wide operand row (Dh = 16, the reduced
    Qwen2 config's; 32), one head per KV head (G = 1, 128 positions a block)
    and 28 (4 positions a block), on 32-row pages (two a key tile); heads
    between 64 and 128 wide (a part-filled second panel), and 128 heads of
    128 over one KV head (G = 128: a position's heads span two 64-row
    blocks)."""
    for fmt in ("mxfp8", "mxfp4"):
        outs, refs, _ = _prefill_case(cuda_device, fmt, 100, [0, 70, 13],
                                      P=32, maxp=8, H=H, kvh=kvh, Dh=Dh)
        _prefill_close(outs, refs)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("mxfp8", "mxint8", "mxfp4", "mxint4"))
@pytest.mark.parametrize("case", ("full", "window", "ragged"))
@pytest.mark.parametrize("P,maxp", ((1024, 2), (64, 32), (32, 64)))
@pytest.mark.parametrize("H,kvh", ((28, 4), (64, 8)))
def test_cuda_prefill_at_head_dim_128(cuda_device, H, kvh, P, maxp, case,
                                      fmt):
    """Heads of 128 (two 64-feature operand panels, 64 rows a block, 64-key
    stages): Qwen2-7B's G = 7 and DeepSeek-67B's G = 8, on 1024-, 64- and
    32-row pages through scattered tables, whole 1024-row chunks over
    prefixes of 0 to 1024 rows (one mid-page), a 300-key window, 77-row
    chunks at mid-page starts with fills short of the chunk's end. Within
    1e-4 of the plain version, chunk bytes equal to kv_encode, two calls
    bitwise equal."""
    C, starts, short, window = {
        "full": (1024, [0, 1024, 640, 337], None, 0),
        "window": (512, [0, 900, 333], None, 300),
        "ragged": (77, [5, 1100, 205], [0, 3, 40], 0)}[case]
    outs, refs, call = _prefill_case(cuda_device, fmt, C, starts, short,
                                     window, P=P, maxp=maxp, H=H, kvh=kvh,
                                     Dh=128)
    _prefill_close(outs, refs)
    assert torch.equal(outs[0], call()[0])


@pytest.mark.gpu
def test_cuda_prefill_refuses_heads_wider_than_128(cuda_device):
    """Dh = 256 does not fit the kernel's two operand panels: the wrapper
    raises (no plain-version fallback on the card)."""
    dev = cuda_device
    kc, ks = kv_encode(torch.randn(3, 32, 256, device=dev))
    x = torch.randn(1, 8, 256, device=dev)
    bt = torch.ones(1, 2, dtype=torch.int32, device=dev)
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        tops.mx_flash_prefill(torch.randn(1, 8, 2, 256, device=dev), x, x,
                              kc, ks, kc, ks, bt, st, st + 8)


# ---------------------------------------------------------------------------
# Sampling and speculative decoding on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_threefry_on_the_card_equals_the_cpu(cuda_device):
    """Keys, random bits and uniforms of 4096 (seed, step, channel)
    triples: bitwise the CPU's integers."""
    from repro_torch.serving import sampling
    g = torch.Generator().manual_seed(3)
    trip = (torch.randint(0, 2 ** 32, (4096,), generator=g),
            torch.randint(0, 1 << 20, (4096,), generator=g),
            torch.randint(0, 2, (4096,), generator=g))
    out = {}
    for dev in ("cpu", cuda_device):
        k = sampling._key(*(t.to(dev) for t in trip))
        out[str(dev)] = (k[0], k[1], sampling.random_bits(k, 100),
                         sampling.uniform(k).view(torch.int32))
    for a, b in zip(out[str(cuda_device)], out["cpu"]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("temp,top_k,top_p", ((1.0, 0, 1.0), (0.8, 50, 0.95),
                                              (0.6, 0, 0.5)))
def test_sample_tokens_on_the_card_equal_the_cpu(cuda_device, temp, top_k,
                                                 top_p):
    """sample_tokens over 256 lanes of a 4096-token vocabulary (one lane
    greedy): the card draws the CPU's tokens; the two ``log``s may part by
    an ulp, so the gumbel noise is also held within 4 ulps of 16."""
    from repro_torch.serving import sampling
    g = torch.Generator().manual_seed(4)
    B, V = 256, 4096
    lg = torch.randn(B, V, generator=g) * 3.0
    temps = torch.full((B,), temp)
    temps[1] = 0.0
    args = (temps, torch.full((B,), top_k), torch.full((B,), top_p),
            torch.randint(0, 2 ** 31, (B,), generator=g),
            torch.randint(0, 4096, (B,), generator=g))
    cpu = sampling.sample_tokens(lg, *args)
    card = sampling.sample_tokens(lg.to(cuda_device),
                                  *(a.to(cuda_device) for a in args))
    assert torch.equal(card.cpu(), cpu)
    key = sampling.prng_key(args[3])
    noise = sampling.gumbel(key, V)
    noise_card = sampling.gumbel(tuple(t.to(cuda_device) for t in key), V)
    assert (noise_card.cpu() - noise).abs().max() <= 4 * 2.0 ** -20


def _small_mx_model(dev, path):
    """A 4-layer model of Qwen2-0.5B's head layout (14 heads over 2 KV
    heads of 64) at d_model 896, random weights, RTN mxfp4 with T3,
    exported to ``path`` and loaded packed, as the engine serves it."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts import export_artifact, load_artifact
    from repro_torch.core import ptq
    from repro_torch.models import transformer
    cfg = dataclasses.replace(configs.get("qwen2-0.5b"), n_layers=4,
                              d_ff=1024, vocab_size=4096, attn_chunk=128)
    gen = torch.Generator(device=dev).manual_seed(5)
    res = ptq.apply_method("rtn", transformer.init(gen, cfg, device=dev),
                           cfg, fmt="mxfp4")
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    export_artifact(res, cfg, path)
    params, _, qm = load_artifact(path, device=dev)
    return params, cfg, qm.with_backend("fused")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("contiguous", "paged"))
@pytest.mark.parametrize("k", (3, 4))
def test_verify_against_sequential_decode(cuda_device, tmp_path, k,
                                          layout):
    """Teacher-forced, fused: four lanes' prompts prefilled, then the same
    k + 1 tokens per lane through k + 1 decode steps and through one verify
    step (the packed GEMM at M = 16 or 20, one launch per linear): logits
    within 1e-2 of max |logit|."""
    from repro_torch.core.quantize import KVCacheQuant
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    dev = cuda_device
    params, cfg, qm = _small_mx_model(dev, tmp_path / "art")
    kvq = KVCacheQuant.parse("mxfp8")
    B, S, C = 4, 100, cfg.attn_chunk
    g = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (B, C), generator=g, device=dev,
                         dtype=torch.int32)
    forced = torch.randint(0, cfg.vocab_size, (B, k + 1), generator=g,
                           device=dev, dtype=torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    bt = torch.arange(1, B + 1, dtype=torch.int32, device=dev)[:, None]

    def prefilled():
        if layout == "paged":
            cache = tr.init_cache_paged(cfg, B + 1, 128, kv_quant=kvq,
                                        device=dev)
            return tr.prefill_chunk_paged(
                params, cfg, cache, bt, toks, 0,
                torch.full((B,), S - 1, device=dev), qm)[1]
        cache = tr.init_cache(cfg, B, 256, kv_quant=kvq, device=dev)
        return tr.prefill_chunk(params, cfg, cache, toks, 0, S - 1, qm)[1]

    cache = prefilled()
    seq = []
    for j in range(k + 1):
        p = (pos + j).to(dev)
        if layout == "paged":
            lg, cache = tr.decode_paged(params, cfg, cache, forced[:, j], p,
                                        bt, qm)
        else:
            lg, cache = tr.decode(params, cfg, cache, forced[:, j], p, qm)
        seq.append(lg)
    seq = torch.stack(seq, dim=1)
    cache = prefilled()
    nv = torch.full((B,), k + 1, dtype=torch.int32)
    ops.reset_launches()
    if layout == "paged":
        ver, _ = tr.verify_paged(params, cfg, cache, forced, pos, nv, bt, qm)
    else:
        ver, _ = tr.verify(params, cfg, cache, forced, pos, nv, qm)
    assert ops.launches["mx_gemm_packed"] == 7 * cfg.n_layers
    assert ops.launches["mx_flash_decode"] == 0
    assert ops.launches["mx_flash_decode_paged"] == 0
    assert (ver - seq).abs().max() <= 1e-2 * seq.abs().max()


@pytest.mark.gpu
def test_ste_quantizer_on_the_card_matches_the_cpu(cuda_device):
    """The straight-through MX quantizer of the PTQ student on the card:
    its forward bit for bit the CPU's in every format (NVFP4 included),
    its gradient the identity."""
    from repro_torch.core import mx
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 896, generator=g) * 3
    for c in [*(mx.MXConfig(fmt=f) for f in MX_FMTS), mx.NVFP4]:
        xd = x.to(cuda_device).requires_grad_(True)
        q = mx.quantize(xd, c)
        assert torch.equal(q.detach().cpu(), mx.quantize(x, c))
        w = torch.randn(x.shape, generator=g).to(cuda_device)
        (grad,) = torch.autograd.grad((q * w).sum(), xd)
        assert torch.equal(grad, w)


# ---------------------------------------------------------------------------
# The zoo's shapes: DeepSeek-67B (64 heads over 8 KV heads of 128, K = 8192
# and 22016), InternVL2-26B (48 over 8: G = 6), HuBERT-XLarge (K = 1280 and
# 5120), and the Trainer's exact resume on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,t3", ((4, 1280, 5120, False),
                                      (6000, 1280, 5120, False),
                                      (6000, 5120, 1280, True),
                                      (4, 22016, 8192, True),
                                      (1024, 22016, 8192, True)))
def test_cuda_gemm_at_the_zoo_widths(cuda_device, M, K, N, t3):
    x, pw = _gemm_operands(cuda_device, M, K, N, "mxfp4", 9)
    y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0, t3=t3)
    yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0,
                                   t3=t3)
    assert y.shape == (M, N)
    assert (y - yp).abs().max() <= 1e-4 * yp.abs().max()


def _decode_heads(dev, layout, H, kvh, Dh, fmt, seed=12):
    """Both flash decodes over four lanes filled to [1330, 1180, 250, 140]
    of 2048 rows (paged: 64-row pages, scattered) at H over kvh heads of
    Dh; returns (kernel, plain)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fills, S, D = [1330, 1180, 250, 140], 2048, kvh * Dh
    B = len(fills)
    kl = torch.tensor(fills, dtype=torch.int32, device=dev)
    q = torch.randn(B, H, Dh, generator=g, device=dev)
    if layout == "contiguous":
        kc, ks = kv_encode(torch.randn(B, S, D, generator=g, device=dev),
                           fmt)
        vc, vs = kv_encode(torch.randn(B, S, D, generator=g, device=dev),
                           fmt)
        args = (q, kc, ks, vc, vs, kl - 1, kl, fmt)
        return tops.mx_flash_decode(*args), tref.mx_attention_ref(*args)
    P, maxp = 64, S // 64
    n_pages = 1 + B * maxp
    kc, ks = kv_encode(torch.randn(n_pages, P, D, generator=g, device=dev),
                       fmt)
    vc, vs = kv_encode(torch.randn(n_pages, P, D, generator=g, device=dev),
                       fmt)
    bt = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).reshape(
        B, maxp).to(torch.int32)
    args = (q, kc, ks, vc, vs, bt, kl - 1, kl, fmt)
    return (tops.mx_flash_decode_paged(*args),
            tref.mx_attention_paged_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("mxfp8", "mxfp4"))
@pytest.mark.parametrize("layout,H,kvh", (("paged", 64, 8),
                                          ("contiguous", 64, 8),
                                          ("contiguous", 48, 8),
                                          ("paged", 48, 8)))
def test_cuda_decode_at_the_zoo_heads(cuda_device, layout, H, kvh, fmt):
    """The flash decodes at DeepSeek-67B's G = 8 and InternVL2-26B's G = 6,
    heads of 128."""
    out, ref = _decode_heads(cuda_device, layout, H, kvh, 128, fmt)
    assert (out - ref).abs().max() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("mxfp8", "mxfp4"))
def test_cuda_prefill_at_deepseek_heads(cuda_device, fmt):
    """The flash prefill at G = 8, heads of 128, on 1024-row pages (the
    engine's page at attn_chunk 1024)."""
    outs, refs, _ = _prefill_case(cuda_device, fmt, 256, [0, 1024, 300, 7],
                                  P=1024, maxp=2, H=64, kvh=8, Dh=128)
    _prefill_close(outs, refs)


@pytest.mark.gpu
def test_trainer_resume_is_exact_on_the_card(cuda_device, tmp_path):
    """A reduced Qwen2-0.5B (bf16 parameters, remat) trained 8 steps, and
    again with a failure at step 6 resumed from the step-4 checkpoint: the
    resumed losses and the final parameters equal the uninterrupted run's
    bit for bit (the Trainer runs its steps under deterministic
    algorithms)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(configs.get_reduced("qwen2-0.5b"),
                              dtype="bfloat16", remat=True)

    def trainer(d):
        return Trainer(cfg, TrainConfig(
            steps=8, batch_size=8, seq_len=128, ckpt_every=4,
            ckpt_dir=str(d), log_every=1,
            opt=opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)),
            device=cuda_device, log=lambda *_: None)
    a = trainer(tmp_path / "a")
    a.train()
    b = trainer(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected failure"):
        b.train(fail_at=6)
    b2 = trainer(tmp_path / "b")
    b2.train()
    la = {m["step"]: m["loss"] for m in a.metrics}
    assert [m["loss"] for m in b2.metrics] == [la[s] for s in range(5, 9)]
    for x, y in zip(opt.tree_leaves(a.params), opt.tree_leaves(b2.params)):
        assert torch.equal(x, y)


# The recurrent families. Mamba2-130M's in_proj, (768, 3352): N is no
# multiple of 16, so the small-M kernel (M = 4, a decode step of 4 lanes)
# and the tile (M = 300) stage the weight byte by byte.

@pytest.mark.gpu
@pytest.mark.parametrize("M", (4, 300))
def test_cuda_gemm_mamba2_in_proj(cuda_device, M):
    x, pw = _gemm_operands(cuda_device, M, 768, 3352, "mxfp4", 21)
    y = tops.mx_gemm_packed(x, pw.codes_packed, pw.scales_e8m0)
    yp = tref.mx_matmul_packed_ref(x, pw.codes_packed, pw.scales_e8m0)
    assert y.shape == (M, 3352)
    assert (y - yp).abs().max() <= 1e-4 * yp.abs().max()
    assert torch.equal(y, tops.mx_gemm_packed(x, pw.codes_packed,
                                              pw.scales_e8m0))


def _recurrent_model(name, **cut):
    """RTN mxfp4 (T3 on) of a seeded init at the config's widths, cut as
    asked: (packed params on the CPU, cfg, fused quant mode)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.artifacts.store import pack_params
    from repro_torch.core import ptq
    from repro_torch.models import api
    cfg = dataclasses.replace(configs.get(name), dtype="float32", **cut)
    res = ptq.apply_method("rtn", api.init(
        torch.Generator().manual_seed(5), cfg, device="cpu"), cfg)
    qm = dataclasses.replace(res.qm, t3_block=32, backend="fused")
    return pack_params(res), cfg, qm


def _to(tree, dev):
    from repro_torch import devices
    return devices.tree_to(tree, dev)


def _close(got, want):
    """The MX-tie bar: an f32 sum an ulp to the other side of a snap moves
    one code of an activation block."""
    want = want.float()
    assert (got.float().cpu() - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.gpu
def test_cuda_griffin_decode_past_the_ring_wrap(cuda_device):
    """RecurrentGemma-2B's widths at one super-block (no tail): prefill 40
    tokens into a 32-slot mxfp8 ring (window cut to 32), then a decode step
    that writes past the wrap; the card's logits (GEMMs through the kernel)
    against the CPU's plain versions."""
    from repro_torch.core.quantize import KVCacheQuant
    from repro_torch.models import griffin
    params, cfg, qm = _recurrent_model("recurrentgemma-2b", n_layers=3,
                                       window=32, vocab_size=4096)
    toks = torch.randint(0, cfg.vocab_size, (4, 41),
                         generator=torch.Generator().manual_seed(6))
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        p = _to(params, dev)
        with torch.no_grad():
            _, cache = griffin.prefill(p, cfg, toks[:, :40].to(dev), qm,
                                       max_len=64,
                                       kv_quant=KVCacheQuant("mxfp8"))
            assert cache["attn_k"].shape == (1, 4, 32, cfg.kv_dim)
            tops.reset_launches()
            out.append(griffin.decode(p, cfg, cache, toks[:, 40].to(dev), 40,
                                      qm)[0])
        if dev.type == "cuda":
            assert tops.launches["mx_gemm_packed"] == 19
    _close(out[1], out[0])


@pytest.mark.gpu
def test_cuda_mamba2_block_decode(cuda_device):
    """One Mamba2-130M block at its widths (in_proj 768 -> 3352 through the
    byte-staged route, out_proj 1536 -> 768) decoding one token from a
    nonzero state, card against the CPU's plain versions."""
    from repro_torch.models import ssd
    params, cfg, qm = _recurrent_model("mamba2-130m", n_layers=1,
                                       vocab_size=4096)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(4, 1, cfg.d_model, generator=g)
    st = torch.randn(4, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                     generator=g) * 0.1
    conv = torch.randn(4, cfg.conv_dim, cfg.conv_kernel - 1, generator=g)
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        p = {k: v[0] for k, v in _to(params, dev)["blocks"].items()}
        with torch.no_grad():
            out.append(ssd.block_decode(x.to(dev), p, cfg, qm, st.to(dev),
                                        conv.to(dev)))
    for a, b in zip(out[1], out[0]):
        _close(a, b)


@pytest.mark.gpu
def test_cuda_serve_step_under_a_mesh(cuda_device, tmp_path):
    """Phase 11 (c) at a reduced size: a packed RTN mxfp4 tree (T3, fused,
    mxfp8 cache) through ``make_prefill_step`` and 8 ``make_serve_step``
    steps, without a mesh and under a one-rank (1, 1) NCCL mesh: tokens
    equal, and every kernel launch under the mesh through the replicated
    route (``ops.on_whole``), as many as without it."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.artifacts.store import pack_params
    from repro_torch.core import ptq
    from repro_torch.core.quantize import KVCacheQuant
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import pcontext as pctx
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    dev = cuda_device
    cfg = configs.get_reduced("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = ptq.apply_method("rtn", transformer.init(gen, cfg, device=dev),
                           cfg, fmt="mxfp4")
    qm = dataclasses.replace(res.qm, t3_block=32, backend="fused")
    params = pack_params(res)
    S, n = 40, 8
    inp = torch.randint(0, cfg.vocab_size, (4, S), generator=gen,
                        device=dev)
    prefill = steps.make_prefill_step(cfg, qm, max_len=S + n + 1,
                                      kv_quant=KVCacheQuant.parse("mxfp8"))
    serve = steps.make_serve_step(cfg, qm)

    def run(params, inputs, place):
        tops.reset_launches()
        tok, cache = prefill(params, inputs)
        cache = place(cache)
        toks = [tok]
        for i in range(n):
            tok, cache = serve(params, cache, tok, S + i)
            toks.append(tok)
        toks = [t.full_tensor() if pctx.is_dtensor(t) else t for t in toks]
        return torch.stack(toks), dict(tops.launches), dict(tops.quant_paths)

    want, launches, _ = run(params, inp, lambda c: c)
    mesh_lib.init_distributed(store=dist.FileStore(str(tmp_path / "s"), 1),
                              world_size=1, rank=0, device="cuda")
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        with pctx.activate(mesh, batch_axes=("data",), model_axis="model"):
            got, mesh_launches, paths = run(
                sh.distribute(params, sh.params_shardings(params, cfg,
                                                          "serve", mesh)),
                sh.distribute_leaf(inp, sh.NamedSharding(
                    mesh, sh.Spec("data", None))),
                lambda c: sh.distribute(c, sh.cache_shardings(c, cfg, 4,
                                                              mesh)))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    for k in ("mx_gemm_packed", "mx_flash_decode"):
        assert mesh_launches[k] == launches[k] > 0
        assert paths[(k, "replicated", "")] == launches[k]
