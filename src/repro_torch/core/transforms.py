"""Invertible affine transformations for outlier diffusion (Section 3.2) —
the port of ``repro.core.transforms``.

Row convention: activations are rows, ``T(X) = X @ A + v`` with
``A in R^{d x d}``; ``T^{-1}(Y) = (Y - v) @ A^{-1}``.

  LU (Eq. 5):  A = P · L · (U + diag(s))       — P fixed permutation,
               L unit-lower-triangular, U strictly-upper, s = sign ⊙ e^{logs}
  QR (Eq. 6):  A = exp(½(G − Gᵀ)) · (R + diag(s))

plus the restricted families of the baselines: orthogonal-only (learn G;
R = 0, s = 1 fixed), invertible-only (LU, no bias), orthogonal × learned
diagonal ('orth_scale'), a fixed random or block Hadamard, the identity,
and a Kronecker product of two small matrices ('kron').

Parameters are nested dicts of tensors with a ``learn`` and a ``fixed``
subtree, as in the JAX package. The random draws are ``jax.random``'s
(``core/prng.py``); the LU, QR and matrix log of the initial matrix run in
float64 on the host (numpy, scipy), as there. :func:`materialize` and the
regularizers take parameters with any leading axes (layers, blocks), so the
stacked T2 trees need no vmap.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import prng

Params = dict

# kinds that the block granularity restricts to block-diagonal learnables
_BLOCKABLE = ("lu", "qr", "orthogonal", "invertible", "orth_scale")


# ---------------------------------------------------------------------------
# Hadamard / orthogonal constructions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    """Sylvester construction, cached."""
    if n & (n - 1) != 0:
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(n)


def hadamard_matrix(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Sylvester-ordered Hadamard matrix, scaled to be orthogonal."""
    return torch.as_tensor(_hadamard_np(n), dtype=dtype, device=device)


def apply_blockwise(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Multiply the last axis of x by blockdiag(h): x (..., d), h (b, b).

    The products of f32 values with f32 matrix entries are exact in
    float64, so the block sums are accumulated there and rounded once to
    x's dtype. That pins the rotated value independently of summation
    order, which is what keeps this plain version and the CUDA kernels'
    T3 (an exact f64 butterfly, rounded once; tests/test_torch_gemm_tile.py
    holds the two equal) on the same side of every snap midpoint."""
    b = h.shape[0]
    *lead, d = x.shape
    xb = x.reshape(*lead, d // b, b).double()
    yb = xb @ h.to(torch.float32).double()
    return yb.reshape(*lead, d).to(x.dtype)


def random_hadamard(key, n: int, dtype=torch.float32) -> torch.Tensor:
    """H · diag(random ±1): a random orthogonal matrix with Hadamard
    incoherence (QuIP#/QuaRot construction)."""
    signs = prng.rademacher(key, (n,), dtype)
    return hadamard_matrix(n, dtype, signs.device) * signs[None, :]


def random_orthogonal(key, n: int, dtype=torch.float32) -> torch.Tensor:
    """Haar-random orthogonal via QR of a Gaussian."""
    g = prng.normal(key, (n, n))
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.to(dtype)


def block_diagonal(blocks: torch.Tensor) -> torch.Tensor:
    """(..., nb, b, b) stack -> (..., nb*b, nb*b) block-diagonal matrix."""
    *lead, nb, b, _ = blocks.shape
    eye = torch.eye(nb, dtype=blocks.dtype, device=blocks.device)
    full = torch.einsum("ij,...ibc->...ibjc", eye, blocks)
    return full.reshape(*lead, nb * b, nb * b)


def block_diag_init(key, d: int, block: int, kind: str = "hadamard",
                    noise: float = 1e-3, dtype=torch.float32) -> torch.Tensor:
    """Block-diagonal rotation init + small off-block Gaussian noise
    (Appendix E.2: BD Hadamard + Noise / BD Orthogonal + Noise)."""
    nb = d // block
    keys = prng.split(key, nb + 1)
    dev = key[0].device
    if kind == "hadamard":
        blocks = torch.stack([random_hadamard(keys[i], block, dtype)
                              for i in range(nb)])
    elif kind == "orthogonal":
        blocks = torch.stack([random_orthogonal(keys[i], block, dtype)
                              for i in range(nb)])
    elif kind == "identity":
        blocks = torch.eye(block, dtype=dtype, device=dev)[None].repeat(
            nb, 1, 1)
    else:
        raise ValueError(kind)
    a = block_diagonal(blocks)
    if noise > 0:
        off = prng.normal(keys[-1], (d, d), dtype) * noise
        mask = 1.0 - block_diagonal(
            torch.ones((nb, block, block), dtype=dtype, device=dev))
        a = a + off * mask
    return a


# ---------------------------------------------------------------------------
# Parameterizations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """What family of transformation to learn (fields as in the JAX
    package): ``kind`` 'lu' | 'qr' | 'orthogonal' | 'invertible' |
    'orth_scale' | 'hadamard' | 'block_hadamard' | 'identity' | 'kron';
    ``d`` the dimension; ``learn_bias`` the affine shift v; ``block`` the MX
    block; ``init`` 'bd_hadamard' | 'bd_orthogonal' | 'identity' |
    'hadamard' | 'orthogonal'; ``granularity`` 'full' | 'block'
    (block-diagonal learnables, Table 2)."""

    kind: str = "lu"
    d: int = 0
    learn_bias: bool = True
    block: int = 32
    init: str = "bd_hadamard"
    init_noise: float = 1e-3
    granularity: str = "full"


def _init_matrix(key, spec: TransformSpec) -> torch.Tensor:
    d, b = spec.d, min(spec.block, spec.d)
    if spec.init == "bd_hadamard":
        return block_diag_init(key, d, b, "hadamard", spec.init_noise)
    if spec.init == "bd_orthogonal":
        return block_diag_init(key, d, b, "orthogonal", spec.init_noise)
    if spec.init == "identity":
        return block_diag_init(key, d, b, "identity", spec.init_noise)
    if spec.init == "hadamard":
        return random_hadamard(key, d)
    if spec.init == "orthogonal":
        return random_orthogonal(key, d)
    raise ValueError(spec.init)


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def init_params(key, spec: TransformSpec) -> Params:
    """Learnable parameters (under 'learn') and fixed buffers (under
    'fixed') for ``spec``, on the key's device."""
    d = spec.d
    dev = key[0].device
    if spec.granularity == "block" and spec.kind in _BLOCKABLE:
        nb = d // spec.block
        sub = dataclasses.replace(spec, d=spec.block, granularity="full",
                                  init=spec.init.replace("bd_", ""))
        keys = prng.split(key, nb)
        stacked = stack_trees([init_params(keys[i], sub) for i in range(nb)])
        if spec.learn_bias:
            # one full-width bias (cheap; block-local A)
            stacked["learn"]["v_full"] = torch.zeros(d, device=dev)
        return stacked
    k_mat, _ = prng.split(key)

    if spec.kind in ("hadamard", "identity"):
        a0 = (random_hadamard(k_mat, d) if spec.kind == "hadamard"
              else torch.eye(d, device=dev))
        return {"learn": {}, "fixed": {"A": a0}}

    if spec.kind == "block_hadamard":
        a0 = block_diag_init(k_mat, d, min(spec.block, d), "hadamard", 0.0)
        return {"learn": {}, "fixed": {"A": a0}}

    if spec.kind == "kron":
        # FlatQuant structure: A = A1 ⊗ A2 with d = d1*d2, d1,d2 ~ sqrt(d)
        d1 = _near_sqrt_factor(d)
        learn = {"K1": torch.eye(d1, device=dev),
                 "K2": torch.eye(d // d1, device=dev)}
        fixed = {}
    else:
        a0 = _init_matrix(k_mat, spec).cpu().double().numpy()
        learn, fixed = _factor(a0, spec, dev)
    if spec.learn_bias:
        learn["v"] = torch.zeros(d, device=dev)
    return {"learn": learn, "fixed": fixed}


def _factor(a0: np.ndarray, spec: TransformSpec, dev):
    """LU or QR factors of the float64 initial matrix (scipy, host)."""
    import scipy.linalg as sla
    d = spec.d
    if spec.kind in ("lu", "invertible"):
        p, l, u = sla.lu(a0)
        s = np.diagonal(u).copy()
        learn = {"L": _f32(np.tril(l, -1), dev), "U": _f32(np.triu(u, 1), dev),
                 "logs": _f32(np.log(np.abs(s) + 1e-12), dev)}
        fixed = {"perm": torch.as_tensor(np.argmax(p, axis=1),
                                         dtype=torch.int32, device=dev),
                 "sign": _f32(np.sign(s), dev)}
        return learn, fixed
    if spec.kind not in ("qr", "orthogonal", "orth_scale"):
        raise ValueError(spec.kind)
    q, r = np.linalg.qr(a0)
    # det(q) = +1 so the real matrix log exists and is skew
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1.0
        r[0, :] *= -1.0
    g = np.real(sla.logm(q))
    g = g - g.T           # exact skew; materialize uses exp(0.5(G - G^T))
    s = np.diagonal(r).copy()
    learn = {"G": _f32(g, dev)}
    fixed = {"sign": _f32(np.sign(s), dev)}
    if spec.kind == "qr":
        learn["R"] = _f32(np.triu(r, 1), dev)
        learn["logs"] = _f32(np.log(np.abs(s) + 1e-12), dev)
    elif spec.kind == "orth_scale":
        # OSTQuant-style: orthogonal Q × learned diagonal scaling
        fixed["R"] = torch.zeros((d, d), device=dev)
        learn["logs"] = torch.zeros(d, device=dev)
        fixed["sign"] = torch.ones(d, device=dev)
    else:                 # orthogonal-only: R = 0, s = 1 fixed
        fixed["R"] = torch.zeros((d, d), device=dev)
        fixed["logs"] = torch.zeros(d, device=dev)
        fixed["sign"] = torch.ones(d, device=dev)
    return learn, fixed


def _near_sqrt_factor(d: int) -> int:
    best = 1
    for f in range(1, int(np.sqrt(d)) + 1):
        if d % f == 0:
            best = f
    return best


def stack_trees(trees: list):
    """Stack same-shaped nested dicts of tensors along a new leading
    axis (``jax.tree.map(jnp.stack)``)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``kron`` over the last two axes, batched over the leading ones."""
    *lead, m, n = a.shape
    p, q = b.shape[-2:]
    return torch.einsum("...ij,...kl->...ikjl", a, b).reshape(
        *lead, m * p, n * q)


def materialize(params: Params, spec: TransformSpec):
    """Build (A, v) from parameters; differentiable. Leaves may carry
    leading axes (a stack of layers), which A and v keep."""
    learn, fixed = params["learn"], params["fixed"]
    d = spec.d
    if spec.granularity == "block" and spec.kind in _BLOCKABLE:
        sub = dataclasses.replace(spec, d=spec.block, granularity="full")
        inner = {"learn": {k: v for k, v in learn.items() if k != "v_full"},
                 "fixed": fixed}
        blocks, _ = materialize(inner, sub)        # (..., nb, b, b)
        v_full = learn.get("v_full")
        if v_full is None:
            v_full = blocks.new_zeros(blocks.shape[:-3] + (d,))
        return block_diagonal(blocks), v_full

    if spec.kind in ("hadamard", "identity", "block_hadamard"):
        a = fixed["A"]
    elif spec.kind in ("lu", "invertible"):
        eye = torch.eye(d, device=learn["L"].device)
        l = torch.tril(learn["L"], -1) + eye
        s = fixed["sign"] * torch.exp(learn["logs"])
        u = torch.triu(learn["U"], 1) + torch.diag_embed(s)
        perm = fixed["perm"].long()
        # P @ (L @ U): a row permutation
        a = torch.take_along_dim(l @ u, perm[..., :, None], dim=-2)
    elif spec.kind in ("qr", "orthogonal", "orth_scale"):
        g = learn["G"]
        q = torch.linalg.matrix_exp(0.5 * (g - g.transpose(-1, -2)))
        r_off = learn.get("R", fixed.get("R"))
        logs = learn.get("logs", fixed.get("logs"))
        r = torch.triu(r_off, 1) + torch.diag_embed(
            fixed["sign"] * torch.exp(logs))
        a = q @ r
    elif spec.kind == "kron":
        a = _kron(learn["K1"], learn["K2"])
    else:
        raise ValueError(spec.kind)
    v = learn.get("v")
    if v is None:
        v = a.new_zeros(a.shape[:-1])
    return a, v


def per_matrix(fn, a: torch.Tensor) -> torch.Tensor:
    """``fn`` of each (n, n) matrix of a stack, one call per matrix: a
    batched LU (``inv``, ``slogdet``) of matrices a few hundred wide hangs
    on several CPU threads in some MKL builds of PyTorch."""
    if a.ndim == 2:
        return fn(a)
    mats = a.reshape(-1, *a.shape[-2:])
    return torch.stack([fn(m) for m in mats]).reshape(
        a.shape[:-2] + fn(mats[0]).shape)


def inverse(a: torch.Tensor) -> torch.Tensor:
    return per_matrix(torch.linalg.inv, a.float())


def loss_vol(params: Params, spec: TransformSpec) -> torch.Tensor:
    """Volume-preserving regularizer (Eq. 7, log form): (Σ_i log|s_i|)²,
    one per leading index."""
    learn = params["learn"]
    if "logs" in learn:
        logs = learn["logs"]
        if spec.granularity == "block" and spec.kind in _BLOCKABLE:
            logs = logs.flatten(-2)   # the blocks' s are one diagonal
        return logs.sum(dim=-1) ** 2
    if spec.kind == "kron":
        # |det(A1⊗A2)| = |det A1|^{d2} |det A2|^{d1}
        s1 = per_matrix(lambda m: torch.linalg.slogdet(m)[1], learn["K1"])
        s2 = per_matrix(lambda m: torch.linalg.slogdet(m)[1], learn["K2"])
        d1, d2 = learn["K1"].shape[-1], learn["K2"].shape[-1]
        return (d2 * s1 + d1 * s2) ** 2
    return torch.zeros(())


def diag_reg(params: Params) -> torch.Tensor:
    """Secondary regularizer (Appendix D.1): keep diag entries near one."""
    learn = params["learn"]
    if "logs" in learn:
        return torch.sum(learn["logs"] ** 2)
    return torch.zeros(())


# ---------------------------------------------------------------------------
# Application helpers
# ---------------------------------------------------------------------------

def forward(x: torch.Tensor, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T(x) = x @ A + v (rows)."""
    return x @ a.to(x.dtype) + v.to(x.dtype)


def backward(y: torch.Tensor, a_inv: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """T^{-1}(y) = (y - v) @ A^{-1}."""
    return (y - v.to(y.dtype)) @ a_inv.to(y.dtype)


def transform_mse(x: torch.Tensor, a: torch.Tensor, v: torch.Tensor,
                  mx_cfg) -> torch.Tensor:
    """Definition 3.2: E(T) = 1/d E||x − T⁻¹(Q(T(x)))||²."""
    from . import mx as mxlib
    q = mxlib.quantize(forward(x, a, v), mx_cfg, ste=False)
    back = backward(q, inverse(a), v)
    return torch.mean(torch.sum((x - back) ** 2, dim=-1) / x.shape[-1])


def orthogonality_deviation(a: torch.Tensor) -> torch.Tensor:
    """Fig. 3a metric: ||AᵀA − I||_σ."""
    m = a.T @ a - torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.linalg.matrix_norm(m, ord=2)


def offblock_norm(a: torch.Tensor, block: int) -> torch.Tensor:
    """Fig. 3b metric: spectral norm of A with the block diagonal zeroed."""
    nb = a.shape[0] // block
    mask = 1.0 - np.kron(np.eye(nb), np.ones((block, block)))
    return torch.linalg.matrix_norm(
        a * torch.as_tensor(mask, dtype=a.dtype, device=a.device), ord=2)
