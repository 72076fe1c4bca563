"""Per-lane token sampling and speculative-decoding acceptance — the port of
``repro.serving.sampling``, drawing the JAX package's random numbers bit
for bit.

- ``sample_tokens``: temperature / top-k / top-p sampling with a per-lane
  ``(seed, step)`` key. Divide by the temperature, keep the top-k logits,
  then keep the smallest sorted prefix with ``cum - prob <= top_p`` (the
  most likely token always survives). ``temperature <= 0`` takes the argmax
  of the raw logits, bitwise the greedy decode's token.
- ``spec_accept``: the leading-accepts rule of speculative sampling with a
  one-hot draft: draft ``x`` at slot ``j`` is accepted with probability
  ``min(1, p_j(x))``; the first rejection resamples from ``p_j`` with ``x``
  masked out, and a fully accepted run earns a bonus token. Greedy lanes
  accept iff the draft is the argmax.
- ``propose_ngram``: host-side prompt-lookup drafting (numpy).

Every draw comes from ``fold_in(fold_in(PRNGKey(seed), step), channel)``:
``step`` is the token's emission index, ``channel`` 0 the categorical draw
and 1 the acceptance uniform. The keys, the random bits (the partitionable
threefry scheme), ``uniform``, ``gumbel`` (its default low mode) and
``categorical`` (``argmax(logits + gumbel)``) are those of ``jax.random``,
computed here in ``int64`` tensors holding uint32 values (adds, xors and
rotations masked to 32 bits), so the integers are the same on the CPU and
on the card. Everything is vectorised over lanes and over the verify slots:
no Python loop runs per lane or per slot.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.prng import (fold_in, prng_key, random_bits,
                                   uniform_from_bits)

NEG_INF = -1e30  # the models' masking constant
_MIN_TEMP = 1e-4
_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs carried on ``Request.sampling``.

    ``temperature <= 0`` means greedy: top_k/top_p/seed are ignored and the
    decode is bit-identical to a request with no sampling at all.
    ``top_k == 0`` disables the top-k filter; ``top_p == 1.0`` the nucleus
    filter. ``seed`` makes the request replayable."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.seed < 0:
            raise ValueError(f"seed must be >= 0, got {self.seed}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


# ---------------------------------------------------------------------------
# jax.random's draws (the keys and bits are in core/prng.py)
# ---------------------------------------------------------------------------

def uniform(key: tuple) -> torch.Tensor:
    """One float32 uniform on [0, 1) per key (``jax.random.uniform(key)``)."""
    return uniform_from_bits(random_bits(key))


def gumbel(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` in its default low mode:
    ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    u = uniform_from_bits(random_bits(key, n), _F32_TINY)
    return -torch.log(-torch.log(u))


def _key(seeds, steps, channel: int) -> tuple:
    """The draw key of one (request, emission index, channel), batched."""
    return fold_in(fold_in(prng_key(seeds), steps), channel)


# ---------------------------------------------------------------------------
# Filtering, sampling, acceptance
# ---------------------------------------------------------------------------

def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in its order of operations."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _filter_logits(scaled: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Top-k then top-p masks on temperature-scaled rows (N, V); top_k,
    top_p (N,). Works in sorted-descending space (ties in index order, as
    ``jax.lax.top_k`` orders them) and scatters the keep-mask back."""
    V = scaled.shape[-1]
    sorted_l, sort_idx = torch.sort(scaled, dim=-1, descending=True,
                                    stable=True)
    rank = torch.arange(V, device=scaled.device)
    tk = top_k[:, None]
    drop_k = (tk > 0) & (rank[None, :] >= tk)
    probs = _softmax(torch.where(drop_k, NEG_INF, sorted_l))
    cum = torch.cumsum(probs, dim=-1)
    drop = drop_k | ((cum - probs) > top_p[:, None])
    keep = torch.zeros_like(drop).scatter_(-1, sort_idx, ~drop)
    return torch.where(keep, scaled, NEG_INF)


def _scaled(lf: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    t = torch.clamp_min(temps.float(), _MIN_TEMP)
    return lf / t.reshape(t.shape + (1,) * (lf.ndim - 1))


def sample_tokens(logits: torch.Tensor, temps, top_ks, top_ps, seeds,
                  steps) -> torch.Tensor:
    """One token per lane: logits (B, V); the rest (B,) tensors on the
    logits' device. Greedy lanes (temp <= 0) return the argmax of the raw
    logits. Returns (B,) int32."""
    V = logits.shape[-1]
    gtok = logits.argmax(dim=-1)
    filt = _filter_logits(_scaled(logits.float(), temps), top_ks, top_ps)
    g = gumbel(_key(seeds, steps, 0), V)
    stok = (g + filt).argmax(dim=-1)
    return torch.where(temps <= 0, gtok, stok).to(torch.int32)


def spec_accept(logits: torch.Tensor, drafts: torch.Tensor, n_drafts,
                temps, top_ks, top_ps, seeds, steps) -> tuple:
    """Vectorised speculative acceptance.

    logits (B, C, V): slot j conditioned on the current token plus
    drafts[:, :j]; drafts (B, K), K = C - 1; n_drafts (B,) real draft
    counts; the sampling vectors (B,), ``steps`` each lane's next emission
    index. Slot j draws with the key of emission index ``step + j``, as the
    non-spec path would. Returns (out (B, C) int32, n_emit (B,) int32,
    okrow (B, C) bool): the lane emits ``out[:n_emit]``."""
    B, C, V = logits.shape
    K = C - 1
    dev = logits.device
    greedy = (temps <= 0)[:, None]
    okrow = torch.isfinite(logits).all(dim=-1)
    iota_c = torch.arange(C, device=dev)
    gtok = logits.argmax(dim=-1)
    filt = _filter_logits(
        _scaled(logits.float(), temps).reshape(B * C, V),
        top_ks.repeat_interleave(C), top_ps.repeat_interleave(C)
    ).reshape(B, C, V)
    st = steps.long()[:, None]
    sd = seeds[:, None]
    g0 = gumbel(_key(sd, st + iota_c, 0), V)                 # (B, C, V)
    plain = torch.where(greedy, gtok, (g0 + filt).argmax(dim=-1))
    nd = torch.as_tensor(n_drafts, device=dev).long()
    if K:
        dr = drafts.long()
        u = uniform(_key(sd, st + iota_c[:K], 1))            # (B, K)
        p_x = torch.take_along_dim(_softmax(filt[:, :K]), dr[..., None],
                                   dim=-1)[..., 0]
        acc = (torch.where(greedy, gtok[:, :K] == dr, u < p_x)
               & (iota_c[None, :K] < nd[:, None]))
        # the residual of a one-hot proposal: the target with the draft
        # masked out, drawn with the plain draw's key (one of the two is
        # emitted for a step index), so it reuses the plain draw's noise
        onehot = torch.arange(V, device=dev) == dr[..., None]
        resamp = (g0[:, :K] + torch.where(onehot, NEG_INF, filt[:, :K])
                  ).argmax(dim=-1)
        rej = torch.cat([torch.where(greedy, gtok[:, :K], resamp),
                         plain[:, K:]], dim=1)
        m = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        pad = torch.cat([dr, dr.new_zeros((B, 1))], dim=1)
    else:
        rej = plain
        m = torch.zeros(B, dtype=torch.long, device=dev)
        pad = torch.zeros((B, 1), dtype=torch.long, device=dev)
    tok = torch.where((m < nd)[:, None], rej, plain)
    out = torch.where(iota_c[None, :] < m[:, None], pad, tok)
    return out.to(torch.int32), (m + 1).to(torch.int32), okrow


def propose_ngram(ctx, k, ngram_max=3, ngram_min=1):
    """Prompt-lookup draft: ``k`` tokens periodically extending the most
    recent earlier occurrence of the longest matching context-suffix
    n-gram. A hit at position ``i`` means the suffix recurred at distance
    ``p = L - n - i``, so the draft reads ``ctx[i + n + (t % p)]``,
    wrapping cyclically. Returns an int32 array of length 0 (no match) or
    ``k``."""
    ctx = np.asarray(ctx, dtype=np.int64).ravel()
    L = ctx.size
    if L < 2 or k <= 0:
        return np.zeros(0, np.int32)
    lo = max(int(ngram_min), 1)
    hi = min(int(ngram_max), L - 1)
    for n in range(hi, lo - 1, -1):
        pat = ctx[L - n:]
        win = np.lib.stride_tricks.sliding_window_view(ctx, n)
        hits = np.flatnonzero((win[:L - n] == pat).all(axis=1))
        if hits.size:
            i = int(hits[-1])
            p = L - n - i                      # implied period, >= 1
            t = np.arange(k)
            return ctx[i + n + (t % p)].astype(np.int32)
    return np.zeros(0, np.int32)
