"""Model API of the port, dispatching on ``cfg.family``: serving, the PTQ
folds and the losses.

Every family of the JAX package: ``dense``, ``encoder`` (causal off, no
decode path), ``vlm`` (no token embedding: a stub front end gives (B, S, d)
embeddings), ``moe``, ``hybrid`` (Griffin: RG-LRU and local attention
over a ring buffer) and ``ssm`` (Mamba2 SSD). The recurrent families have
no chunked-prefill, paged or verify step; those entry points raise for
them with the JAX package's messages, as ``prefill`` / ``init_cache`` with
``kv_quant`` do for ``ssm``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import QuantMode
from repro_torch.launch import pcontext as pctx

from . import griffin, moe, ssd, transformer

_FAMILY = {"dense": transformer, "encoder": transformer,
           "vlm": transformer, "moe": moe, "hybrid": griffin, "ssm": ssd}

_SSM_KV = ("ssm family has no attention KV cache to quantize; serve it "
           "with kv_cache='none'")
_NO_PAGED = ("family {!r} has no paged-cache step (recurrent ring-buffer "
             "state cannot be paged); serve it with kv_layout='contiguous'")
_NO_VERIFY = ("family {!r} has no multi-token verify step (recurrent state "
              "cannot rewind rejected drafts); serve it without speculative "
              "decoding")


def module_for(cfg: ArchConfig):
    return _FAMILY[cfg.family]


def _step(cfg: ArchConfig, name: str, message: str):
    """The family module's ``name``, or ValueError(message) where the
    family has none."""
    fn = getattr(module_for(cfg), name, None)
    if fn is None:
        raise ValueError(message.format(cfg.family))
    return fn


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None, place=None):
    """Seeded random parameters. ``place(name, leaf)`` lays out each leaf
    as it is made (``name`` its key; the trainer under a mesh keeps each
    rank's shard), the large ones before the next is drawn, so the whole
    tree never lives at once; the draws are the same either way."""
    if place is None:
        return module_for(cfg).init(gen, cfg, dtype, device)
    return _place(module_for(cfg).init(gen, cfg, dtype, device, place),
                  place)


def _place(tree, place, name: str = ""):
    """``place`` over the leaves a family's init left as they were made
    (the norms and biases; ``place`` keeps a laid-out leaf as it is)."""
    if isinstance(tree, dict):
        return {k: _place(v, place, k) for k, v in tree.items()}
    return place(name, tree)


def forward(params, cfg: ArchConfig, inputs,
            qm: QuantMode = QuantMode.off()):
    return module_for(cfg).forward(params, cfg, inputs, qm)


def prefill(params, cfg: ArchConfig, inputs,
            qm: QuantMode = QuantMode.off(), max_len: int | None = None,
            kv_quant=None):
    """Run the prompt, return (last logits, cache); ``kv_quant`` stores
    the cache MX-packed."""
    if cfg.family == "encoder":
        raise ValueError("encoder-only arch has no decode/prefill step")
    if kv_quant is not None and cfg.family == "ssm":
        raise ValueError(_SSM_KV)
    return module_for(cfg).prefill(params, cfg, inputs, qm, max_len=max_len,
                                   kv_quant=kv_quant)


def prefill_chunk(params, cfg: ArchConfig, cache, inputs, start: int,
                  last_idx: int, qm: QuantMode = QuantMode.off()):
    return _step(cfg, "prefill_chunk",
                 "family {!r} has no chunked-prefill step (recurrent state "
                 "caches); serve it with the wave scheduler")(
        params, cfg, cache, inputs, start, last_idx, qm)


def decode(params, cfg: ArchConfig, cache, inputs, cur_len,
           qm: QuantMode = QuantMode.off()):
    """One decode step; ``cur_len`` an int shared by the lanes or a (B,)
    tensor of per-lane fills."""
    if cfg.family == "encoder":
        raise ValueError("encoder-only arch has no decode step")
    return module_for(cfg).decode(params, cfg, cache, inputs, cur_len, qm)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, kv_quant=None, device=None):
    if kv_quant is not None and cfg.family == "ssm":
        raise ValueError(_SSM_KV)
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype,
                                      kv_quant=kv_quant, device=device)


def prefill_chunk_paged(params, cfg: ArchConfig, cache, block_tables,
                        inputs, start, last_idx,
                        qm: QuantMode = QuantMode.off()):
    return _step(cfg, "prefill_chunk_paged", _NO_PAGED)(
        params, cfg, cache, block_tables, inputs, start, last_idx, qm)


def decode_paged(params, cfg: ArchConfig, cache, inputs, cur_len,
                 block_tables, qm: QuantMode = QuantMode.off()):
    return _step(cfg, "decode_paged", _NO_PAGED)(
        params, cfg, cache, inputs, cur_len, block_tables, qm)


def init_cache_paged(cfg: ArchConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, kv_quant=None, device=None):
    return _step(cfg, "init_cache_paged",
                 "family {!r} has no paged-cache layout (recurrent "
                 "ring-buffer state cannot be paged); serve it with "
                 "kv_layout='contiguous'")(
        cfg, n_pages, page_size, dtype, kv_quant=kv_quant, device=device)


def verify(params, cfg: ArchConfig, cache, inputs, pos, n_valid,
           qm: QuantMode = QuantMode.off()):
    """Multi-token speculative verify step over the contiguous cache:
    per-slot next-token logits (B, C, V)."""
    return _step(cfg, "verify", _NO_VERIFY)(params, cfg, cache, inputs, pos,
                                            n_valid, qm)


def verify_paged(params, cfg: ArchConfig, cache, inputs, pos, n_valid,
                 block_tables, qm: QuantMode = QuantMode.off()):
    """Multi-token speculative verify step over a paged pool."""
    return _step(cfg, "verify_paged", _NO_VERIFY)(
        params, cfg, cache, inputs, pos, n_valid, block_tables, qm)


# ---------------------------------------------------------------------------
# PTQ folds
# ---------------------------------------------------------------------------

def fold_norms(params, cfg: ArchConfig):
    return module_for(cfg).fold_norms(params, cfg)


def fold(params, cfg: ArchConfig, tset):
    return module_for(cfg).fold(params, cfg, tset)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _whole_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Logits with the vocab axis whole on each rank (under a mesh the
    head leaves it sharded over "model"): DTensor's gather over a
    sharded axis (its masked partial) does not survive the reduction, so
    the CE all-gathers the vocab instead of GSPMD's vocab-parallel CE."""
    return pctx.shard(logits, "batch", *([None] * (logits.ndim - 1)))


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lf = _whole_vocab(logits.float())
    return (torch.logsumexp(lf, dim=-1)
            - torch.gather(lf, -1, labels.long()[..., None])[..., 0])


class _CEMean(torch.autograd.Function):
    """Mean token CE whose backward recomputes the f32 softmax from the
    saved logits, as the JAX package's custom VJP does: the (tokens ×
    vocab) f32 buffers stay transient, and the gradient is its formula,
    (softmax - onehot) * g / n in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return _nll(logits, labels).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return _ce_grad(logits, labels, g / labels.numel()), None


class _CETokens(torch.autograd.Function):
    """Per-token CE with :class:`_CEMean`'s backward: under a mesh each
    rank runs it on its own lanes (the vocab gathered), and the mean is
    taken over the ranks' tokens, so the gradient is the same formula
    with the same roundings."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return _nll(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return _ce_grad(logits, labels, g[..., None]), None


def _ce_grad(logits, labels, scale):
    """(softmax - onehot) * scale in the logits' dtype."""
    p = torch.softmax(logits.float(), dim=-1)
    idx = labels.long()[..., None]
    p.scatter_add_(-1, idx, torch.full(idx.shape, -1.0, device=p.device))
    return (p * scale).to(logits.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level CE: logits (..., V), labels (...) int; the mean over
    tokens (:class:`_CEMean`; under a mesh :class:`_CETokens` on each
    rank's lanes), or over the tokens where ``mask`` is set."""
    if mask is None and pctx.is_dtensor(logits):
        lanes = ("batch",) + (None,) * (labels.ndim - 1)
        return pctx.local(_CETokens.apply, (logits, labels),
                          (lanes + (None,), lanes), out_like=1).mean()
    if mask is None:
        return _CEMean.apply(logits, labels)
    nll = _nll(logits, labels)
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def lm_loss(params, cfg: ArchConfig, batch: dict,
            qm: QuantMode = QuantMode.off(),
            aux_coefs=(0.01, 1e-3)) -> torch.Tensor:
    """Next-token loss for the causal families, per-frame CE for encoders
    (``data.synthetic`` makes the labels of each). batch: {"inputs": (B,
    S) tokens or (B, S, d) embeddings, "labels": (B, S)[, "mask": (B,
    S)]}. The MoE family adds its router losses, ``aux_coefs`` times (load
    balance, z-loss)."""
    if cfg.family == "moe":
        logits, (lbl, zl) = moe.forward(params, cfg, batch["inputs"], qm,
                                        return_aux=True)
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + aux_coefs[0] * lbl + aux_coefs[1] * zl
    logits = forward(params, cfg, batch["inputs"], qm)
    return cross_entropy(logits, batch["labels"], batch.get("mask"))


def kl_divergence(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student) averaged over tokens (Eq. 8)."""
    t = teacher_logits.float() / temperature
    s = student_logits.float() / temperature
    return torch.mean(torch.sum(
        torch.softmax(t, dim=-1) * (torch.log_softmax(t, dim=-1)
                                    - torch.log_softmax(s, dim=-1)), dim=-1))


def perplexity(params, cfg: ArchConfig, tokens: torch.Tensor,
               qm: QuantMode = QuantMode.off()) -> float:
    """exp(mean NLL) of next-token prediction over a (B, S) token batch."""
    with torch.no_grad():
        logits = forward(params, cfg, tokens[:, :-1], qm)
        return float(torch.exp(cross_entropy(logits, tokens[:, 1:])))
