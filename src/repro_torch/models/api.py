"""Model API of the port, dispatching on ``cfg.family``: serving, the PTQ
folds and the losses.

The port serves the dense and moe families; the other families of the JAX
package (hybrid, ssm, encoder, vlm) come with later slices and raise here."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import QuantMode

from . import moe, transformer

_FAMILY = {"dense": transformer, "moe": moe}


def module_for(cfg: ArchConfig):
    mod = _FAMILY.get(cfg.family)
    if mod is None:
        raise ValueError(f"family {cfg.family!r} is not ported yet "
                         f"(ported: {sorted(_FAMILY)})")
    return mod


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None):
    return module_for(cfg).init(gen, cfg, dtype, device)


def forward(params, cfg: ArchConfig, inputs,
            qm: QuantMode = QuantMode.off()):
    return module_for(cfg).forward(params, cfg, inputs, qm)


def prefill(params, cfg: ArchConfig, inputs,
            qm: QuantMode = QuantMode.off(), max_len: int | None = None,
            kv_quant=None):
    return module_for(cfg).prefill(params, cfg, inputs, qm, max_len=max_len,
                                   kv_quant=kv_quant)


def prefill_chunk(params, cfg: ArchConfig, cache, inputs, start: int,
                  last_idx: int, qm: QuantMode = QuantMode.off()):
    return module_for(cfg).prefill_chunk(params, cfg, cache, inputs, start,
                                         last_idx, qm)


def decode(params, cfg: ArchConfig, cache, inputs, cur_len,
           qm: QuantMode = QuantMode.off()):
    return module_for(cfg).decode(params, cfg, cache, inputs, cur_len, qm)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, kv_quant=None, device=None):
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype,
                                      kv_quant=kv_quant, device=device)


def prefill_chunk_paged(params, cfg: ArchConfig, cache, block_tables,
                        inputs, start, last_idx,
                        qm: QuantMode = QuantMode.off()):
    return module_for(cfg).prefill_chunk_paged(params, cfg, cache,
                                               block_tables, inputs, start,
                                               last_idx, qm)


def decode_paged(params, cfg: ArchConfig, cache, inputs, cur_len,
                 block_tables, qm: QuantMode = QuantMode.off()):
    return module_for(cfg).decode_paged(params, cfg, cache, inputs, cur_len,
                                        block_tables, qm)


def init_cache_paged(cfg: ArchConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, kv_quant=None, device=None):
    return module_for(cfg).init_cache_paged(cfg, n_pages, page_size, dtype,
                                            kv_quant=kv_quant, device=device)


def verify(params, cfg: ArchConfig, cache, inputs, pos, n_valid,
           qm: QuantMode = QuantMode.off()):
    """Multi-token speculative verify step over the contiguous cache:
    per-slot next-token logits (B, C, V)."""
    return module_for(cfg).verify(params, cfg, cache, inputs, pos, n_valid,
                                  qm)


def verify_paged(params, cfg: ArchConfig, cache, inputs, pos, n_valid,
                 block_tables, qm: QuantMode = QuantMode.off()):
    """Multi-token speculative verify step over a paged pool."""
    return module_for(cfg).verify_paged(params, cfg, cache, inputs, pos,
                                        n_valid, block_tables, qm)


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

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level CE: logits (..., V), labels (...) int; the mean over
    tokens, or over the tokens where ``mask`` is set."""
    lf = logits.float()
    nll = (torch.logsumexp(lf, dim=-1)
           - torch.gather(lf, -1, labels.long()[..., None])[..., 0])
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def lm_loss(params, cfg: ArchConfig, batch: dict,
            qm: QuantMode = QuantMode.off(),
            aux_coefs=(0.01, 1e-3)) -> torch.Tensor:
    """Next-token loss. batch: {"inputs": (B, S) tokens, "labels": (B,
    S)[, "mask": (B, S)]}. The MoE family adds its router losses,
    ``aux_coefs`` times (load balance, z-loss)."""
    module_for(cfg)
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
