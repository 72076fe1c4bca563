"""Model API of the port, dispatching on ``cfg.family``.

The port serves the dense family; the other families of the JAX package
(moe, hybrid, ssm, encoder, vlm) come with later slices and raise here."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import QuantMode

from . import transformer

_FAMILY = {"dense": transformer}


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
