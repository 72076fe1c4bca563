"""Deterministic synthetic LM corpus — the offline stand-in for WikiText2
(numpy only; the same batches as ``repro.data.synthetic``, bit for bit).

A Zipf–Markov source: token t+1 follows a fixed random permutation of token
t with probability ``p_follow``, otherwise it is drawn from a Zipf marginal.
The planted bigram structure is learnable (a trained model's perplexity
drops far below the unigram entropy), so *relative* comparisons between
quantization methods — the paper's claims — are meaningful.

Determinism: batch(i) depends only on (seed, i) — restarts replay exactly
(fault-tolerance requirement), and any worker can compute its own shard.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    p_follow: float = 0.6
    zipf_a: float = 1.2


def _zipf_probs(v: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** a
    return p / p.sum()


class SyntheticLM:
    def __init__(self, dc: DataConfig):
        self.dc = dc
        rng = np.random.default_rng(dc.seed)
        self.perm = rng.permutation(dc.vocab_size)
        self.zipf = _zipf_probs(dc.vocab_size, dc.zipf_a)
        # shuffle so the frequent tokens are spread over the id space
        self.rank2id = rng.permutation(dc.vocab_size)

    def batch(self, step: int) -> dict:
        dc = self.dc
        rng = np.random.default_rng((dc.seed + 1) * 1_000_003 + step)
        B, S = dc.batch_size, dc.seq_len
        toks = np.empty((B, S + 1), dtype=np.int32)
        zipf_draws = self.rank2id[
            rng.choice(dc.vocab_size, size=(B, S + 1), p=self.zipf)]
        follow = rng.random((B, S + 1)) < dc.p_follow
        toks[:, 0] = zipf_draws[:, 0]
        for t in range(1, S + 1):
            toks[:, t] = np.where(follow[:, t],
                                  self.perm[toks[:, t - 1]],
                                  zipf_draws[:, t])
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def token_stream(self, n_batches: int):
        for i in range(n_batches):
            yield self.batch(i)


class SyntheticEmbed:
    """For stub-frontend archs (hubert / internvl2): token stream mapped
    through a fixed codebook + noise -> (B, S, d) embeddings."""

    def __init__(self, dc: DataConfig, d_model: int, n_classes: int,
                 next_token_labels: bool):
        self.lm = SyntheticLM(dc)
        rng = np.random.default_rng(dc.seed + 7)
        self.codebook = rng.standard_normal(
            (dc.vocab_size, d_model)).astype(np.float32) * 0.5
        self.n_classes = n_classes
        self.next_token = next_token_labels
        self.noise = 0.05

    def batch(self, step: int) -> dict:
        b = self.lm.batch(step)
        rng = np.random.default_rng(991 + step)
        toks = b["inputs"]
        emb = self.codebook[toks]
        emb = emb + rng.standard_normal(emb.shape).astype(np.float32) * self.noise
        if self.next_token:
            labels = b["labels"] % self.n_classes
        else:
            labels = toks % self.n_classes  # per-frame classification
        return {"inputs": emb, "labels": labels.astype(np.int32)}


def make_source(cfg: ArchConfig, batch_size: int, seq_len: int,
                seed: int = 0):
    """Data source matched to the architecture's input modality."""
    if cfg.embed_inputs:
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                        batch_size=batch_size, seed=seed)
        return SyntheticLM(dc)
    dc = DataConfig(vocab_size=min(4096, max(64, cfg.vocab_size)),
                    seq_len=seq_len, batch_size=batch_size, seed=seed)
    return SyntheticEmbed(dc, cfg.d_model, cfg.vocab_size,
                          next_token_labels=(cfg.family == "vlm"))


def unigram_ppl(dc: DataConfig) -> float:
    """Entropy of the marginal — the no-learning baseline perplexity."""
    src = SyntheticLM(dc)
    p_f, z = dc.p_follow, src.zipf
    # stationary marginal ~ zipf (permutation preserves marginals)
    h_follow = -(p_f * np.log(p_f))
    h = -np.sum(z * np.log(z))
    return float(np.exp((1 - p_f) * h))
