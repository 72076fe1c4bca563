"""Architecture configuration shared by the model zoo, configs, and launch."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    causal: bool = True
    embed_inputs: bool = True      # False: stub frontend feeds embeddings
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1            # routing groups (locality knob for EP)
    # --- hybrid (RG-LRU + local attention, Griffin pattern) ---
    window: int = 0                # local attention window (0 = full)
    lru_width: int = 0
    # --- ssm (Mamba2 / SSD) ---
    ssm_state: int = 0
    expand: int = 2
    conv_kernel: int = 4
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    # --- execution ---
    attn_chunk: int = 1024         # KV-chunk for online-softmax attention
    attn_repeat_kv: bool = False   # materialize GQA kv to H heads so the
    #                                head axis divides the TP degree (kills
    #                                GSPMD involuntary replication; §Perf)
    dtype: str = "float32"
    remat: bool = False
    scan_layers: bool = True       # False: unroll (roofline per-layer costs)

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived ----------------------------------------------------------
    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts routed experts at
        top_k/n_experts utilization (for MoE MODEL_FLOPS = 6·N_active·D)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if not self.embed_inputs:
            emb = self.vocab_size * d  # head only, frontend stubbed
        if self.family == "ssm":
            di, H, N, G = self.d_inner, self.ssm_nheads, self.ssm_state, self.ssm_ngroups
            per = (d * (2 * di + 2 * G * N + H)       # in_proj
                   + self.conv_dim * self.conv_kernel  # conv
                   + 3 * H + di                        # A, D, dt_bias, norm
                   + di * d)                           # out_proj
            return emb + L * per + d
        att = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "moe":
            e_all = self.n_experts + self.n_shared_experts
            e_act = self.top_k + self.n_shared_experts
            ffn_full = 3 * d * self.d_ff * e_all + d * self.n_experts
            ffn_act = 3 * d * self.d_ff * e_act + d * self.n_experts
            ffn = ffn_act if active_only else ffn_full
            return emb + L * (att + ffn + 2 * d) + d
        if self.family == "hybrid":
            n_rec = self.n_rec_layers
            n_att = L - n_rec
            lru = self.lru_width
            rec = (2 * d * lru + lru * self.conv_kernel + 3 * lru
                   + lru * d + lru)
            ffn = 3 * d * self.d_ff
            return (emb + n_att * (att + ffn + 2 * d)
                    + n_rec * (rec + ffn + 2 * d) + d)
        ffn = 3 * d * self.d_ff
        return emb + L * (att + ffn + 2 * d) + d

    @property
    def n_rec_layers(self) -> int:
        """Hybrid pattern (rec, rec, attn) repeated + rec tail."""
        n_super = self.n_layers // 3
        tail = self.n_layers - 3 * n_super
        return 2 * n_super + tail

    @property
    def n_super_blocks(self) -> int:
        return self.n_layers // 3

    @property
    def n_tail_rec(self) -> int:
        return self.n_layers - 3 * self.n_super_blocks


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    # the paper's calibration workload (§5.1: 256 seqs of 1k tokens),
    # lowered as a distributed transform-learning step (--shape calib_1k)
    "calib_1k": ShapeConfig("calib_1k", 1024, 256, "latmix"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Spec'd skips: encoder-only has no decode; long_500k needs
    sub-quadratic attention (ssm / hybrid only)."""
    if cfg.family == "encoder" and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k requires sub-quadratic attention"
    if shape.kind == "latmix" and not cfg.embed_inputs:
        return False, "calibration step demo is token-input only"
    return True, ""


ASSIGNED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
