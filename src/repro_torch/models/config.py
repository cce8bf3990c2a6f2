# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models.config``: one composable ``ModelConfig``.

The fields and their defaults are the JAX package's, so a configuration
means the same in both packages: attention (GQA or MLA) and Mamba2
layers (``layer_pattern``), dense, MoE or no FFNs (``ffn_pattern``),
leading dense layers (``first_k_dense``), the Whisper encoder and the
stub modality prefix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0  # shared (always-on) experts, DeepSeek style
    expert_ff: int = 0  # per-expert FFN width (0 -> use d_ff)
    aux_loss_weight: float = 0.01
    impl: str = "dense"  # "dense" | "dispatch"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD."""

    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    expand: int = 2
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Frozen-shape encoder for enc-dec (Whisper): the modality frontend is
    a stub, the caller passes precomputed frame embeddings."""

    n_layers: int
    n_frames: int  # source length (e.g. 1500 for Whisper 30s)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    ffn: str = "swiglu"  # "swiglu" | "gelu"
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    qkv_bias: bool = False
    rope: str = "standard"  # "standard" | "partial" | "none"
    rope_frac: float = 1.0  # fraction of head_dim rotated ("partial": 0.5)
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    layer_pattern: str = "A"  # cycled over layers: "A" attention, "M" mamba
    ffn_pattern: str = "D"  # cycled: "D" dense, "E" MoE, "-" none
    first_k_dense: int = 0
    encoder: Optional[EncoderConfig] = None  # enc-dec if set
    n_prefix: int = 0  # stub modality prefix tokens (VLM patches)
    tie_embeddings: bool = False
    max_seq: int = 131_072

    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # master params
    # remat / remat_policy: the training forward's blocks (and the Whisper
    # encoder's layers) under torch.utils.checkpoint, "full" or "dots"
    # (models/transformer.py: _remat); scan_layers and attn_seq_shard
    # shape the JAX package's compiled program, the port runs eagerly and
    # ignores them
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    block_size: int = 1  # consecutive layers in one stacked superblock
    attn_chunk: int = 512  # q-chunk of the plain chunked attention
    # the name the JAX package gives its TPU kernel route: in the port,
    # True sends full-sequence attention (gqa_train, hence the Whisper
    # encoder) to the hand-written CUDA flash-attention kernel
    # (kernels/flash_attention, csrc/flash_attention.cu) on a CUDA tensor
    # and to its plain version on a CPU tensor; False runs the plain
    # chunked attention, as the JAX package does off the TPU
    use_pallas_attention: bool = False
    attn_seq_shard: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def ffn_kind(self, i: int) -> str:
        if i < self.first_k_dense:
            return "D"
        j = i - self.first_k_dense
        return self.ffn_pattern[j % len(self.ffn_pattern)]

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_hybrid(self) -> bool:
        return "M" in self.layer_pattern and "A" in self.layer_pattern

    @property
    def is_ssm_only(self) -> bool:
        return set(self.layer_pattern) == {"M"}

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long contexts: attention-free or mostly SSM."""
        return "M" in self.layer_pattern

    @property
    def n_blocks(self) -> int:
        rest = self.n_layers - self.first_k_dense
        if rest % self.block_size:
            raise ValueError(f"{self.name}: {rest} layers do not split into "
                             f"blocks of {self.block_size}")
        return rest // self.block_size

    def param_count(self) -> int:
        """Analytic parameter count (the JAX package's formula)."""
        total = self.vocab * self.d_model
        if not self.tie_embeddings:
            total += self.vocab * self.d_model
        for i in range(self.n_layers):
            total += self._layer_params(i)
        total += self.d_model  # final norm
        if self.encoder is not None:
            for _ in range(self.encoder.n_layers):
                total += (self._attn_params() + self._ffn_params("D")
                          + 2 * self.d_model)
            total += self.d_model
        return total

    def active_param_count(self) -> int:
        """Parameters one token touches (MoE: its routed experts only)."""
        total = self.vocab * self.d_model
        if not self.tie_embeddings:
            total += self.vocab * self.d_model
        for i in range(self.n_layers):
            total += self._layer_params(i, active_only=True)
        return total + self.d_model

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * self.n_heads * qk_hd
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d
            return p
        p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        p += self.n_heads * hd * d
        if self.qkv_bias:
            p += (self.n_heads + 2 * self.n_kv_heads) * hd
        return p

    def _mamba_params(self) -> int:
        s = self.ssm
        d = self.d_model
        di = s.d_inner(d)
        nh = s.n_heads(d)
        conv_ch = di + 2 * s.n_groups * s.d_state
        p = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
        p += conv_ch * s.conv_width
        p += nh * 3  # A_log, D, dt bias
        p += di  # gated norm
        p += di * d  # out_proj
        return p

    def _ffn_params(self, kind: str, active_only: bool = False) -> int:
        d = self.d_model
        if kind == "-":
            return 0
        if kind == "E":
            m = self.moe
            eff = m.expert_ff or self.d_ff
            per = (3 if self.ffn == "swiglu" else 2) * d * eff
            routed = m.top_k if active_only else m.n_experts
            return per * (routed + m.n_shared) + d * m.n_experts
        return (3 if self.ffn == "swiglu" else 2) * d * self.d_ff

    def _layer_params(self, i: int, active_only: bool = False) -> int:
        p = 2 * self.d_model  # norms
        if self.layer_kind(i) == "M":
            p += self._mamba_params()
        else:
            p += self._attn_params()
            if self.encoder is not None:  # decoder cross-attention
                p += self._attn_params() + self.d_model
        return p + self._ffn_params(self.ffn_kind(i), active_only)

