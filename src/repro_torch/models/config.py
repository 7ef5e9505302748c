"""Unified model configuration covering all assigned architecture families.

Copy of ``repro.models.config`` with a torch ``dtype``.

One ``ModelConfig`` drives every family (dense / moe / ssm / hybrid /
vlm / audio).  The per-layer structure is a tuple of *layer kinds*:

    "attn"   — self-attention + FFN (FFN is MLP or MoE per ``n_experts``)
    "xattn"  — cross-attention + FFN (VLM image layers, Whisper decoder
               handles cross-attention inside "attn" when
               ``is_encoder_decoder``)
    "rglru"  — Griffin/RecurrentGemma recurrent block + FFN
    "ssd"    — Mamba-2 SSD mixer block (no separate FFN)

If every layer has the same kind the stack is *uniform*: its
parameters are stacked with a leading layer axis.  The port serves
every kind: self-attention ("attn") stacks with an MLP or MoE FFN, the
hybrid RG-LRU + local-attention stacks of RecurrentGemma ("rglru" with
"attn"), the Mamba-2 SSD stack ("ssd"), Llama-3.2-Vision's
cross-attention layers ("xattn") and Whisper's encoder-decoder stack,
with configs and parameter counts as in the reference
(``repro.models.config``).

Attention *metadata* (sliding window, RoPE base) is per-layer data, not
structure, so gemma3's 5-local:1-global pattern stays in uniform mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


GLOBAL_ATTENTION = 0  # sentinel window size: full causal attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # -- attention ------------------------------------------------------
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0          # gemma3 global layers (1e6)
    sliding_window: int = GLOBAL_ATTENTION  # window for "local" layers
    local_global_pattern: Tuple[int, int] = (0, 0)  # (n_local, n_global) cycle
    attn_logit_softcap: float = 0.0

    # -- FFN / MoE -------------------------------------------------------
    act: str = "silu"              # silu | gelu
    n_experts: int = 0
    experts_per_token: int = 0
    moe_impl: str = "scatter"      # scatter | dense (reference)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- SSM (Mamba-2 SSD) ------------------------------------------------
    ssm_state: int = 0             # N — state size per head
    ssm_heads: int = 0             # H — SSD heads
    ssm_head_dim: int = 64         # P — channels per head
    ssm_groups: int = 1            # B/C projection groups
    ssm_chunk: int = 64            # SSD chunk length
    ssm_conv: int = 4              # depthwise conv width

    # -- hybrid (RG-LRU) ---------------------------------------------------
    lru_width: int = 0
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")

    # -- VLM ---------------------------------------------------------------
    cross_attn_every: int = 0      # every k-th layer is cross-attention
    n_image_tokens: int = 0        # stub vision embeddings per sample

    # -- audio / encoder-decoder --------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 0        # stub frame embeddings per sample
    encoder_causal: bool = False

    # -- numerics / misc ------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16      # a torch.dtype
    remat: bool = False            # activation checkpointing per layer
    remat_save_gather: bool = True # keep post-Gather outputs (no psum
                                   # recompute in bwd; costs 2 saved
                                   # tensors/layer — EXPERIMENTS §Perf)
    # long-context decode handling: "native" (SSM/hybrid/sliding archs) or
    # "sliding_window" (full-attention archs run long_500k only under an
    # explicit window — DESIGN.md §Arch-applicability)
    long_context: str = "native"
    long_context_window: int = 16_384
    source: str = ""               # citation for the config

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        kinds = []
        for i in range(self.n_layers):
            if self.block_pattern:
                kinds.append(self.block_pattern[i % len(self.block_pattern)])
            elif self.arch_type == "ssm":
                kinds.append("ssd")
            elif (self.cross_attn_every
                  and (i + 1) % self.cross_attn_every == 0):
                kinds.append("xattn")
            else:
                kinds.append("attn")
        return tuple(kinds)

    @property
    def uniform(self) -> bool:
        kinds = self.layer_kinds
        return all(k == kinds[0] for k in kinds)

    def layer_windows(self, seq_len: int) -> Tuple[int, ...]:
        """Per-layer sliding window (0 = full/global) for decoder layers."""
        n_local, n_global = self.local_global_pattern
        out = []
        for i, kind in enumerate(self.layer_kinds):
            if kind not in ("attn", "xattn"):
                out.append(0)
                continue
            if n_local and n_global:
                cycle = n_local + n_global
                is_local = (i % cycle) < n_local
                out.append(self.sliding_window if is_local else 0)
            elif self.sliding_window:
                out.append(self.sliding_window)
            else:
                out.append(0)
        return tuple(out)

    def layer_thetas(self) -> Tuple[float, ...]:
        """Per-layer RoPE base (gemma3 uses 1e6 on global layers)."""
        out = []
        windows = self.layer_windows(0)
        for w in windows:
            if w == 0 and self.rope_theta_global:
                out.append(self.rope_theta_global)
            else:
                out.append(self.rope_theta)
        return tuple(out)

    # -- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        qdim, kvdim = self.n_heads * hd, self.n_kv_heads * hd
        attn = d * qdim + 2 * d * kvdim + qdim * d
        if self.qkv_bias:
            attn += qdim + 2 * kvdim
        n_mlp_mats = 3 if self.act == "silu" else 2
        mlp = n_mlp_mats * d * self.d_ff
        moe = self.n_experts * n_mlp_mats * d * self.d_ff + d * self.n_experts
        d_in = self.lru_width or d
        rglru = (2 * d * d_in + d_in * d            # branches + out
                 + self.ssm_conv * d_in + 3 * d_in)  # conv + gates/Lambda
        ssd_inner = (self.ssm_heads * self.ssm_head_dim) or 2 * d
        ssd = (d * (2 * ssd_inner + 2 * self.ssm_groups * self.ssm_state
                    + self.ssm_heads)
               + ssd_inner * d + 3 * self.ssm_heads
               + self.ssm_conv * (ssd_inner + 2 * self.ssm_groups
                                  * self.ssm_state))
        total = 0
        for kind in self.layer_kinds:
            if kind == "attn":
                total += attn + (moe if self.n_experts else mlp) + 2 * d
            elif kind == "xattn":
                total += attn + mlp + 3 * d
            elif kind == "rglru":
                total += rglru + mlp + 2 * d
            elif kind == "ssd":
                total += ssd + 2 * d
        if self.is_encoder_decoder:
            # encoder stack + decoder cross-attention
            total += self.n_encoder_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + d)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k of the experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        n_mlp_mats = 3 if self.act == "silu" else 2
        moe_total = self.n_layers * self.n_experts * n_mlp_mats \
            * self.d_model * self.d_ff
        moe_active = self.n_layers * self.experts_per_token * n_mlp_mats \
            * self.d_model * self.d_ff
        return full - moe_total + moe_active
