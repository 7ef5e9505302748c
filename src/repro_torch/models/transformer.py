"""Transformer: the counterpart of ``repro.models.transformer``.

``build_model(cfg)`` returns a :class:`Model` exposing

    init(gen)                                  -> params
    forward(params, batch)                     -> (logits, aux)
    loss(params, batch)                        -> (scalar, metrics)
    init_cache(B, max_len, cache_len=None, memory_len=0)
                                               -> ring cache (zeros)
    init_cache(B, max_len, page_size=..., kv_dtype="fp32"|"int8")
                                               -> paged cache (zeros)
    prefill(params, batch, cache)              -> (logits, cache)
    prefill_paged(params, batch, cache, slot, plen, page_size=...)
                                               -> (logits, cache)
    decode_step(params, cache, tokens, pos[, page_size=...])
                                               -> (logits, cache)
    verify_step(params, cache, tokens, pos, n_fed, page_size=...)
                                               -> (logits, cache)

for decoder stacks of self-attention ("attn") and RG-LRU ("rglru")
layers with an MLP or MoE FFN, of Mamba-2 SSD ("ssd") layers and of
tanh-gated cross-attention ("xattn") layers with an MLP, and for
encoder-decoder stacks: Qwen3, Gemma3, the bench-tiny model,
Phi-3.5-MoE, Grok-1, RecurrentGemma, Mamba-2, Llama-3.2-Vision (every
fifth layer attends to the image embeddings) and Whisper (a
bidirectional encoder over the audio frames; every decoder layer
attends to its output).  Per-layer sliding window and RoPE base stay
metadata (``cfg.layer_windows`` / ``cfg.layer_thetas``), so Gemma3's 5:1
local:global pattern is one uniform stack.

Parameters are a dict tree with the reference's keys and layout, in
the reference's three forms: a uniform stack keeps one layer dict with
a leading L axis; a periodic pattern of at least two periods
(RecurrentGemma's (R, R, A)) keeps ``{"blocks": [...], "tail": [...]}``
with one dict per pattern position stacked over the full periods and
the remainder layers unstacked (Llama-3.2-Vision's (4 attn, 1 xattn)
period too); any other pattern is a list of layer dicts.  An
encoder-decoder model adds an ``encoder`` subtree (its layers stacked,
and its final norm).  Projections are ``(d_in, d_out)`` applied as
``x @ w``, in the promoted type of the two (``common.matmul``), as jnp
promotes the float32 image / audio stubs against bfloat16 weights.
``repro_torch.models.weights`` converts the reference's ``Model.init``
tree, so both packages compute the same function in the tests.  Where
the reference scans over stacked layers (``_run_uniform`` /
``_run_blocks`` / ``_run_pattern``), the port runs one Python loop over
the layers of any form (``Model._layer_views``).

Two caches, both updated **in place** (where the reference returns new
buffers from a donated jit call); each call returns the cache dict for
API parity:

* the ring cache of the bucket engine (``init_cache`` without
  ``page_size``), in the same three forms as the parameters: per
  attention layer ``k``/``v`` (B, M, Hkv, D) and ``pos`` (M,) int32
  (slot = position mod M, -1 = empty), per RG-LRU layer ``h`` (B, W)
  float32 and the conv tail, per SSD layer ``state`` (B, H, P, N)
  float32 and the conv tail; a cross-attention layer holds nothing.
  ``prefill`` fills it, and stores the cross-attention memory (the image
  embeddings, or the encoder's output, computed once) as
  ``cache["memory"]``; the scalar-position ``decode_step`` reads the
  ring, and the memory with every slot valid (the TPU kernel's
  ``kv_len`` form), through ``kernels.ops.gqa_decode_attention`` (the
  contiguous decode kernel on the card), and every prefill runs the
  RG-LRU recurrence through ``kernels.ops.rglru_linear_scan``;
* the paged cache of the continuous engine (see :meth:`Model.init_cache`),
  a list of per-layer page-pool buffers written row by row
  (``index_copy_``), for uniform self-attention stacks without
  cross-attention only (as in the reference).

Quantized serving: ``Model.qmm`` (default ``None``) is the reference's
quantized-matmul hook.  ``ModelRunner`` installs
``repro_torch.quant.make_qmm`` there under ``--quant q4``, and every
attention and dense MLP projection of an attention layer then goes
through it (the Q4_0 kernel on the card); MoE expert stacks stay dense,
as in the reference.  ``init_cache(kv_dtype="int8")``
allocates int8 pages with per-(row, kv head) f32 scales
(``repro_torch.quant.kv_int8``).

MoE layers (``repro_torch.models.moe``) take the reference's
``cfg.moe_impl`` and ``cfg.capacity_factor``; each layer's router aux
loss is summed over the stack as in the reference under
``_run_layers(with_aux=True)``; the serving entry points discard it, so
they leave it off and launch nothing for it.

Training (``forward`` / ``loss``) runs the stack without a cache
(``caches=None``): every layer attends over its own K/V, the RG-LRU and
SSD layers start from a zero state and keep none, and the router aux
loss is on.  Autograd differentiates it, the RG-LRU scan through its
``torch.autograd.Function`` (the scan kernel's reverse mode on the
card).  A stacked leaf's per-layer views come from one ``torch.unbind``
a forward (``_layer_params``), whose backward is one ``stack``: indexing
``w[i]`` per layer would make each view's backward allocate a zero
tensor of the whole stack.  As in the reference, the blockwise attention
is rematerialised in the backward pass and ``cfg.remat`` checkpoints
each layer (each super-block in the block layout), with
``torch.utils.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import gqa_decode_attention, paged_gqa_decode_attention
from ..quant.kv_int8 import dequantize_rows, quantize_rows
from .attention import flash_attention
from .common import (Params, dense_init, embed_init, layer_norm, mlp,
                     nll_sum, proj, rms_norm, unembed)
from .config import ModelConfig
from .moe import init_moe, moe
from .recurrent import RGLRUState, init_rglru_block, rglru_block
from .ssm import SSDState, init_ssd, ssd_block

ATTN_CHUNK = 512


def _index_tree(tree: Any, i: int) -> Any:
    """``tree`` with every leaf indexed by ``i`` (one layer of a stack)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, each leaf split with
    one ``torch.unbind`` (views; under autograd one ``stack`` backward a
    leaf, where ``n`` indexings would each scatter into a zero tensor the
    size of the whole stack)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.unbind(tree, 0))


# ----------------------------------------------------------------------
# parameter init
# ----------------------------------------------------------------------

def _init_norm(cfg: ModelConfig, d: int, device: Any,
               lead: tuple = ()) -> Params:
    """RMSNorm's zero-centred gain; Whisper ("audio") takes LayerNorm with
    a unit gain and a zero bias, as in the reference."""
    shape = lead + (d,)
    if cfg.arch_type == "audio":
        return {"g": torch.ones(shape, dtype=cfg.dtype, device=device),
                "b": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    return {"g": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if "b" in p:
        return layer_norm(x, p["g"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["g"], cfg.norm_eps)


def _init_attn(gen: torch.Generator, cfg: ModelConfig, lead: tuple, *,
               cross: bool = False) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qdim, kvdim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    dev = gen.device
    p: Params = {
        "w_q": dense_init(gen, d, qdim, cfg.dtype, device=dev, lead=lead),
        "w_k": dense_init(gen, d, kvdim, cfg.dtype, device=dev, lead=lead),
        "w_v": dense_init(gen, d, kvdim, cfg.dtype, device=dev, lead=lead),
        "w_o": dense_init(gen, qdim, d, cfg.dtype, device=dev, lead=lead),
    }
    if cfg.qkv_bias:
        for name, n in (("b_q", qdim), ("b_k", kvdim), ("b_v", kvdim)):
            p[name] = torch.zeros(lead + (n,), dtype=cfg.dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(lead + (hd,), dtype=cfg.dtype, device=dev)
        p["k_norm"] = torch.zeros(lead + (hd,), dtype=cfg.dtype, device=dev)
    if cross:                          # tanh-gated cross-attention
        p["gate"] = torch.zeros(lead, dtype=cfg.dtype, device=dev)
    return p


def _init_mlp(gen: torch.Generator, cfg: ModelConfig, lead: tuple) -> Params:
    d, f, dev = cfg.d_model, cfg.d_ff, gen.device
    if cfg.act == "silu":
        return {"w_gate": dense_init(gen, d, f, cfg.dtype, device=dev,
                                     lead=lead),
                "w_up": dense_init(gen, d, f, cfg.dtype, device=dev,
                                   lead=lead),
                "w_down": dense_init(gen, f, d, cfg.dtype, device=dev,
                                     lead=lead)}
    return {"w_up": dense_init(gen, d, f, cfg.dtype, device=dev, lead=lead),
            "w_down": dense_init(gen, f, d, cfg.dtype, device=dev,
                                 lead=lead)}


def _init_ffn(gen: torch.Generator, cfg: ModelConfig, lead: tuple) -> Params:
    if cfg.n_experts:
        return {"moe": init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                cfg.act, cfg.dtype, lead)}
    return {"mlp": _init_mlp(gen, cfg, lead)}


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                lead: tuple = (), *, decoder_cross: bool = False) -> Params:
    """One layer's parameters, stacked over ``lead``: "attn" or "rglru"
    with an MLP or MoE FFN, "xattn" (cross-attention with a dense MLP),
    or "ssd" (the Mamba-2 block, no FFN).  ``decoder_cross`` (Whisper's
    decoder) adds a cross-attention and its norm to an "attn" layer."""
    dev = gen.device
    p: Params = {"ln1": _init_norm(cfg, cfg.d_model, dev, lead)}
    if kind == "ssd":
        p["ssd"] = init_ssd(gen, cfg.d_model, n_heads=cfg.ssm_heads,
                            head_dim=cfg.ssm_head_dim,
                            d_state=cfg.ssm_state, n_groups=cfg.ssm_groups,
                            conv_width=cfg.ssm_conv, dtype=cfg.dtype,
                            lead=lead)
        return p
    if kind == "xattn":
        p["xattn"] = _init_attn(gen, cfg, lead, cross=True)
        p["ln2"] = _init_norm(cfg, cfg.d_model, dev, lead)
        p["mlp"] = _init_mlp(gen, cfg, lead)
        return p
    if kind == "attn":
        p["attn"] = _init_attn(gen, cfg, lead)
        if decoder_cross:
            p["ln_x"] = _init_norm(cfg, cfg.d_model, dev, lead)
            p["xattn"] = _init_attn(gen, cfg, lead, cross=True)
    else:
        p["rglru"] = init_rglru_block(gen, cfg.d_model,
                                      cfg.lru_width or cfg.d_model,
                                      cfg.ssm_conv, cfg.dtype, lead)
    p["ln2"] = _init_norm(cfg, cfg.d_model, dev, lead)
    p.update(_init_ffn(gen, cfg, lead))
    return p


# ----------------------------------------------------------------------
# attention forward
# ----------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, ap: Params, xq: torch.Tensor,
                 xkv: torch.Tensor, qmm=None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    hd = cfg.resolved_head_dim
    q = proj(xq, ap["w_q"], qmm)
    k = proj(xkv, ap["w_k"], qmm)
    v = proj(xkv, ap["w_v"], qmm)
    if cfg.qkv_bias:
        q, k, v = q + ap["b_q"], k + ap["b_k"], v + ap["b_v"]
    Bq, Sq = xq.shape[:2]
    Bk, Sk = xkv.shape[:2]
    q = q.reshape(Bq, Sq, cfg.n_heads, hd)
    k = k.reshape(Bk, Sk, cfg.n_kv_heads, hd)
    v = v.reshape(Bk, Sk, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, ap["q_norm"], cfg.norm_eps)
        k = rms_norm(k, ap["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Split-half RoPE with frequencies ``theta ** (-2i / D)`` — the
    paged path's ``transformer._rope`` of the reference (not
    ``common.apply_rope``).  x (..., S, H, D); positions (..., S)."""
    d = x.shape[-1]
    exponents = torch.arange(0, d, 2, dtype=torch.float32,
                             device=x.device) / d
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), -exponents)
    angles = positions[..., None].float() * freqs
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _paged_attn(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, window: int, cache: Dict[str, torch.Tensor],
                paged: Dict[str, Any]) -> torch.Tensor:
    """Slot-mapped cache write + attention read, for ONE layer.

    ``cache['k']/['v']`` are this layer's flat page-pool buffers
    ((n_pages * page_size, Hkv, D)), written in place at
    ``paged['write_slots']``.  Prefill (S > 1, one sequence): a fresh
    one-shot prefill attends over its own K/V (the cache held nothing
    of it — identical maths); a resumed chunk (``paged['prefill_ctx']``:
    chunked prefill or a prefix-cache hit) gathers the whole context
    through the block table after this chunk's write and attends with
    absolute-position causal masking.  Decode (S == 1) writes one row per
    sequence and reads through the block table with the paged kernel.
    Speculative verify (``paged['verify']``, S columns per sequence)
    writes all B * S fresh rows first, then reads offset s with the same
    paged kernel a sequential decode step runs, at ``kv_len + s``: the
    rows a decode at that position would see (idle lanes stay at 0).

    An int8 pool (``init_cache(kv_dtype="int8")``) is told by its
    ``k_scale``/``v_scale`` buffers: fresh rows are quantized per
    (token, kv head) before the write (codes and scales at the same
    slots), the resumed-prefill gather dequantizes the context to
    ``q.dtype``, and decode hands the scales to the paged kernel.  A
    fresh one-shot prefill still attends over the exact K/V.
    """
    S = q.shape[1]
    ck, cv = cache["k"], cache["v"]
    slots = paged["write_slots"]
    quantized = "k_scale" in cache

    def write(rows_k: torch.Tensor, rows_v: torch.Tensor) -> None:
        if not quantized:
            ck.index_copy_(0, slots, rows_k)
            cv.index_copy_(0, slots, rows_v)
            return
        for name, rows in (("k", rows_k), ("v", rows_v)):
            codes, scales = quantize_rows(rows)
            cache[name].index_copy_(0, slots, codes)
            cache[f"{name}_scale"].index_copy_(0, slots, scales)

    if paged.get("verify"):                   # speculative multi-token verify
        B, _, Hkv, D = k.shape
        write(k.reshape(B * S, Hkv, D), v.reshape(B * S, Hkv, D))
        kv_len = paged["kv_len"]
        outs = []
        for s in range(S):
            # on the device: the kernel's split plan never reads kv_lens
            kv_len_s = torch.where(kv_len > 0, kv_len + s,
                                   torch.zeros_like(kv_len))
            outs.append(paged_gqa_decode_attention(
                q[:, s:s + 1], ck, cv, paged["block_tables"], kv_len_s,
                window, page_size=paged["page_size"],
                softcap=cfg.attn_logit_softcap,
                impl=paged.get("impl", "auto"),
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale")))
        return torch.cat(outs, dim=1)
    if S > 1:                                 # prefill: one sequence
        write(k[0], v[0])
        ctx = paged.get("prefill_ctx")
        if ctx is not None:
            phys = ctx["phys"]
            if quantized:
                kctx = dequantize_rows(ck[phys], cache["k_scale"][phys],
                                       q.dtype)
                vctx = dequantize_rows(cv[phys], cache["v_scale"][phys],
                                       q.dtype)
            else:
                kctx, vctx = ck[phys], cv[phys]
            return flash_attention(
                q, kctx[None], vctx[None],
                causal=True, window=window, q_offset=ctx["q_offset"],
                kv_len=ctx["kv_len"], chunk=ATTN_CHUNK,
                softcap=cfg.attn_logit_softcap)
        return flash_attention(q, k, v, causal=True, window=window,
                               chunk=ATTN_CHUNK,
                               softcap=cfg.attn_logit_softcap)
    write(k[:, 0], v[:, 0])                   # decode: one token per slot
    return paged_gqa_decode_attention(
        q, ck, cv, paged["block_tables"], paged["kv_len"], window,
        page_size=paged["page_size"], softcap=cfg.attn_logit_softcap,
        impl=paged.get("impl", "auto"), k_scale=cache.get("k_scale"),
        v_scale=cache.get("v_scale"))


def _paged_slots(bt: torch.Tensor, pos: torch.Tensor, S: int,
                 page_size: int, n_fed: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where a paged decode (S = 1) or verify step (S columns) reads and
    writes: the absolute positions (B, S) of each lane's fed columns from
    ``pos`` (B,) on, their physical write slots (B * S,) through the block
    table ``bt``, and the lanes' kv_len (B,) int32 before the step.
    Idle lanes (``pos < 0``) and columns at or past ``n_fed`` write to
    the scratch page: an idle lane's table may be populated (a sequence
    prefilled this step but not decoding yet would lose its first page),
    and a column past a lane's drafts has no page grant.  A column near
    ``max_len`` may point past the table: the read is clamped (JAX clamps
    implicitly), and such a column is past ``n_fed``."""
    B, max_pages = bt.shape
    safe_pos = pos.clamp(min=0)
    offs = torch.arange(S, device=pos.device)[None, :]
    positions = safe_pos[:, None] + offs
    lanes = torch.arange(B, device=pos.device)[:, None]
    page_idx = (positions // page_size).clamp(max=max_pages - 1)
    phys = bt[lanes, page_idx].long() * page_size + positions % page_size
    valid = pos[:, None] >= 0
    if n_fed is not None:
        valid = valid & (offs < n_fed[:, None])
    write_slots = torch.where(valid, phys, positions % page_size)
    return (positions, write_slots.reshape(B * S),
            (pos + 1).clamp(min=0).to(torch.int32))


def _write_cache(ck: torch.Tensor, cv: torch.Tensor, cp: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> None:
    """Ring-buffer write, in place.  ck/cv (B,M,H,D), cp (M,) int32,
    k/v (B,S,H,D) at absolute ``positions`` (S,): slot = position mod M.
    A prompt of S >= M tokens keeps only its last M."""
    M = ck.shape[1]
    if k.shape[1] >= M:
        k, v, positions = k[:, -M:], v[:, -M:], positions[-M:]
    slots = positions % M
    ck.index_copy_(1, slots, k)
    cv.index_copy_(1, slots, v)
    cp.index_copy_(0, slots, positions.to(cp.dtype))


def _ring_attn(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, positions: torch.Tensor, window: int,
               cache: Dict[str, torch.Tensor],
               ring: Dict[str, Any]) -> torch.Tensor:
    """Ring-cache write + attention read, for ONE layer.

    Prefill (S > 1): the cache was empty, so attending over the fresh
    K/V is the same maths.  Decode (S == 1): the scalar position
    ``ring['q_pos']`` attends over the whole ring through its position
    array (causal, window, empty slots masked) with the contiguous
    decode kernel on CUDA tensors (``ring['impl']="ref"``: the plain
    version), the reference's ``flash_attention(..., q_offset=pos,
    kv_positions=cache['pos'])``."""
    _write_cache(cache["k"], cache["v"], cache["pos"], k, v, positions)
    if q.shape[1] > 1:
        return flash_attention(q, k, v, causal=True, window=window,
                               chunk=ATTN_CHUNK,
                               softcap=cfg.attn_logit_softcap)
    return gqa_decode_attention(
        q, cache["k"], cache["v"], kv_positions=cache["pos"],
        q_pos=ring["q_pos"], window=window,
        softcap=cfg.attn_logit_softcap, impl=ring["impl"])


def _self_attn(cfg: ModelConfig, ap: Params, x: torch.Tensor,
               positions: torch.Tensor, theta: float, window: int,
               cache: Optional[Dict[str, torch.Tensor]], *,
               paged: Optional[Dict[str, Any]],
               ring: Optional[Dict[str, Any]], qmm=None,
               causal: bool = True) -> torch.Tensor:
    """Self-attention of one layer.  Without a cache (training, and
    Whisper's encoder with ``causal=False``) it attends over its own K/V
    and writes nothing."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, ap, x, x, qmm)
    q = _rope(q, positions, theta)
    k = _rope(k, positions, theta)
    if cache is None:
        kw = dict(causal=causal, window=window, chunk=ATTN_CHUNK,
                  softcap=cfg.attn_logit_softcap)
        if torch.is_grad_enabled() and q.requires_grad:
            # training: recompute the blockwise attention in the backward
            # pass, as the reference does, instead of keeping every KV
            # chunk's scores and softmax state
            out = checkpoint(flash_attention, q, k, v, use_reentrant=False,
                             **kw)
        else:
            out = flash_attention(q, k, v, **kw)
    elif paged is not None:
        out = _paged_attn(cfg, q, k, v, window, cache, paged)
    else:
        out = _ring_attn(cfg, q, k, v, positions, window, cache, ring)
    return proj(out.reshape(B, S, -1), ap["w_o"], qmm)


def _cross_attn(cfg: ModelConfig, ap: Params, x: torch.Tensor,
                memory: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Tanh-gated cross-attention of ``x`` (B, S, d) over the memory
    (B, M, d): the image embeddings, or the encoder's output.

    K/V are projected from the memory on every call, as the reference
    does (no RoPE, never cached).  A float32 memory gives float32 K/V
    against a ``cfg.dtype`` query, as jnp promotes them.  Prefill (S > 1)
    attends through ``flash_attention(causal=False)``; a decode step's
    single query reads all M slots through
    ``kernels.ops.gqa_decode_attention`` in the TPU kernel's ``kv_len``
    form (the contiguous decode kernel on the card; ``impl="ref"``: the
    plain version), the same function.  The output is scaled by
    ``tanh(gate)``, computed in float32 and cast to the output's type."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, ap, x, memory)
    if S == 1:
        out = gqa_decode_attention(q, k, v, kv_len=memory.shape[1],
                                   impl=impl)
    else:
        out = flash_attention(q, k, v, causal=False, chunk=ATTN_CHUNK)
    out = proj(out.reshape(B, S, -1), ap["w_o"])
    if "gate" in ap:
        out = torch.tanh(ap["gate"].float()).to(out.dtype) * out
    return out


def _ffn(cfg: ModelConfig, lp: Params, x: torch.Tensor, qmm=None, *,
         with_aux: bool) -> Tuple[torch.Tensor, Any]:
    """The layer's FFN and its router aux loss (a 0-d float32 tensor; the
    float 0.0 for an MLP or without ``with_aux``, so nothing is launched
    for it).  The quantized-matmul hook reaches the dense MLP only:
    expert stacks are never Q4_0, as in the reference."""
    if "moe" in lp:
        return moe(lp["moe"], x, k=cfg.experts_per_token, act=cfg.act,
                   impl=cfg.moe_impl, capacity_factor=cfg.capacity_factor,
                   with_aux=with_aux)
    return mlp(lp["mlp"], x, cfg.act, qmm), 0.0


def _layer_forward(cfg: ModelConfig, kind: str, lp: Params, x: torch.Tensor,
                   positions: torch.Tensor, theta: float, window: int,
                   cache: Optional[Dict[str, Any]], *,
                   memory: Optional[torch.Tensor] = None,
                   paged: Optional[Dict[str, Any]] = None,
                   ring: Optional[Dict[str, Any]] = None,
                   qmm=None, with_aux: bool = False, causal: bool = True,
                   ) -> Tuple[torch.Tensor, Any]:
    """One pre-norm block: x + mixer(norm(x)), then x + ffn(norm(x));
    returns (x, the FFN's router aux loss, as :func:`_ffn`).  The mixer
    is self-attention, cross-attention over ``memory`` ("xattn", with a
    dense MLP), the RG-LRU block or the SSD block, whose new state is
    copied into the cache; an SSD layer has no FFN.  An "attn" layer
    with its own ``xattn`` (Whisper's decoder) attends to the memory
    after itself.  ``cache=None`` is the cache-less layer of training and
    of the encoder: the recurrent layers start from a zero state and keep
    none.  As in the reference, only self-attention and its FFN take the
    quantized-matmul hook."""
    h = _apply_norm(cfg, lp["ln1"], x)
    impl = ring["impl"] if ring is not None else "auto"
    if kind == "xattn":
        x = x + _cross_attn(cfg, lp["xattn"], h, memory, impl)
        h2 = _apply_norm(cfg, lp["ln2"], x)
        return x + mlp(lp["mlp"], h2, cfg.act), 0.0
    if kind == "ssd":
        st = None if cache is None else cache["ssd"]
        y, new = ssd_block(lp["ssd"], h, n_heads=cfg.ssm_heads,
                           head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                           n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk,
                           state=None if st is None else SSDState(**st))
        if st is not None:
            st["state"].copy_(new.state)
            st["conv"].copy_(new.conv)
        return x + y, 0.0
    if kind == "attn":
        x = x + _self_attn(cfg, lp["attn"], h, positions, theta, window,
                           None if cache is None else cache["self"],
                           paged=paged, ring=ring, qmm=qmm, causal=causal)
        if "xattn" in lp:
            hx = _apply_norm(cfg, lp["ln_x"], x)
            x = x + _cross_attn(cfg, lp["xattn"], hx, memory, impl)
    else:
        st = None if cache is None else cache["rglru"]
        y, new = rglru_block(lp["rglru"], h,
                             state=None if st is None else RGLRUState(**st),
                             single_step=(ring is not None
                                          and ring["single_step"]),
                             impl=impl)
        if st is not None:
            st["h"].copy_(new.h)
            st["conv"].copy_(new.conv)
        x = x + y
        qmm = None
    h2 = _apply_norm(cfg, lp["ln2"], x)
    f, aux = _ffn(cfg, lp, h2, qmm, with_aux=with_aux)
    return x + f, aux


# ----------------------------------------------------------------------
# the Model
# ----------------------------------------------------------------------

class Model:
    """Decoder stack (self-attention / cross-attention / RG-LRU / SSD
    layers), with Whisper's encoder, over a ModelConfig."""

    def __init__(self, cfg: ModelConfig) -> None:
        kinds = cfg.layer_kinds
        unknown = sorted(set(kinds) - {"attn", "xattn", "rglru", "ssd"})
        if unknown:
            raise ValueError(f"arch {cfg.name!r}: unknown layer kinds "
                             f"{unknown}")
        self.cfg = cfg
        self.kinds = kinds
        self.uniform = cfg.uniform
        self.decoder_cross = cfg.is_encoder_decoder
        #: the ``Request.extra`` input the model attends to, if any
        self.memory_input = ("frames" if cfg.is_encoder_decoder
                             else "image_embeds" if cfg.cross_attn_every
                             else None)
        # a periodic pattern of at least two periods (RecurrentGemma's
        # (R, R, A), Llama-3.2-Vision's (4 attn, 1 xattn)) keeps its
        # layers as super-blocks plus a tail
        self.block_period = 0
        if not self.uniform:
            p = len(cfg.block_pattern) or cfg.cross_attn_every
            if p and cfg.n_layers >= 2 * p:
                self.block_period = p
        self.n_full_blocks = (cfg.n_layers // self.block_period
                              if self.block_period else 0)
        self.n_tail = (cfg.n_layers - self.n_full_blocks * self.block_period
                       if self.block_period else cfg.n_layers)
        #: quantized-matmul hook (``repro_torch.quant.make_qmm``), set by
        #: ``ModelRunner`` under ``--quant q4``; None = dense ``x @ w``
        self.qmm = None

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Random parameters drawn from ``gen``, on ``gen.device``, in the
        reference's layout (see the module docstring)."""
        cfg = self.cfg
        dev = gen.device
        params: Params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                cfg.dtype, device=dev),
            "final_norm": _init_norm(cfg, cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                           cfg.dtype, device=dev)
        if self.uniform:
            params["layers"] = _init_layer(gen, cfg, self.kinds[0],
                                           (cfg.n_layers,),
                                           decoder_cross=self.decoder_cross)
        elif self.block_period:
            p_, nb = self.block_period, self.n_full_blocks
            params["layers"] = {
                "blocks": [_init_layer(gen, cfg, self.kinds[j], (nb,))
                           for j in range(p_)],
                "tail": [_init_layer(gen, cfg, self.kinds[nb * p_ + t])
                         for t in range(self.n_tail)]}
        else:
            params["layers"] = [_init_layer(gen, cfg, kind)
                                for kind in self.kinds]
        if cfg.is_encoder_decoder:
            enc_cfg = dataclasses.replace(cfg, n_experts=0)
            params["encoder"] = {
                "layers": _init_layer(gen, enc_cfg, "attn",
                                      (cfg.n_encoder_layers,)),
                "final_norm": _init_norm(cfg, cfg.d_model, dev)}
        return params

    # ------------------------------------------------------------------
    def _layer_cache(self, kind: str, batch: int, cache_len: int,
                     device: Any, lead: tuple = ()) -> Dict[str, Any]:
        cfg = self.cfg
        if kind == "xattn":
            return {}
        if kind == "attn":
            shape = lead + (batch, cache_len, cfg.n_kv_heads,
                            cfg.resolved_head_dim)
            return {"self": {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "pos": torch.full(lead + (cache_len,), -1,
                                  dtype=torch.int32, device=device)}}
        if kind == "ssd":
            d_inner = cfg.ssm_heads * cfg.ssm_head_dim
            conv_ch = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            return {"ssd": {
                "state": torch.zeros(lead + (batch, cfg.ssm_heads,
                                             cfg.ssm_head_dim,
                                             cfg.ssm_state),
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1,
                                            conv_ch),
                                    dtype=cfg.dtype, device=device)}}
        width = cfg.lru_width or cfg.d_model
        return {"rglru": {
            "h": torch.zeros(lead + (batch, width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, width),
                                dtype=cfg.dtype, device=device)}}

    def init_cache(self, batch: int, max_len: int, *,
                   cache_len: Optional[int] = None,
                   memory_len: int = 0,
                   page_size: Optional[int] = None,
                   n_pages: Optional[int] = None,
                   kv_dtype: str = "fp32",
                   device: Any = "cuda") -> Dict[str, Any]:
        """Zero cache on ``device``.

        Without ``page_size``: the **ring** cache of the bucket engine,
        in the parameters' layout (uniform stack, super-blocks + tail, or
        list).  Each attention layer holds ``k``/``v`` (batch, M, Hkv, D)
        in ``cfg.dtype`` and ``pos`` (M,) int32 (-1 = empty slot), with
        M = ``min(cache_len or max_len, max_len)``: ``cache_len <
        max_len`` makes it a sliding ring.  Each RG-LRU layer holds
        ``h`` (batch, W) float32 and ``conv`` (batch, conv_width-1, W);
        each SSD layer ``state`` (batch, H, P, N) float32 and ``conv``
        (batch, conv_width-1, d_inner + 2·G·N).  ``length`` is a 0-d
        int32 tensor (tokens seen).  A cross-attention layer holds
        nothing: ``prefill`` stores the memory it attends to as
        ``memory`` (batch, M, d_model), in the type it came in;
        ``memory_len`` allocates that entry at zero in ``cfg.dtype``; it
        exists for signature parity with the reference only, since
        ``prefill`` replaces the entry whole.

        With ``page_size``: the **paged** cache of the continuous engine,
        uniform self-attention stacks without cross-attention only (as in
        the reference):

        * ``layers[i]['self']['k'/'v']`` — (n_pages * page_size, Hkv, D)
          page-pool buffer of layer ``i`` in ``cfg.dtype`` (page 0 is
          reserved scratch: idle batch slots and padded prefill
          positions write there).  A Python list of independent
          buffers, updated in place row by row.
        * ``block_tables`` — (batch, ceil(max_len / page_size)) int32,
          the physical page of each slot's logical page (0 = unmapped),
          owned by the host-side allocator (``serving.kv_pool``).

        ``kv_dtype="int8"`` (``--kv-dtype int8``) makes ``k``/``v`` int8
        code buffers and adds ``k_scale``/``v_scale`` ((rows, Hkv) f32,
        one scale per token row per kv head, ``repro_torch.quant.kv_int8``);
        ``"fp32"`` keeps the pages in ``cfg.dtype``.  ``batch`` is the
        number of running-batch *slots*.
        """
        cfg = self.cfg
        if kv_dtype != "fp32" and page_size is None:
            raise ValueError("kv_dtype applies to the paged cache only "
                             "(pass page_size=...)")
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r}: choose 'fp32' or "
                             "'int8'")
        if page_size is None:
            cache = self._init_ring_cache(batch, max_len, cache_len, device)
            if memory_len:
                cache["memory"] = torch.zeros(
                    (batch, memory_len, cfg.d_model), dtype=cfg.dtype,
                    device=device)
            return cache
        if not (self.uniform and self.kinds[0] == "attn"
                and not self.decoder_cross and not cfg.cross_attn_every):
            raise NotImplementedError(
                "paged KV cache requires a uniform self-attention stack "
                f"(arch {cfg.name!r} has kinds {self.kinds[:4]})")
        max_pages = -(-max_len // page_size)
        if n_pages is None:
            n_pages = 1 + batch * max_pages       # page 0 is scratch
        rows = n_pages * page_size
        shape = (rows, cfg.n_kv_heads, cfg.resolved_head_dim)

        def layer() -> Dict[str, Any]:
            if kv_dtype == "int8":
                buf = {n: torch.zeros(shape, dtype=torch.int8, device=device)
                       for n in ("k", "v")}
                buf.update({n: torch.zeros(shape[:2], dtype=torch.float32,
                                           device=device)
                            for n in ("k_scale", "v_scale")})
                return {"self": buf}
            return {"self": {
                n: torch.zeros(shape, dtype=cfg.dtype, device=device)
                for n in ("k", "v")}}

        return {
            "block_tables": torch.zeros((batch, max_pages),
                                        dtype=torch.int32, device=device),
            "layers": [layer() for _ in range(cfg.n_layers)],
        }

    def _init_ring_cache(self, batch: int, max_len: int,
                         cache_len: Optional[int],
                         device: Any) -> Dict[str, Any]:
        cfg = self.cfg
        cl = min(cache_len or max_len, max_len)
        cache: Dict[str, Any] = {
            "length": torch.zeros((), dtype=torch.int32, device=device)}
        if self.uniform:
            cache["layers"] = self._layer_cache(self.kinds[0], batch, cl,
                                                device, (cfg.n_layers,))
        elif self.block_period:
            p_, nb = self.block_period, self.n_full_blocks
            cache["layers"] = {
                "blocks": [self._layer_cache(self.kinds[j], batch, cl,
                                             device, (nb,))
                           for j in range(p_)],
                "tail": [self._layer_cache(self.kinds[nb * p_ + t], batch,
                                           cl, device)
                         for t in range(self.n_tail)]}
        else:
            cache["layers"] = [self._layer_cache(kind, batch, cl, device)
                               for kind in self.kinds]
        return cache

    # ------------------------------------------------------------------
    def _layer_params(self, layers: Any) -> list:
        """Every layer's parameter tree in layer order, for the three
        layouts; a stacked leaf is split with one ``torch.unbind``
        (:func:`_unstack`)."""
        if self.uniform:
            return _unstack(layers, self.cfg.n_layers)
        if self.block_period:
            p_, nb = self.block_period, self.n_full_blocks
            blocks = [_unstack(layers["blocks"][j], nb) for j in range(p_)]
            return ([blocks[j][b] for b in range(nb) for j in range(p_)]
                    + list(layers["tail"]))
        return list(layers)

    def _cache_view(self, caches: Any, i: int) -> Any:
        """Layer ``i``'s cache (None without one); a uniform stack's cache
        may also be the paged cache's per-layer list.  Stacked entries
        are views, so in-place cache writes land in the stacked
        buffers."""
        if caches is None:
            return None
        if self.uniform:
            return (caches[i] if isinstance(caches, list)
                    else _index_tree(caches, i))
        if self.block_period:
            p_, nb = self.block_period, self.n_full_blocks
            if i < nb * p_:
                return _index_tree(caches["blocks"][i % p_], i // p_)
            return caches["tail"][i - nb * p_]
        return caches[i]

    def _layer_views(self, layers: Any, caches: Any):
        """``(i, layer params, layer cache)`` in layer order, for the
        three layouts (the cache None where ``caches`` is None)."""
        for i, lp in enumerate(self._layer_params(layers)):
            yield i, lp, self._cache_view(caches, i)

    def _remat_groups(self) -> list:
        """The layers ``cfg.remat`` checkpoints together, as the
        reference's scans do: each layer of a uniform stack or a list,
        each super-block of the block layout; the block layout's tail
        layers are not checkpointed (the reference runs them outside its
        checkpointed scan)."""
        n = self.cfg.n_layers
        if not self.block_period:
            return [[i] for i in range(n)]
        p_, nb = self.block_period, self.n_full_blocks
        return [list(range(b * p_, (b + 1) * p_)) for b in range(nb)]

    def _run_layers(self, params: Params, x: torch.Tensor,
                    positions: torch.Tensor, caches: Any, *,
                    window_override: Optional[int],
                    memory: Optional[torch.Tensor] = None,
                    paged: Optional[Dict[str, Any]] = None,
                    ring: Optional[Dict[str, Any]] = None,
                    with_aux: bool = False,
                    ) -> Tuple[torch.Tensor, Any]:
        """Unrolled layer loop; each layer updates its cache in place, and
        the cross-attention layers attend to ``memory``.  Returns (x, the
        stack's summed router aux loss: 0.0 without MoE layers or without
        ``with_aux``; the serving steps discard it, so they leave it
        off).  ``caches=None`` is the training path: no cache, and under
        autograd with ``cfg.remat`` each of :meth:`_remat_groups` is
        checkpointed (``torch.utils.checkpoint``; the reference's
        ``save_only_these_names("block_out")`` policy has no torch form,
        and plain checkpointing computes the same values)."""
        cfg = self.cfg
        windows = list(cfg.layer_windows(0))
        thetas = list(cfg.layer_thetas())
        if window_override is not None:
            windows = [window_override] * cfg.n_layers
        views = list(self._layer_views(params["layers"], caches))

        def run(idx, x):
            aux = 0.0
            for i in idx:
                _, lp, cache = views[i]
                x, a = _layer_forward(cfg, self.kinds[i], lp, x, positions,
                                      thetas[i], windows[i], cache,
                                      memory=memory, paged=paged, ring=ring,
                                      qmm=self.qmm, with_aux=with_aux)
                aux = aux + a
            return x, aux

        aux = 0.0
        if caches is None and cfg.remat and torch.is_grad_enabled():
            groups = self._remat_groups()
            done = 0
            for idx in groups:
                x, a = checkpoint(run, idx, x, use_reentrant=False)
                aux = aux + a
                done = idx[-1] + 1
            x, a = run(range(done, cfg.n_layers), x)
            return x, aux + a
        return run(range(cfg.n_layers), x)

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over the frame embeddings (B, F, d): its
        stacked layers, bidirectional, no window, RoPE at
        ``cfg.rope_theta``, no cache, then its final norm.  Float32
        frames keep the residual stream and the output float32 over
        ``cfg.dtype`` weights, as in the reference."""
        cfg = self.cfg
        enc = params["encoder"]
        positions = torch.arange(frames.shape[1], device=frames.device)
        x = frames
        for lp in _unstack(enc["layers"], cfg.n_encoder_layers):
            x, _ = _layer_forward(cfg, "attn", lp, x, positions,
                                  cfg.rope_theta, 0, None, causal=False)
        return _apply_norm(cfg, enc["final_norm"], x)

    def _memory_from_batch(self, params: Params, batch: Dict[str, Any],
                           ) -> Optional[torch.Tensor]:
        """What the cross-attention layers attend to: the encoder's output
        over ``batch['frames']``, or ``batch['image_embeds']`` as given."""
        if self.memory_input is None:
            return None
        memory = batch[self.memory_input]
        return (self._encode(params, memory) if self.cfg.is_encoder_decoder
                else memory)

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        # JAX clamps out-of-range gathers; torch would raise, so clamp
        ids = tokens.long().clamp(0, self.cfg.vocab_size - 1)
        return params["embed"][ids]

    def _head(self, params: Params) -> torch.Tensor:
        return (params["embed"] if self.cfg.tie_embeddings
                else params["lm_head"])

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = _apply_norm(self.cfg, params["final_norm"], x)
        return unembed(self._head(params), x, tied=self.cfg.tie_embeddings)

    # ------------------------------------------------------------------
    def _hidden_states(self, params: Params, batch: Dict[str, Any],
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final-normed hidden states (B, S, d) of ``batch['tokens']``
        over the cache-less stack, and the summed router aux loss (a 0-d
        float32 tensor, 0 without MoE layers)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        memory = self._memory_from_batch(params, batch)
        x, aux = self._run_layers(params, x, positions, None,
                                  window_override=None, memory=memory,
                                  with_aux=True)
        if not isinstance(aux, torch.Tensor):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return _apply_norm(self.cfg, params["final_norm"], x), aux

    def forward(self, params: Params, batch: Dict[str, Any],
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forcing logits (B, S, V) over the whole sequence, and
        the router aux loss (training)."""
        h, aux = self._hidden_states(params, batch)
        return unembed(self._head(params), h,
                       tied=self.cfg.tie_embeddings), aux

    LOSS_CHUNK = 512

    def loss(self, params: Params, batch: Dict[str, Any],
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Chunked cross entropy of ``batch['labels']`` (-100 masked) plus
        ``cfg.router_aux_coef`` x the router aux loss; returns (total,
        ``{"ce", "aux"}``).  The logits exist one LOSS_CHUNK of the
        sequence at a time, in float32, as in the reference (the sequence
        is padded to whole chunks with -100 labels): the full (B, S, V)
        float32 logits of a 150k-vocabulary model would dwarf every other
        activation."""
        h, aux = self._hidden_states(params, batch)
        head = self._head(params)
        labels = batch["labels"].long()
        B, S, d = h.shape
        C = min(self.LOSS_CHUNK, S)
        pad = (-S) % C
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-100)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, S + pad, C):
            chunk = unembed(head, h[:, c0:c0 + C],
                            tied=self.cfg.tie_embeddings)
            s_i, n_i = nll_sum(chunk, labels[:, c0:c0 + C])
            total = total + s_i
            count = count + n_i
        ce = total / torch.clamp(count, min=1.0)
        return ce + self.cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

    def prefill(self, params: Params, batch: Dict[str, Any],
                cache: Dict[str, Any], *,
                window_override: Optional[int] = None, impl: str = "auto",
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process the prompts ``batch['tokens']`` (B, S) at positions
        0..S-1 into a fresh ring cache; return the last token's logits
        (B, 1, V).  A cross-attention model reads its memory from
        ``batch['image_embeds']`` (B, M, d) or encodes
        ``batch['frames']`` (B, F, d) here, once, and keeps it as
        ``cache['memory']`` for the decode steps.  ``impl`` picks the
        RG-LRU scan ("auto": the kernel on CUDA tensors; "ref": the plain
        version)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        ring = {"q_pos": None, "single_step": False, "impl": impl}
        memory = self._memory_from_batch(params, batch)
        x, _ = self._run_layers(params, x, positions, cache["layers"],
                                window_override=window_override,
                                memory=memory, ring=ring)
        cache["length"].fill_(tokens.shape[1])
        if memory is not None:
            cache["memory"] = memory
        return self._logits(params, x[:, -1:]), cache

    def prefill_paged(self, params: Params, batch: Dict[str, Any],
                      cache: Dict[str, Any], slot: int, plen: int, *,
                      page_size: int, start: Optional[int] = None,
                      ctx_pages: Optional[int] = None,
                      window_override: Optional[int] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill ONE sequence chunk into batch slot ``slot``.

        ``batch['tokens']`` is (1, Sp) right-padded; ``plen`` is the real
        chunk length.  K/V rows land in the physical pages
        ``cache['block_tables'][slot]`` maps; padded rows go to the
        scratch page.  Returns the logits of the last real token (1, 1,
        V).  ``start`` resumes at absolute position ``start`` (chunked
        prefill, prefix-cache hit): attention then runs over the resident
        context ``[0, start + plen)`` gathered from the first
        ``ctx_pages`` pages of the block table.  ``start=None`` is the
        one-shot fresh path.
        """
        tokens = batch["tokens"]
        dev = tokens.device
        Sp = tokens.shape[1]
        x = self._embed(params, tokens)
        offsets = torch.arange(Sp, device=dev)
        bt_row = cache["block_tables"][slot].long()
        max_pages = bt_row.shape[0]
        positions = offsets if start is None else int(start) + offsets
        # a padded bucket may run past max_pages * page_size: clamp the
        # block-table read (JAX clamps implicitly) and send every padding
        # row to the scratch page, so the clamped last page is never hit
        page_idx = (positions // page_size).clamp(max=max_pages - 1)
        phys = bt_row[page_idx] * page_size + positions % page_size
        write_slots = torch.where(offsets < plen, phys, offsets % page_size)
        paged: Dict[str, Any] = {"page_size": page_size,
                                 "write_slots": write_slots}
        if start is not None:
            if ctx_pages is None:
                raise ValueError("resumed prefill needs ctx_pages")
            ctx_pos = torch.arange(ctx_pages * page_size, device=dev)
            ctx_idx = (ctx_pos // page_size).clamp(max=max_pages - 1)
            paged["prefill_ctx"] = {
                "phys": bt_row[ctx_idx] * page_size + ctx_pos % page_size,
                "kv_len": int(start) + int(plen),
                "q_offset": int(start),
            }
        x, _ = self._run_layers(params, x, positions, cache["layers"],
                                window_override=window_override,
                                paged=paged)
        last = min(max(int(plen) - 1, 0), Sp - 1)
        return self._logits(params, x[:, last:last + 1]), cache

    def decode_step(self, params: Params, cache: Dict[str, Any],
                    tokens: torch.Tensor, pos: Any, *,
                    window_override: Optional[int] = None,
                    page_size: Optional[int] = None, impl: str = "auto",
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step.  tokens (B, 1).

        Ring cache: ``pos`` is the *scalar* absolute position (a host
        int) shared by the whole lockstep batch.  Paged cache
        (``page_size`` given): ``pos`` (B,) is each slot's absolute
        position, ``pos[b] < 0`` marks an idle slot (its write goes to
        the scratch page, its attention is fully masked).  ``impl``
        picks the decode attention, of the ring and of the memory in
        ``cache['memory']`` alike ("auto": the kernel on CUDA tensors;
        "ref": the plain version)."""
        if page_size is not None:
            return self._decode_step_paged(params, cache, tokens, pos,
                                           page_size=page_size,
                                           window_override=window_override,
                                           impl=impl)
        pos = int(pos)
        x = self._embed(params, tokens)
        positions = torch.arange(pos, pos + 1, device=tokens.device)
        ring = {"q_pos": pos, "single_step": True, "impl": impl}
        x, _ = self._run_layers(params, x, positions, cache["layers"],
                                window_override=window_override,
                                memory=cache.get("memory"), ring=ring)
        cache["length"].fill_(pos + 1)
        return self._logits(params, x), cache

    def _decode_step_paged(self, params: Params, cache: Dict[str, Any],
                           tokens: torch.Tensor, pos: torch.Tensor, *,
                           page_size: int,
                           window_override: Optional[int] = None,
                           impl: str = "auto",
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        bt = cache["block_tables"]
        positions, write_slots, kv_len = _paged_slots(bt, pos.long(), 1,
                                                      page_size)
        paged = {"page_size": page_size, "write_slots": write_slots,
                 "block_tables": bt, "kv_len": kv_len, "impl": impl}
        x, _ = self._run_layers(params, self._embed(params, tokens),
                                positions, cache["layers"],
                                window_override=window_override,
                                paged=paged)
        return self._logits(params, x), cache

    def verify_step(self, params: Params, cache: Dict[str, Any],
                    tokens: torch.Tensor, pos: torch.Tensor,
                    n_fed: torch.Tensor, *, page_size: int,
                    window_override: Optional[int] = None,
                    impl: str = "auto",
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Speculative multi-token verify against the paged cache.

        ``tokens`` (B, S) feeds each lane its last sampled token plus up
        to S - 1 draft tokens; ``pos`` (B,) is the absolute position of
        column 0 (the fed token's, as in decode; ``pos[b] < 0`` marks an
        idle lane); ``n_fed`` (B,) counts the lane's real leading columns
        (1 = plain decode riding along).  Idle lanes and columns at or
        past ``n_fed`` write to the scratch page; their logits are
        garbage the caller ignores.

        Returns logits (B, S, V): column j scores position ``pos + j``
        over exactly the rows a sequential decode step there would read
        (``kv_len = pos + 1 + j``), so its argmax is the token the
        non-speculative engine emits after accepting j drafts.  ``impl``
        picks the attention read as in :meth:`decode_step`.
        """
        bt = cache["block_tables"]
        positions, write_slots, kv_len = _paged_slots(
            bt, pos.long(), tokens.shape[1], page_size, n_fed.long())
        paged = {"page_size": page_size, "write_slots": write_slots,
                 "block_tables": bt, "kv_len": kv_len, "verify": True,
                 "impl": impl}
        x, _ = self._run_layers(params, self._embed(params, tokens),
                                positions, cache["layers"],
                                window_override=window_override,
                                paged=paged)
        return self._logits(params, x), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
