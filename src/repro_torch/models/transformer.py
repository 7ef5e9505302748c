"""Transformer: the paged serving subset of ``repro.models.transformer``.

``build_model(cfg)`` returns a :class:`Model` exposing

    init(gen)                                  -> params
    init_cache(B, max_len, page_size=..., kv_dtype="fp32"|"int8")
                                               -> paged cache (zeros)
    prefill_paged(params, batch, cache, slot, plen, page_size=...)
                                               -> (logits, cache)
    decode_step(params, cache, tokens, pos, page_size=...)
                                               -> (logits, cache)

for uniform dense self-attention stacks (every layer "attn" with an MLP
FFN: Qwen3, Gemma3, the bench-tiny model).  Per-layer sliding window and
RoPE base stay metadata (``cfg.layer_windows`` / ``cfg.layer_thetas``),
so Gemma3's 5:1 local:global pattern is one uniform stack.

Parameters are a dict tree with the reference's keys and layout: uniform
layer stacks keep a leading L axis, projections are ``(d_in, d_out)``
applied as ``x @ w``.  ``repro_torch.models.weights`` converts the
reference's ``Model.init`` tree, so both packages compute the same
function in the tests.

The paged cache (see :meth:`Model.init_cache`) is a list of per-layer
page-pool buffers.  Where the reference returns new buffers from a
donated jit call, this port writes the touched rows **in place**
(``index_copy_``); the cache dict is returned for API parity.

Quantized serving: ``Model.qmm`` (default ``None``) is the reference's
quantized-matmul hook.  ``ModelRunner`` installs
``repro_torch.quant.make_qmm`` there under ``--quant q4``, and every
attention and MLP projection then goes through it (the Q4_0 kernel on
the card).  ``init_cache(kv_dtype="int8")`` allocates int8 pages with
per-(row, kv head) f32 scales (``repro_torch.quant.kv_int8``).

Not part of this slice (each raises ``NotImplementedError`` naming the
arch or feature): the ring-buffer cache and its ``prefill`` /
scalar-position ``decode_step``, MoE, recurrent / SSM and cross-attention
layers, encoder-decoder stacks and ``verify_step``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..kernels.ops import paged_gqa_decode_attention
from ..quant.kv_int8 import dequantize_rows, quantize_rows
from .attention import flash_attention
from .common import (Params, dense_init, embed_init, mlp, proj, rms_norm,
                     unembed)
from .config import ModelConfig

ATTN_CHUNK = 512


def _index_tree(tree: Any, i: int) -> Any:
    """``tree`` with every leaf indexed by ``i`` (one layer of a stack)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ----------------------------------------------------------------------
# parameter init
# ----------------------------------------------------------------------

def _init_norm(cfg: ModelConfig, d: int, device: Any,
               lead: tuple = ()) -> Params:
    return {"g": torch.zeros(lead + (d,), dtype=cfg.dtype, device=device)}


def _init_attn(gen: torch.Generator, cfg: ModelConfig, lead: tuple) -> Params:
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


def _self_attn(cfg: ModelConfig, ap: Params, x: torch.Tensor,
               positions: torch.Tensor, theta: float, window: int,
               cache: Dict[str, torch.Tensor],
               paged: Dict[str, Any], qmm=None) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, ap, x, x, qmm)
    q = _rope(q, positions, theta)
    k = _rope(k, positions, theta)
    out = _paged_attn(cfg, q, k, v, window, cache, paged)
    return proj(out.reshape(B, S, -1), ap["w_o"], qmm)


def _ffn(cfg: ModelConfig, lp: Params, x: torch.Tensor,
         qmm=None) -> torch.Tensor:
    return mlp(lp["mlp"], x, cfg.act, qmm)


def _layer_forward(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                   positions: torch.Tensor, theta: float, window: int,
                   cache: Dict[str, Any], paged: Dict[str, Any],
                   qmm=None) -> torch.Tensor:
    """One pre-norm block: x + attn(norm(x)), then x + mlp(norm(x))."""
    h = rms_norm(x, lp["ln1"]["g"], cfg.norm_eps)
    x = x + _self_attn(cfg, lp["attn"], h, positions, theta, window,
                       cache["self"], paged, qmm)
    h2 = rms_norm(x, lp["ln2"]["g"], cfg.norm_eps)
    return x + _ffn(cfg, lp, h2, qmm)


# ----------------------------------------------------------------------
# the Model
# ----------------------------------------------------------------------

class Model:
    """Uniform dense self-attention stack over a ModelConfig."""

    def __init__(self, cfg: ModelConfig) -> None:
        kinds = cfg.layer_kinds
        if cfg.is_encoder_decoder or any(k != "attn" for k in kinds):
            raise NotImplementedError(
                f"arch {cfg.name!r} has layer kinds {sorted(set(kinds))} "
                f"(encoder-decoder={cfg.is_encoder_decoder}); the port "
                "serves uniform self-attention stacks only")
        if cfg.n_experts:
            raise NotImplementedError(
                f"arch {cfg.name!r}: MoE layers are not ported yet")
        self.cfg = cfg
        #: quantized-matmul hook (``repro_torch.quant.make_qmm``), set by
        #: ``ModelRunner`` under ``--quant q4``; None = dense ``x @ w``
        self.qmm = None

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Random parameters drawn from ``gen``, on ``gen.device``."""
        cfg = self.cfg
        dev = gen.device
        lead = (cfg.n_layers,)
        params: Params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                cfg.dtype, device=dev),
            "final_norm": _init_norm(cfg, cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                           cfg.dtype, device=dev)
        params["layers"] = {
            "ln1": _init_norm(cfg, cfg.d_model, dev, lead),
            "attn": _init_attn(gen, cfg, lead),
            "ln2": _init_norm(cfg, cfg.d_model, dev, lead),
            "mlp": _init_mlp(gen, cfg, lead),
        }
        return params

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *,
                   page_size: Optional[int] = None,
                   n_pages: Optional[int] = None,
                   kv_dtype: str = "fp32",
                   device: Any = "cuda") -> Dict[str, Any]:
        """Zero **paged** cache for the continuous-batching engine.

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
        ``"fp32"`` keeps the pages in ``cfg.dtype``.

        ``batch`` is the number of running-batch *slots*.  The ring
        cache (``page_size=None``) is not ported yet.
        """
        cfg = self.cfg
        if kv_dtype != "fp32" and page_size is None:
            raise ValueError("kv_dtype applies to the paged cache only "
                             "(pass page_size=...)")
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r}: choose 'fp32' or "
                             "'int8'")
        if page_size is None:
            raise NotImplementedError(
                "the ring-buffer KV cache is not ported yet; pass "
                "page_size=... for the paged cache")
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

    # ------------------------------------------------------------------
    def _run_paged_layers(self, params: Params, x: torch.Tensor,
                          positions: torch.Tensor, caches: List, *,
                          window_override: Optional[int],
                          paged: Dict[str, Any]) -> torch.Tensor:
        """Unrolled layer loop over the per-layer page-pool buffers."""
        cfg = self.cfg
        windows = list(cfg.layer_windows(0))
        thetas = list(cfg.layer_thetas())
        if window_override is not None:
            windows = [window_override] * cfg.n_layers
        layers = params["layers"]
        for i in range(cfg.n_layers):
            x = _layer_forward(cfg, _index_tree(layers, i), x, positions,
                               thetas[i], windows[i], caches[i], paged,
                               self.qmm)
        return x

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        # JAX clamps out-of-range gathers; torch would raise, so clamp
        ids = tokens.long().clamp(0, self.cfg.vocab_size - 1)
        return params["embed"][ids]

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"]["g"], self.cfg.norm_eps)
        head = (params["embed"] if self.cfg.tie_embeddings
                else params["lm_head"])
        return unembed(head, x, tied=self.cfg.tie_embeddings)

    # ------------------------------------------------------------------
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
        x = self._run_paged_layers(params, x, positions, cache["layers"],
                                   window_override=window_override,
                                   paged=paged)
        last = min(max(int(plen) - 1, 0), Sp - 1)
        return self._logits(params, x[:, last:last + 1]), cache

    def decode_step(self, params: Params, cache: Dict[str, Any],
                    tokens: torch.Tensor, pos: torch.Tensor, *,
                    window_override: Optional[int] = None,
                    page_size: Optional[int] = None, impl: str = "auto",
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One paged decode step.  tokens (B, 1); ``pos`` (B,) is each
        slot's absolute position, ``pos[b] < 0`` marks an idle slot (its
        write goes to the scratch page, its attention is fully masked).
        ``impl`` picks the decode attention ("auto": the kernel on CUDA
        tensors; "ref": the plain version)."""
        if page_size is None:
            raise NotImplementedError(
                "scalar-position decode over the ring cache is not ported "
                "yet; pass page_size=... (paged cache)")
        return self._decode_step_paged(params, cache, tokens, pos,
                                       page_size=page_size,
                                       window_override=window_override,
                                       impl=impl)

    def _decode_step_paged(self, params: Params, cache: Dict[str, Any],
                           tokens: torch.Tensor, pos: torch.Tensor, *,
                           page_size: int,
                           window_override: Optional[int] = None,
                           impl: str = "auto",
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        pos = pos.long()                                  # (B,)
        safe_pos = pos.clamp(min=0)
        x = self._embed(params, tokens)                   # (B, 1, d)
        bt = cache["block_tables"]
        B, max_pages = bt.shape
        lanes = torch.arange(B, device=pos.device)
        page_idx = (safe_pos // page_size).clamp(max=max_pages - 1)
        phys = bt[lanes, page_idx].long() * page_size + safe_pos % page_size
        # idle lanes (pos < 0) MUST land on the scratch page even when
        # their slot's block table is populated (a sequence prefilled
        # this step but not decoding yet would lose its first page)
        write_slots = torch.where(pos >= 0, phys, safe_pos % page_size)
        kv_len = (pos + 1).clamp(min=0).to(torch.int32)
        paged = {"page_size": page_size, "write_slots": write_slots,
                 "block_tables": bt, "kv_len": kv_len, "impl": impl}
        x = self._run_paged_layers(params, x, safe_pos[:, None],
                                   cache["layers"],
                                   window_override=window_override,
                                   paged=paged)
        return self._logits(params, x), cache

    def verify_step(self, *args, **kwargs):
        raise NotImplementedError(
            "speculative verify (verify_step) is not ported yet")


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
