"""Attention: blockwise (flash-style) plain PyTorch implementation.

Counterpart of ``repro.models.attention``: online softmax over KV
chunks (a Python loop in place of ``lax.scan``) keeps the score block
at O(Sq·chunk), GQA folds the query-head group into the einsum, and
sliding windows, causal masking, query and key position offsets, a
global ``kv_len``, explicit per-slot key positions (ring caches; < 0 =
empty) and a ``tanh`` logit softcap ride along as masks.  Prefill and
resumed-prefill attention of both serving paths run through here;
decode goes to the decode kernels (``repro_torch.kernels.ops``).

Sequence-sharded decode (``launch.shardings.make_decode_attn_hook``):
each rank runs the blockwise attention over its slice of the ring and
keeps the un-normalised state (``return_partial=True``, an
:class:`AttnPartial`); :func:`combine_partials` merges the ranks' states
with one LSE-weighted reduction, ArcLight's Gather applied to the
sequence axis.

This is plain tensor code, not a kernel: the reference computes it with
jnp outside any Pallas kernel.  A hand-written prefill kernel is later
work; nothing here calls ``scaled_dot_product_attention``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Union

import torch

#: finite "minus infinity": a fully-masked row keeps finite state and
#: the first real score resets it through alpha = exp(NEG_INF - m) = 0
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class AttnPartial(NamedTuple):
    """Un-normalised blockwise attention state (for a cross-rank merge)."""

    out: torch.Tensor    # (B, Sq, Hq, D) float32, = sum exp(s - m) v
    m: torch.Tensor      # (B, Sq, Hq) running max
    lsum: torch.Tensor   # (B, Sq, Hq) running denominator


def _chunk_mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
                window: int, kv_len: Optional[int],
                kpos_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Sq, C) validity mask. window: 0 = unlimited."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    if kv_len is not None:
        m &= kpos[None, :] < kv_len
    if kpos_valid is not None:
        m &= kpos_valid[None, :]
    return m


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_offset: int = 0, kv_len: Optional[int] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    chunk: int = 512, softcap: float = 0.0,
                    scale: Optional[float] = None,
                    return_partial: bool = False,
                    ) -> Union[torch.Tensor, AttnPartial]:
    """Blockwise attention.

    q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D); Hq % Hkv == 0.  ``q_offset`` is
    the absolute position of q[0]; ``kv_offset`` that of k[0];
    ``kv_len`` the number of valid kv tokens (positions >= kv_len are
    masked).  ``kv_positions`` (Skv,) gives every kv slot's absolute
    position (ring caches): entries < 0 are masked, and it overrides the
    ``kv_offset`` arithmetic.  Scores and the softmax state are float32;
    the output is cast to ``q.dtype``.  ``return_partial=True`` returns
    the :class:`AttnPartial` instead: ``out`` left un-normalised, ``m``
    and ``lsum`` of shape (B, Sq, Hq), all float32.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not divisible by Hkv={Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    window = int(window)
    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    dev = q.device
    if pad and kv_positions is not None:
        # padded slots are empty ring slots
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-1)
    elif pad and kv_len is None:
        # the zero padding below must stay masked: this block's valid
        # range ends at kv_offset + Skv
        kv_len = kv_offset + Skv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    qpos = q_offset + torch.arange(Sq, device=dev)
    out = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kc = k[:, ci * chunk:(ci + 1) * chunk].float()
        vc = v[:, ci * chunk:(ci + 1) * chunk].float()
        pad = chunk - kc.shape[1]
        if pad:
            kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
        if kv_positions is not None:
            kpos = kv_positions[ci * chunk:(ci + 1) * chunk].to(dev).long()
            kvalid = kpos >= 0
        else:
            kpos = kv_offset + ci * chunk + torch.arange(chunk, device=dev)
            kvalid = None
        s = torch.einsum("bqhgd,bchd->bqhgc", qg, kc) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = _chunk_mask(qpos, kpos, causal=causal, window=window,
                           kv_len=kv_len, kpos_valid=kvalid)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(dim=-1)
        out = out * alpha[..., None] + torch.einsum("bqhgc,bchd->bqhgd",
                                                    p, vc)
        m = m_new
    out = out.reshape(B, Sq, Hq, D)
    lsum = lsum.reshape(B, Sq, Hq)
    if return_partial:
        return AttnPartial(out=out, m=m.reshape(B, Sq, Hq), lsum=lsum)
    safe_l = torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    return (out / safe_l[..., None]).to(q.dtype)


def combine_partials(p: AttnPartial, mesh: Any, axes: Any,
                     out_dtype: Any) -> torch.Tensor:
    """Merge the ranks' blockwise partials over ``axes`` (a mesh axis or
    a tuple of them): the sequence-sharded flash-decoding Gather.  One
    all-reduce MAX of ``m``, then one SUM of ``out * w`` and one of
    ``lsum * w`` with ``w = exp(m - max)``, through ``core.tp``'s
    wrappers (so ``collective_ops_in`` counts them)."""
    from ..core.tp import all_reduce     # core.tp imports models: a cycle
    m_glob = all_reduce(p.m.clone(), mesh, axes, op="max")
    w = torch.exp(p.m - m_glob)
    num = all_reduce(p.out * w[..., None], mesh, axes)
    den = all_reduce(p.lsum * w, mesh, axes)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (num / den[..., None]).to(out_dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_len: Optional[int] = None,
                        softcap: float = 0.0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """O(S²) dense oracle for tests."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = q_offset + torch.arange(Sq, device=dev)
    kpos = torch.arange(Skv, device=dev)
    mask = _chunk_mask(qpos, kpos, causal=causal, window=int(window),
                       kv_len=kv_len)
    s = torch.where(mask[None, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
