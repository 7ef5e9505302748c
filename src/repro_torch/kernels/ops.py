"""Dispatch wrappers for the port's kernels (``repro.kernels.ops``).

A CPU tensor goes to the kernel's plain version (``kernels.ref``); a
CUDA tensor goes to the hand-written kernel, which launches or raises.
``impl="ref"`` asks for the plain version on any device (tests and
``chip_smoke.py`` use it to hold the kernel against it).
"""

from __future__ import annotations

import torch

from . import ref as _ref
from .decode_attention import paged_decode_attention as _paged_kernel


def paged_gqa_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               kv_lens: torch.Tensor, window: int = 0, *,
                               page_size: int, softcap: float = 0.0,
                               impl: str = "auto", k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """Paged flash-decoding for one token per sequence with GQA.

    q (B,1,Hq,D); k_pool,v_pool (n_pages*page_size,Hkv,D) — ONE layer's
    flat page-pool buffer, as ``Model.init_cache(page_size=...)`` holds
    it; the paged view is a free reshape.  block_tables (B,max_pages)
    int32; kv_lens (B,) int32 -> out (B,1,Hq,D) in ``q.dtype``.  Query
    head h reads kv head h // G.

    ``k_scale``/``v_scale`` ((n_pages*page_size, Hkv) f32) select the
    int8 page format.  Only the plain version reads it, so CPU tensors
    only: on CUDA tensors it raises, since the int8 kernel variant is
    not ported yet.

    Kernel launches are counted on
    ``repro_torch.kernels.decode_attention.paged_decode_attention.launches``.
    """
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl={impl!r}: choose 'auto' or 'ref'")
    B, one, Hq, D = q.shape
    Hkv = k_pool.shape[1]
    G = Hq // Hkv
    n_pages = k_pool.shape[0] // page_size
    k_pages = k_pool.view(n_pages, page_size, Hkv, D)
    v_pages = v_pool.view(n_pages, page_size, Hkv, D)
    qk = q.reshape(B, Hkv, G, D)
    if k_scale is not None or v_scale is not None:
        if q.is_cuda:
            raise NotImplementedError(
                "int8 pages: the CUDA kernel variant is not ported yet")
        out = _ref.paged_decode_attention_ref(
            qk, k_pages, v_pages, block_tables, kv_lens, window,
            softcap=softcap,
            k_scales=k_scale.view(n_pages, page_size, Hkv),
            v_scales=v_scale.view(n_pages, page_size, Hkv))
    elif impl == "ref" or not q.is_cuda:
        out = _ref.paged_decode_attention_ref(qk, k_pages, v_pages,
                                              block_tables, kv_lens,
                                              window, softcap=softcap)
    else:
        out = _paged_kernel(qk, k_pages, v_pages, block_tables, kv_lens,
                            window, softcap=softcap)
    # a no-op on the kernel's output, which is already in q.dtype
    return out.reshape(B, 1, Hq, D).to(q.dtype)
