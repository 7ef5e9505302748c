"""Dispatch wrappers for the port's kernels (``repro.kernels.ops``).

A CPU tensor goes to the kernel's plain version (``kernels.ref``); a
CUDA tensor goes to the hand-written kernel, which launches or raises.
``impl="ref"`` asks for the plain version on any device (tests and
``chip_smoke.py`` use it to hold the kernel against it).
"""

from __future__ import annotations

import torch

from . import ref as _ref
from .decode_attention import decode_attention as _decode_kernel
from .decode_attention import paged_decode_attention as _paged_kernel
from .q4_gemm import q4_gemm as _q4_kernel
from .rglru_scan import rglru_scan as _rglru_kernel
from .rglru_scan import rglru_scan_reverse as _rglru_reverse_kernel


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl={impl!r}: choose 'auto' or 'ref'")


def q4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
              *, impl: str = "auto") -> torch.Tensor:
    """Quantized matmul: x (M,K) @ W_q4 (K,N) -> (M,N) in ``x.dtype``.

    ``impl``: "auto" launches the CUDA kernel on CUDA tensors and runs
    the plain version on CPU tensors; "ref" runs the plain version on
    any device; "kernel" launches the kernel and raises on CPU tensors.
    The reference returns float32 and its ``make_qmm`` casts the result
    to ``x.dtype`` at once; the kernel rounds to ``x.dtype`` itself.

    Kernel launches are counted on
    ``repro_torch.kernels.q4_gemm.q4_gemm.launches``.
    """
    if impl not in ("auto", "ref", "kernel"):
        raise ValueError(f"impl={impl!r}: choose 'auto', 'ref' or 'kernel'")
    if impl == "ref" or (impl == "auto" and not x.is_cuda):
        return _ref.q4_gemm_ref(x, packed, scales).to(x.dtype)
    return _q4_kernel(x, packed, scales)


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
    int8 page format; the kernel dequantizes in its tile, the plain
    version after its block-table gather.

    Kernel launches are counted on
    ``repro_torch.kernels.decode_attention.paged_decode_attention.launches``.
    """
    _check_impl(impl)
    B, one, Hq, D = q.shape
    Hkv = k_pool.shape[1]
    G = Hq // Hkv
    n_pages = k_pool.shape[0] // page_size
    k_pages = k_pool.view(n_pages, page_size, Hkv, D)
    v_pages = v_pool.view(n_pages, page_size, Hkv, D)
    qk = q.reshape(B, Hkv, G, D)
    scales = {}
    if k_scale is not None or v_scale is not None:
        scales = {"k_scales": k_scale.view(n_pages, page_size, Hkv),
                  "v_scales": v_scale.view(n_pages, page_size, Hkv)}
    if impl == "ref" or not q.is_cuda:
        out = _ref.paged_decode_attention_ref(qk, k_pages, v_pages,
                                              block_tables, kv_lens,
                                              window, softcap=softcap,
                                              **scales)
    else:
        out = _paged_kernel(qk, k_pages, v_pages, block_tables, kv_lens,
                            window, softcap=softcap, **scales)
    # a no-op on the kernel's output, which is already in q.dtype
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len=None, *, kv_positions=None, q_pos=None,
                         window: int = 0, softcap: float = 0.0,
                         impl: str = "auto") -> torch.Tensor:
    """Flash-decoding for one token with GQA over a contiguous cache.

    q (B,1,Hq,D); k,v (B,S,Hkv,D) -> out (B,1,Hq,D) in ``q.dtype``; query
    head h reads kv head h // G.  ``kv_len`` (host int) masks slots
    ``>= kv_len``, the TPU kernel's form; ``kv_positions`` ((S,) int32,
    -1 = empty) with ``q_pos`` (host int) is the ring cache's form, the
    mask of ``flash_attention(..., q_offset=q_pos, kv_positions=...)``.
    See ``kernels.decode_attention.decode_attention`` for both.

    Kernel launches are counted on
    ``repro_torch.kernels.decode_attention.decode_attention.launches``.
    """
    _check_impl(impl)
    B, one, Hq, D = q.shape
    Hkv = k.shape[2]
    qk = q.reshape(B, Hkv, Hq // Hkv, D)
    kw = dict(kv_positions=kv_positions, q_pos=q_pos, window=window,
              softcap=softcap)
    if impl == "ref" or not q.is_cuda:
        out = _ref.decode_attention_ref(qk, k, v, kv_len, **kw)
    else:
        out = _decode_kernel(qk, k, v, kv_len, **kw)
    # a no-op on the kernel's output, which is already in q.dtype
    return out.reshape(B, 1, Hq, D).to(q.dtype)


class _LinearScan(torch.autograd.Function):
    """The RG-LRU recurrence with its gradient.

    Forward: ``h[t] = a[t] * h[t-1] + u[t]`` (the kernel on CUDA
    tensors, ``kernels.ref`` on CPU tensors or under ``impl="ref"``).
    Backward, with ``g = dL/dh``: ``c = dL/du`` is the reverse scan
    ``c[t] = a[t+1] * c[t+1] + g[t]`` (the kernel's reverse mode, or its
    plain version), then one elementwise pass gives
    ``dL/da[t] = c[t] * h[t-1]`` (``h[-1] = h0``, or 0) and
    ``dL/dh0 = a[0] * c[0]``.  The JAX package differentiates
    ``jax.lax.associative_scan`` instead; the two agree within float32
    rounding."""

    @staticmethod
    def forward(ctx, a, u, h0, impl):
        if impl == "ref" or not a.is_cuda:
            h = _ref.rglru_scan_ref(a, u, h0)
        else:
            h = _rglru_kernel(a, u, h0)
        ctx.impl = impl
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        g = g.contiguous()
        if ctx.impl == "ref" or not g.is_cuda:
            c = _ref.rglru_scan_reverse_ref(a, g)
        else:
            c = _rglru_reverse_kernel(a, g)
        da = torch.empty_like(c)
        torch.mul(c[:, 1:], h[:, :-1], out=da[:, 1:])
        dh0 = None
        if h0 is None:
            da[:, 0] = 0.0
        else:
            torch.mul(c[:, 0], h0, out=da[:, 0])
            dh0 = a[:, 0] * c[:, 0]
        return da, c, dh0, None


def rglru_linear_scan(a: torch.Tensor, u: torch.Tensor, h0=None, *,
                      impl: str = "auto") -> torch.Tensor:
    """RG-LRU recurrence ``h[t] = a[t] * h[t-1] + u[t]`` over (B, T, W),
    ``h0`` (B, W) folded into step 0; float32 in and out, differentiable
    in ``a``, ``u`` and ``h0`` (:class:`_LinearScan`).

    Kernel launches are counted on
    ``repro_torch.kernels.rglru_scan.rglru_scan.launches`` (forward) and
    ``repro_torch.kernels.rglru_scan.rglru_scan_reverse.launches``
    (backward).
    """
    _check_impl(impl)
    return _LinearScan.apply(a, u, h0, impl)
