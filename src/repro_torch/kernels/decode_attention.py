"""Paged flash-decoding attention: the CUDA kernel's Python wrapper.

Counterpart of the Pallas TPU kernel
``repro.kernels.decode_attention.paged_decode_attention``.  The kernel
itself is ``csrc/paged_decode_attention.cu`` (its header says what it
computes, what bounds it on an H100 and what its design does about
that); :mod:`repro_torch.kernels.build` compiles it with ``nvcc`` on
first use and loads it with ``ctypes``.  The plain version it is held
against is :func:`repro_torch.kernels.ref.paged_decode_attention_ref`.

:func:`paged_decode_attention` takes CUDA tensors only and launches the
kernel or raises: there is no fallback.  Its ``launches`` attribute is a
plain integer, one per launch, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

KERNEL = "paged_decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_HEAD_DIM = 256


def _bind() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,      # tensors
                       ci, ci, ci, ci, ci, ci, ci, ci, ci,  # dtypes .. window
                       cf, cf, ci, vp]                      # softcap .. stream
        fn.restype = ci
        lib.paged_decode_attention_error.argtypes = [ci]
        lib.paged_decode_attention_error.restype = ctypes.c_char_p
    return lib


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           kv_lens: torch.Tensor, window: int = 0, *,
                           softcap: float = 0.0, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """q (B,H,G,D) × page pool k,v (P,ps,H,D) -> out (B,H,G,D) in q.dtype.

    ``block_tables`` (B, max_pages) and ``kv_lens`` (B,) are int32
    device tensors; ``window`` (0 = full) and ``softcap`` (0 = off) are
    host numbers.  q is float32 or bfloat16 (the kernel computes in
    float32 and rounds its result to q.dtype); the pages are float32,
    bfloat16 or int8, with ``D <= 256`` and page rows a multiple of 16
    bytes.  Int8 pages need ``k_scales``/``v_scales`` (P, ps, H)
    float32, one scale per (row, kv head).  Lanes with ``kv_len == 0``
    come out zero.
    """
    B, H, G, D = q.shape
    P, ps, Hk, Dk = k_pages.shape
    if not q.is_cuda:
        raise ValueError("paged_decode_attention launches a CUDA kernel; "
                         "use kernels.ref for CPU tensors")
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("kv_lens", kv_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if k_pages.dtype not in _PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be float32 or bfloat16, or int8 with "
                        f"scales (k {k_pages.dtype}, v {v_pages.dtype})")
    int8 = k_pages.dtype == torch.int8
    if int8 != (k_scales is not None) or int8 != (v_scales is not None):
        raise ValueError("int8 pages take k_scales and v_scales; float "
                         "pages take neither")
    if int8:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if (t.dtype != torch.float32 or t.shape != (P, ps, Hk)
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"({P}, {ps}, {Hk}) tensor on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    if v_pages.shape != k_pages.shape or (Hk, Dk) != (H, D):
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"k {tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    if D > MAX_HEAD_DIM or (D * k_pages.element_size()) % 16:
        raise ValueError(f"head_dim {D}: the kernel takes D <= "
                         f"{MAX_HEAD_DIM} with rows a multiple of 16 bytes")
    if G > 32 or G * D > 4096:
        raise ValueError(f"GQA group {G} x head_dim {D} exceeds the "
                         "kernel's shared-memory plan (G <= 32, G*D <= 4096)")
    if block_tables.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("block_tables and kv_lens must be int32")
    max_pages = block_tables.shape[1]
    if block_tables.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"kv_lens {tuple(kv_lens.shape)} for batch {B}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    qc = q.contiguous()
    bt = block_tables.contiguous()
    lens = kv_lens.contiguous()
    out = torch.empty((B, H, G, D), dtype=q.dtype, device=dev)
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_decode_attention(
        qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None,
        bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], _PAGE_DTYPES[k_pages.dtype], B, H, G, D, ps,
        max_pages,
        int(window),
        float(softcap), 1.0 / math.sqrt(D), dev.index or 0, stream)
    if err != 0:
        msg = lib.paged_decode_attention_error(err).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"CUDA error {err} ({msg})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
