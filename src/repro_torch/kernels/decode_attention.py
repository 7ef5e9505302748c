"""Flash-decoding attention: the CUDA kernels' Python wrappers.

Counterparts of the two Pallas TPU kernels of
``repro.kernels.decode_attention``:

* :func:`paged_decode_attention` — the paged cache read through block
  tables, ``csrc/paged_decode_attention.cu``;
* :func:`decode_attention` — the contiguous cache (the bucket engine's
  ring cache), ``csrc/decode_attention.cu``.

Each source's header says what it computes, what bounds it on an H100
and what its design does about that; :mod:`repro_torch.kernels.build`
compiles it with ``nvcc`` on first use and loads it with ``ctypes``.
The plain versions they are held against are
:func:`repro_torch.kernels.ref.paged_decode_attention_ref` and
:func:`repro_torch.kernels.ref.decode_attention_ref`.

Both wrappers take CUDA tensors only and launch the kernel or raise:
there is no fallback.  Each has a ``launches`` attribute, a plain
integer, one per launch, so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

KERNEL = "paged_decode_attention"
CONTIGUOUS_KERNEL = "decode_attention"
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


#: the contiguous kernel's split-K: at least this many slots per split,
#: up to this many blocks per SM in all, and at most MAX_SPLITS splits (the
#: merge keeps G * n_split weights in shared memory)
MIN_SPLIT_SLOTS = 8
BLOCKS_PER_SM = 4
MAX_SPLITS = 256


def _splits(n_slots: int, pairs: int, dev: torch.device):
    """(n_split, chunk): cut ``n_slots`` slots of each of ``pairs``
    (sequence, kv head) pairs into splits of ``chunk`` slots, enough for
    up to BLOCKS_PER_SM blocks per SM, none under MIN_SPLIT_SLOTS."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = min(-(-BLOCKS_PER_SM * sms // pairs), MAX_SPLITS)
    n_split = max(1, min(-(-n_slots // MIN_SPLIT_SLOTS), want))
    chunk = max(1, -(-n_slots // n_split))
    return (-(-n_slots // chunk) if n_slots else 1), chunk


def _bind_contiguous() -> ctypes.CDLL:
    lib = build.load(CONTIGUOUS_KERNEL)
    fn = lib.decode_attention
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,      # tensors
                       ci, ci, ci, ci, ci, ci, ci,          # dtypes .. D
                       ci, ci, ci, ci, ci, ci,              # lo .. window
                       cf, cf, ci, vp]                      # softcap .. stream
        fn.restype = ci
        lib.decode_attention_error.argtypes = [ci]
        lib.decode_attention_error.restype = ctypes.c_char_p
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len=None, *, kv_positions=None, q_pos=None,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q (B,H,G,D) × cache k,v (B,S,H,D) -> out (B,H,G,D) in q.dtype.

    Two forms of the mask (``window`` 0 = full, ``softcap`` 0 = off):

    * ``kv_len`` (host int), the TPU kernel's form: slot ``s`` is valid
      when ``s < kv_len`` (and ``s >= kv_len - window`` for a window);
    * ``kv_positions`` ((S,) int32 device tensor, -1 = empty slot) with
      ``q_pos`` (host int), the ring cache's form: slot ``s`` is valid
      when ``0 <= p_s <= q_pos`` (and ``p_s > q_pos - window``).

    q, k and v are float32 or bfloat16 (k and v of one type), with
    ``D <= 256`` and rows a multiple of 16 bytes.  A call in which no
    slot is valid returns the mean of V over all S slots, as the
    reference's finite ``NEG_INF`` gives.
    """
    if not q.is_cuda:
        raise ValueError("decode_attention launches a CUDA kernel; use "
                         "kernels.ref for CPU tensors")
    B, H, G, D = q.shape
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)}: both "
                         "must be (B, S, H, D)")
    Bk, S, Hk, Dk = k.shape
    if (Bk, Hk, Dk) != (B, H, D) or S == 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k.shape)}")
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"q, k and v must be float32 or bfloat16 (k and v "
                        f"of one type); got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D > MAX_HEAD_DIM or (D * k.element_size()) % 16:
        raise ValueError(f"head_dim {D}: the kernel takes D <= "
                         f"{MAX_HEAD_DIM} with rows a multiple of 16 bytes")
    if G > 32 or G * D > 4096:
        raise ValueError(f"GQA group {G} x head_dim {D} exceeds the "
                         "kernel's shared-memory plan (G <= 32, G*D <= 4096)")
    window = int(window)
    if kv_positions is None:
        if kv_len is None or q_pos is not None:
            raise ValueError("pass kv_len, or kv_positions with q_pos")
        kv_len = int(kv_len)
        hi = max(min(kv_len, S), 0)
        lo = max(kv_len - window, 0) if window > 0 else 0
        q_pos, pos_ptr = kv_len - 1, None
    else:
        if kv_len is not None or q_pos is None:
            raise ValueError("the ring form takes kv_positions and q_pos, "
                             "not kv_len")
        if (kv_positions.dtype != torch.int32 or kv_positions.shape != (S,)
                or kv_positions.device != dev
                or not kv_positions.is_contiguous()):
            raise ValueError(f"kv_positions must be a contiguous int32 "
                             f"({S},) tensor on {dev}, got "
                             f"{kv_positions.dtype} "
                             f"{tuple(kv_positions.shape)} on "
                             f"{kv_positions.device}")
        lo, hi, q_pos = 0, S, int(q_pos)
        pos_ptr = kv_positions.data_ptr()
    n_split, chunk = _splits(max(hi - lo, 0), B * H, dev)
    qc = q.contiguous()
    out = torch.empty((B, H, G, D), dtype=q.dtype, device=dev)
    part_acc = torch.empty((B * H * n_split, G, D), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B * H * n_split, 2, G), dtype=torch.float32,
                          device=dev)
    part_n = torch.empty((B * H * n_split,), dtype=torch.int32, device=dev)
    lib = _bind_contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.decode_attention(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), pos_ptr,
        part_acc.data_ptr(), part_ml.data_ptr(), part_n.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], _DTYPES[k.dtype], B, S, H, G, D,
        lo, hi, n_split, chunk, q_pos, window, float(softcap),
        1.0 / math.sqrt(D), dev.index or 0, stream)
    if err != 0:
        msg = lib.decode_attention_error(err).decode()
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err} ({msg})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
