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
through the kernel (a CUDA graph counts at its capture; its replays run
no Python and count nothing).
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
#: splits per (sequence, kv head) of the paged kernel: its merge keeps
#: G * n_split weights in shared memory
MAX_SPLITS = 256


def _bind() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,  # tensors
                       ci, ci, ci, ci, ci, ci, ci, ci,          # dtypes .. mp
                       ci, ci, ci, ci,                          # splits .. win
                       cf, cf, ci, vp]                  # softcap .. stream
        fn.restype = ci
        lib.paged_decode_attention_error.argtypes = [ci]
        lib.paged_decode_attention_error.restype = ctypes.c_char_p
    return lib


#: the paged kernel's split-K: splits of whole pages holding at least this
#: many tokens, enough of them for about this many blocks per SM over all
#: ``max_pages`` (the host never reads ``kv_lens``, so splits past a
#: sequence's end are launched and exit at once), at most MAX_SPLITS
PAGED_MIN_SPLIT_TOKENS = 64
PAGED_BLOCKS_PER_SM = 8


def paged_heads_per_block(G: int, int8: bool) -> int:
    """Query heads one block of the paged kernel computes: G rounded up to
    a power of two, at most 8 (4 for int8 pages, whose registers per head
    are twice as many); a larger group takes several blocks."""
    cap, ng = (4 if int8 else 8), 1
    while ng < min(G, cap):
        ng *= 2
    return ng


def split_plan(n_units: int, min_units: int, blocks: int,
               blocks_per_sm: int, sms: int, max_splits: int = MAX_SPLITS):
    """(n_split, chunk): the split-K of both decode kernels.  Cut the
    ``n_units`` units (pages or slots) of each of ``blocks`` blocks into
    ``n_split`` splits of ``chunk`` units, split z holding units ``[z *
    chunk, (z + 1) * chunk)`` (the last one clipped to ``n_units``): enough
    splits for about ``blocks_per_sm`` blocks per SM, none under
    ``min_units`` units, at most ``max_splits``."""
    want = -(-blocks_per_sm * sms // max(blocks, 1))
    n_split = max(1, min(-(-n_units // min_units), want, max_splits))
    chunk = max(1, -(-n_units // n_split))
    return max(1, -(-n_units // chunk)), chunk


def paged_split_plan(max_pages: int, page_size: int, blocks: int,
                     sms: int):
    """The paged kernel's :func:`split_plan` over ``max_pages`` pages for
    ``blocks`` (sequence, kv head, head chunk) triples."""
    return split_plan(max_pages, -(-PAGED_MIN_SPLIT_TOKENS // page_size),
                      blocks, PAGED_BLOCKS_PER_SM, sms)


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

    Two launches, the splits (:func:`paged_split_plan`, kept in
    ``paged_decode_attention.plan``) and their merge, counted as one.  Nothing is read back from the device (``kv_lens``
    only on it), so a call does not synchronise and can be captured in a
    CUDA graph.
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
    ng = paged_heads_per_block(G, int8)
    n_split, chunk = paged_split_plan(max_pages, ps, B * H * -(-G // ng),
                                      build.sm_count(dev.index or 0))
    out = torch.empty((B, H, G, D), dtype=q.dtype, device=dev)
    part_acc = torch.empty((B * H * n_split, G, D), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B * H * n_split, 2, G), dtype=torch.float32,
                          device=dev)
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_decode_attention(
        qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None,
        bt.data_ptr(), lens.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], _PAGE_DTYPES[k_pages.dtype], B, H, G, D, ps,
        max_pages, n_split, chunk, ng, int(window), float(softcap),
        1.0 / math.sqrt(D), dev.index or 0, stream)
    if err != 0:
        msg = lib.paged_decode_attention_error(err).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"CUDA error {err} ({msg})")
    paged_decode_attention.launches += 1
    paged_decode_attention.plan = (n_split, chunk)
    return out


paged_decode_attention.launches = 0
#: (n_split, chunk) of the last launch
paged_decode_attention.plan = None


#: the contiguous kernel's split-K: about this many blocks per SM over
#: all (sequence, kv head, head chunk) triples, no split shorter than its
#: merge costs (:func:`contiguous_split_plan`)
CONTIGUOUS_BLOCKS_PER_SM = 2
#: at most this many splits: the splits of one (sequence, kv head, head
#: chunk) form a thread-block cluster, whose largest size is 16
CONTIGUOUS_MAX_SPLITS = 16
#: query heads one block of the contiguous kernel may take (its register
#: arrays hold NG x 8 d of q and of acc a lane), and the compiled counts
CONTIGUOUS_MAX_HEADS = 8
_CONTIGUOUS_HEAD_COUNTS = (1, 2, 4, 5, 8)


def contiguous_heads_per_block(G: int) -> int:
    """Query heads one block of the contiguous kernel computes: the group
    cut evenly into ``ceil(G / 8)`` chunks, each rounded up to a compiled
    count (1, 2, 4, 5 or 8): G = 10 runs as two blocks of 5."""
    per = -(-G // -(-G // CONTIGUOUS_MAX_HEADS))
    return next(n for n in _CONTIGUOUS_HEAD_COUNTS if n >= per)


def contiguous_split_plan(n_slots: int, G: int, D: int, itemsize: int,
                          blocks: int, sms: int):
    """(n_split, chunk) of the contiguous kernel over ``n_slots`` slots
    for ``blocks`` (sequence, kv head, head chunk) triples.

    Cost model (``csrc/decode_attention.cu``): a valid slot costs its K and
    V rows, ``2 * D * itemsize`` bytes; a split adds a state of
    ``(G * D + 2 * G) * 4`` bytes that is written to shared memory and
    read back across the cluster by the merge.  So no split is shorter
    than the slots whose K/V bytes equal that round trip, and within that
    there are enough splits for about CONTIGUOUS_BLOCKS_PER_SM blocks an
    SM (:func:`split_plan`), at most CONTIGUOUS_MAX_SPLITS.  The plan
    depends on the slot count and the card only, never on which slots are
    valid."""
    state_round_trip = 2 * (G * D + 2 * G) * 4
    min_slots = -(-state_round_trip // (2 * D * itemsize))
    return split_plan(n_slots, min_slots, blocks, CONTIGUOUS_BLOCKS_PER_SM,
                      sms, CONTIGUOUS_MAX_SPLITS)


def _bind_contiguous() -> ctypes.CDLL:
    lib = build.load(CONTIGUOUS_KERNEL)
    fn = lib.decode_attention
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp,                  # tensors
                       ci, ci, ci, ci, ci, ci, ci,          # dtypes .. D
                       ci, ci, ci, ci, ci, ci, ci,          # lo .. window
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

    One launch: the splits (:func:`contiguous_split_plan` over the slot
    range, :func:`contiguous_heads_per_block`; the plan is kept in
    ``decode_attention.plan``) of each (sequence, kv head, head chunk) form
    a cluster that merges them.  The grid depends on S (or kv_len) and the
    card, not on ``q_pos``.
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
    ng = contiguous_heads_per_block(G)
    n_split, chunk = contiguous_split_plan(
        max(hi - lo, 0), G, D, k.element_size(), B * H * -(-G // ng),
        build.sm_count(dev.index or 0))
    qc = q.contiguous()
    if qc.data_ptr() % 16:      # the kernel reads q 8 or 16 bytes at a time
        qc = qc.clone()
    out = torch.empty((B, H, G, D), dtype=q.dtype, device=dev)
    lib = _bind_contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.decode_attention(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), pos_ptr, out.data_ptr(),
        _DTYPES[q.dtype], _DTYPES[k.dtype], B, S, H, G, D, lo, hi, n_split,
        chunk, ng, q_pos, window, float(softcap), 1.0 / math.sqrt(D),
        dev.index or 0, stream)
    if err != 0:
        msg = lib.decode_attention_error(err).decode()
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err} ({msg})")
    decode_attention.launches += 1
    decode_attention.plan = (n_split, chunk)
    return out


decode_attention.launches = 0
#: (n_split, chunk) of the last launch
decode_attention.plan = None
