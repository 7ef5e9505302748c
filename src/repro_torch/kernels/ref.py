"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``).

Each function here computes what its kernel computes, in the plainest
tensor code: the CPU path of the kernel wrappers, and the yardstick the
kernels are held against on the card.
"""

from __future__ import annotations

import math

import torch

from ..quant.q4_0 import dequantize

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def q4_gemm_ref(x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """x (M,K) @ dequant(packed, scales) (K,N) -> (M,N) float32: the
    plain version of ``repro_torch.kernels.q4_gemm.q4_gemm``."""
    return x.float() @ dequantize(packed, scales, dtype=torch.float32)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               kv_lens: torch.Tensor, window: int = 0,
                               softcap: float = 0.0, k_scales=None,
                               v_scales=None) -> torch.Tensor:
    """Gather-based paged flash-decoding: the plain version of
    ``repro_torch.kernels.decode_attention.paged_decode_attention``.

    q (B,H,G,D) one token per sequence; k_pages/v_pages (P,ps,H,D) the
    shared physical page pool; block_tables (B,max_pages) maps each
    sequence's logical page j to a physical page id; kv_lens (B,) is the
    per-sequence token count.  Position j of a sequence is valid when
    ``j < kv_len`` and, for ``window > 0``, ``j > kv_len - 1 - window``.
    Fully-masked rows (kv_len == 0, idle batch slots) come out finite.
    Returns (B,H,G,D) float32.

    ``k_scales``/``v_scales`` (P, ps, H) switch on the int8 page format:
    pages hold int8 codes, dequantized after the block-table gather.
    """
    B, H, G, D = q.shape
    P, ps, _, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    L = max_pages * ps
    scale = 1.0 / math.sqrt(D)
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, L, H, D)
    v = v_pages[bt].reshape(B, L, H, D)
    if k_scales is not None:
        k = k.float() * k_scales[bt].reshape(B, L, H)[..., None]
    if v_scales is not None:
        v = v.float() * v_scales[bt].reshape(B, L, H)[..., None]
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    j = torch.arange(L, device=q.device)
    lens = kv_lens.to(device=q.device, dtype=torch.long)
    valid = j[None, :] < lens[:, None]
    if window > 0:
        valid &= j[None, :] > lens[:, None] - 1 - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len=None, *, kv_positions=None, q_pos=None,
                         window: int = 0, softcap: float = 0.0,
                         ) -> torch.Tensor:
    """Contiguous-cache flash-decoding: the plain version of
    ``repro_torch.kernels.decode_attention.decode_attention``.

    q (B,H,G,D) one token per sequence; k,v (B,S,H,D) the cache.  Slot
    ``s`` has position ``kv_positions[s]`` (the ring cache, -1 = empty)
    or ``s``; with ``kv_len`` the query sits at ``kv_len - 1``, else at
    ``q_pos``.  A slot is valid when its position is ``>= 0`` and at most
    the query's, and, for ``window > 0``, more than ``query - window``.
    Masked scores take the finite ``NEG_INF``, so a call with nothing
    valid gives the mean of V (as the Pallas kernel does).  Returns
    (B,H,G,D) float32.
    """
    B, H, G, D = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if kv_positions is None:
        kpos = torch.arange(S, device=q.device)
        q_pos = int(kv_len) - 1
    else:
        kpos = kv_positions.to(device=q.device, dtype=torch.long)
        q_pos = int(q_pos)
    valid = (kpos >= 0) & (kpos <= q_pos)
    if window > 0:
        valid &= kpos > q_pos - window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())


def rglru_scan_ref(a: torch.Tensor, u: torch.Tensor,
                   h0=None) -> torch.Tensor:
    """``h[:, t] = a[:, t] * h[:, t-1] + u[:, t]`` over axis 1 of (B,T,W),
    ``h0`` (B,W) folded into step 0 as ``u[:, 0] += a[:, 0] * h0``: the
    plain version of ``repro_torch.kernels.rglru_scan.rglru_scan``.

    A sequential loop over T, each step a product and then a sum, each
    rounded to float32: the kernel's order, so the two agree bit for bit
    (the reference's associative scan differs in rounding only)."""
    if h0 is not None:
        u = u.clone()
        u[:, 0] += a[:, 0] * h0
    h = torch.empty_like(u)
    prev = torch.zeros_like(u[:, 0])
    for t in range(u.shape[1]):
        torch.add(a[:, t] * prev, u[:, t], out=h[:, t])
        prev = h[:, t]
    return h


def rglru_scan_reverse_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient's recurrence ``c[:, t] = a[:, t+1] * c[:, t+1] +
    g[:, t]`` backwards over axis 1 of (B,T,W), ``c[:, T-1] = g[:, T-1]``:
    the plain version of ``repro_torch.kernels.rglru_scan.
    rglru_scan_reverse``.

    :func:`rglru_scan_ref` over the reversed inputs with the gates
    shifted one step (``a[:, T]`` taken as 0), reversed back: the same
    sequential loop run backwards, each step the kernel's product and
    then its sum, so the two agree bit for bit."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    return rglru_scan_ref(a_next.flip(1), g.flip(1)).flip(1)
