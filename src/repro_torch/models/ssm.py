"""Mamba-2 SSD — state-space duality, chunked (``repro.models.ssm``;
arXiv:2405.21060).

The SSD recurrence per head:  h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t x_tᵀ,
y_t = C_t·h_t + D·x_t, with a scalar A per head (A < 0) and B/C shared
over head groups.  ``ssd_chunked`` computes it in the chunked dual form
(an intra-chunk quadratic term plus inter-chunk state passing) and is
what ``ssd_block`` runs for prefill and decode alike, as in the
reference: a one-token decode step is a chunk padded with zeros, whose
state update is exact.  ``ssd_reference`` (step by step) and
``ssd_decode_step`` (one token) are the recurrent forms, for the tests.
The chunk scan is plain torch, as it is plain jnp in the reference (no
TPU kernel computes it).

The depthwise causal conv ``_causal_conv`` is shared with the RG-LRU
block (``repro_torch.models.recurrent``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import Params, dense_init, rms_norm


class SSDState(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) recurrent state, float32
    conv: torch.Tensor    # (B, W-1, conv_channels) causal-conv tail


def init_ssd(gen: torch.Generator, d_model: int, *, n_heads: int,
             head_dim: int, d_state: int, n_groups: int, conv_width: int,
             dtype: Any, lead: tuple = ()) -> Params:
    """Random block parameters drawn from ``gen`` on ``gen.device``,
    stacked over ``lead``; A_log, D and dt_bias are float32."""
    dev = gen.device
    d_inner = n_heads * head_dim
    conv_ch = d_inner + 2 * n_groups * d_state
    conv_w = torch.randn(lead + (conv_width, conv_ch), generator=gen,
                         device=dev) / math.sqrt(conv_width)
    dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3))
                   * torch.rand(lead + (n_heads,), generator=gen,
                                device=dev))
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev))
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "in_proj": dense_init(
            gen, d_model, 2 * d_inner + 2 * n_groups * d_state + n_heads,
            dtype, device=dev, lead=lead),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "A_log": a_log.expand(lead + (n_heads,)).clone(),
        "D": torch.ones(lead + (n_heads,), device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm_gain": torch.zeros(lead + (d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_inner, d_model, dtype, device=dev,
                               lead=lead),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L) with out[i,j] = sum x[j+1..i], -inf j>i."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -math.inf)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, then ``silu(y + b)``.  x (B,T,C), w (W,C),
    b (C,); ``tail`` (B, W-1, C) holds the inputs before x[:, 0] (zeros
    when None).  Returns (y, new_tail): new_tail is the last W-1 inputs,
    the tail of the next call."""
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                    # (B, T+W-1, C)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i] for i in range(W))
    new_tail = xp[:, -(W - 1):] if W > 1 else tail
    return F.silu(y + b), new_tail


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x (B,T,H,P); dt (B,T,H) (post-softplus, float32); A (H,) negative;
    Bm, Cm (B,T,G,N) with H % G == 0.  T is padded with zeros to a whole
    number of chunks.  Returns (y (B,T,H,P) in x's dtype, final_state
    (B,H,P,N) float32).
    """
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=2)               # (B,T,H,N)
    Ch = Cm.repeat_interleave(rep, dim=2)
    pad = (-T) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    Tp = T + pad
    nC = Tp // chunk

    def to_chunks(a):
        return a.reshape((Bsz, nC, chunk) + tuple(a.shape[2:]))

    xc = to_chunks(x * dt[..., None].to(x.dtype)).float()   # u = dt * x
    dAc = to_chunks(dt) * A[None, None, None, :]        # (B,c,l,H) log-decay
    Bc, Cc = to_chunks(Bh).float(), to_chunks(Ch).float()

    dAc_t = dAc.movedim(-1, 2)                          # (B,c,H,l)
    A_cum = torch.cumsum(dAc_t, dim=-1)                 # (B,c,H,l)

    # intra-chunk (diagonal blocks): Y_diag = (L ∘ C Bᵀ) u
    L = torch.exp(_segsum(dAc_t))                       # (B,c,H,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * L, xc)

    # chunk-final states: S_c = Σ_s exp(A_cum_last - A_cum_s) B_s u_sᵀ
    decay = torch.exp(A_cum[..., -1:] - A_cum)          # (B,c,H,l)
    states = torch.einsum("bchl,bclhn,bclhp->bchpn", decay, Bc, xc)

    # inter-chunk recurrence over c: the state before each chunk
    chunk_decay = torch.exp(A_cum[..., -1])             # (B,c,H)
    carry = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nC):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)              # (B,c,H,P,N)

    # inter-chunk contribution: Y_off = C_t · exp(A_cum_t) · S_{c-1}
    state_decay = torch.exp(A_cum)                      # (B,c,H,l)
    y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", Cc, prev_states,
                         state_decay)

    y = (y_diag + y_off).reshape(Bsz, Tp, H, P)[:, :T]
    return y.to(x.dtype), carry


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  initial_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrent oracle (slow, for tests)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[3]
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2).float()
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(T):
        dA = torch.exp(dt[:, t] * A[None, :])           # (B,H)
        u = (x[:, t] * dt[:, t][..., None]).float()
        h = h * dA[..., None, None] + torch.einsum("bhp,bhn->bhpn", u,
                                                   Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  x_t (B,H,P), dt_t (B,H), B_t/C_t (B,G,N)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1).float()
    Ch = C_t.repeat_interleave(rep, dim=1).float()
    dA = torch.exp(dt_t * A[None, :])
    u = (x_t * dt_t[..., None]).float()
    new_state = (state * dA[..., None, None]
                 + torch.einsum("bhp,bhn->bhpn", u, Bh))
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state


# ----------------------------------------------------------------------
# full block (proj -> conv -> SSD -> gate -> out proj)
# ----------------------------------------------------------------------

def _split_proj(proj: torch.Tensor, *, d_inner: int, n_groups: int,
                d_state: int, n_heads: int):
    sizes = [d_inner, d_inner, n_groups * d_state, n_groups * d_state,
             n_heads]
    return torch.split(proj, sizes, dim=-1)


def ssd_block(params: Params, x: torch.Tensor, *, n_heads: int,
              head_dim: int, d_state: int, n_groups: int, chunk: int,
              state: Optional[SSDState] = None,
              ) -> Tuple[torch.Tensor, SSDState]:
    """Full Mamba-2 block on (B, T, d_model).  Returns (y, new_state)."""
    Bsz, T, _ = x.shape
    d_inner = n_heads * head_dim
    proj = x @ params["in_proj"]
    z, xs, Bf, Cf, dt = _split_proj(proj, d_inner=d_inner,
                                    n_groups=n_groups, d_state=d_state,
                                    n_heads=n_heads)
    conv_in = torch.cat([xs, Bf, Cf], dim=-1)
    tail = state.conv if state is not None else None
    conv_out, new_tail = _causal_conv(conv_in, params["conv_w"],
                                      params["conv_b"], tail)
    xs, Bf, Cf = torch.split(
        conv_out, [d_inner, n_groups * d_state, n_groups * d_state], dim=-1)
    xh = xs.reshape(Bsz, T, n_heads, head_dim)
    Bm = Bf.reshape(Bsz, T, n_groups, d_state)
    Cm = Cf.reshape(Bsz, T, n_groups, d_state)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    prev = state.state if state is not None else None
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk,
                                 initial_state=prev)
    y = y + params["D"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(Bsz, T, d_inner)
    y = rms_norm(y, params["norm_gain"]) * F.silu(z)
    return y @ params["out_proj"], SSDState(state=final_state, conv=new_tail)
