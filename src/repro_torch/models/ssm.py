"""Mamba-2 SSD mixer (``repro.models.ssm``): only the causal conv so far.

The RG-LRU block (``repro_torch.models.recurrent``) runs its recurrent
branch through the depthwise causal conv that the reference keeps here;
the SSD mixer itself (``ssd_chunked``, ``ssd_block``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
