"""int8 KV-page quantization for the paged serving cache
(``repro.quant.kv_int8``).

Under ``kv_dtype="int8"`` each layer's flat page-pool rows hold int8
codes plus one f32 scale per **(row, kv head)**:

    k / v           (rows, Hkv, D) int8   code = round(x / scale)
    k_scale/v_scale (rows, Hkv)    f32    scale = max|x| / 127

Row scales make the write path a pure scatter, like the fp32 path, and
cost 4 bytes per head per token beside D bytes of codes.  Reads
dequantize only what they gather: the resumed-prefill context in
``models.transformer._paged_attn`` and, on the card, inside the paged
decode kernel's tile.  Codes and scales are bit-equal to the
reference's on the same input.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, D) float -> ((..., H, D) int8 codes, (..., H) f32 scales).

    Symmetric absmax scaling per (row, head); all-zero rows (idle batch
    lanes writing the scratch page) get scale 0 and dequantize to 0.
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0                 # (..., H)
    pos = scale > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale,
                                             torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.round(xf * inv[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """((..., H, D) int8, (..., H) f32) -> (..., H, D) ``dtype``."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def kv_bytes_per_row_head(head_dim: int) -> int:
    """Pool bytes one (token, kv head) costs: D code bytes + 4 scale."""
    return head_dim + 4
