"""Q4_0 block quantization (``repro.quant.q4_0``): the serving weight format.

llama.cpp Q4_0: contiguous blocks of 32 values share one fp16 scale
``d = signed_absmax / -8``; each value is stored as a 4-bit code
``q = clamp(round(x/d) + 8, 0, 15)`` and dequantizes to ``(q - 8)·d``.

A weight ``W (K, N)`` is quantized along the contraction axis K:

    packed  (K//2,  N) uint8 — two 4-bit codes per byte
                               (low nibble = even k, high nibble = odd k)
    scales  (K//32, N) f32   — per 32-row block, per column

The codes and scales are bit-equal to the reference's on the same
weights: the same f32 upcast, first-occurrence argmax of |w|, the
``signed_max / -8`` sign trick, ``1/scale`` with 0 for a zero block,
half-to-even rounding (``torch.round`` and ``jnp.round`` agree), the
clamp to [0, 15] and the fp16 round-trip of the stored scale.
``repro_torch.kernels.q4_gemm`` consumes this layout directly.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 32
BYTES_PER_WEIGHT = 4 / 8 + 2 / BLOCK  # 4-bit code + fp16 scale share


def padded_k(K: int) -> int:
    """Smallest multiple of ``BLOCK`` >= K (the pad-to-block row count)."""
    return -(-K // BLOCK) * BLOCK


def quantize(w: torch.Tensor, *, pad: bool = False,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W (K, N) float -> (packed (K//2, N) uint8, scales (K//32, N) f32).

    ``pad=True`` accepts any K by zero-padding the contraction axis to
    the next multiple of ``BLOCK``; a zero row quantizes to code 8 and
    dequantizes to exactly 0, so the pad is exact (see
    ``repro_torch.quant.policy.make_qmm``).  Runs on ``w``'s device.
    """
    K, N = w.shape
    wf = w.float()
    if K % BLOCK:
        if not pad:
            raise ValueError(f"K={K} not a multiple of {BLOCK} "
                             "(pass pad=True for the pad-to-block path)")
        wf = F.pad(wf, (0, 0, 0, padded_k(K) - K))
        K = padded_k(K)
    wf = wf.reshape(K // BLOCK, BLOCK, N)
    imax = torch.argmax(wf.abs(), dim=1, keepdim=True)   # first on ties
    signed_max = torch.gather(wf, 1, imax)[:, 0, :]
    scale = signed_max / -8.0                    # llama.cpp sign trick
    inv = torch.where(scale != 0.0, 1.0 / scale, torch.zeros_like(scale))
    q = (torch.round(wf * inv[:, None, :]) + 8).clamp(0, 15).to(torch.uint8)
    q = q.reshape(K, N)
    packed = q[0::2] | (q[1::2] << 4)                      # (K/2, N)
    # fp16 round-trip of the scale, stored f32 like the reference
    scales = scale.to(torch.float16).float()
    return packed, scales


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(K//2, N) uint8 -> (K, N) int8 codes in [-8, 7]."""
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    K2, N = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N)


def dequantize(packed: torch.Tensor, scales: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    codes = unpack_codes(packed).float()                    # (K, N)
    s = torch.repeat_interleave(scales, BLOCK, dim=0)       # (K, N)
    return (codes * s).to(dtype)


def quantize_stacked(w: torch.Tensor, *, pad: bool = False,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer-stacked weights (L, K, N) -> ((L, K//2, N), (L, K//32, N)).

    Each layer is quantized on its own, as the reference's ``vmap``
    does; one layer at a time also bounds the f32 temporaries to one
    layer's size when a full-width stack is quantized on the card."""
    parts = [quantize(w[i], pad=pad) for i in range(w.shape[0])]
    return (torch.stack([p for p, _ in parts]),
            torch.stack([s for _, s in parts]))


def quantized_bytes(shape: Tuple[int, int]) -> int:
    K, N = shape
    return K * N // 2 + (K // BLOCK) * N * 4
