"""Frozen arithmetic of the benchmark: the H100's peaks, and the FLOPs and
least bytes of a decode step and of one paged decode-attention call.

Everything here is computed from a configuration file's published keys
(``hidden_size``, ``num_attention_heads``, ...) and from the benchmark's
own records of each request (its context length, the prefix it shares with
other requests), never from the program's arguments or its pool size, so
that a later change to the program cannot move the yardstick.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit; a card set below it runs slower, so every result prints the card's
power limit beside these.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

#: bf16 tensor-core peak of one H100 SXM, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM, bytes/s
HBM_BYTES_PER_S = 3.35e12

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def dims(cfg: Dict) -> Dict[str, int]:
    """The sizes the counts need, from a configuration file's keys."""
    d = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    return {
        "d": d,
        "f": int(cfg["intermediate_size"]),
        "layers": int(cfg["num_hidden_layers"]),
        "hq": heads,
        "hkv": int(cfg["num_key_value_heads"]),
        "hd": int(cfg.get("head_dim") or d // heads),
        "vocab": int(cfg["vocab_size"]),
        "experts": int(cfg.get("num_local_experts", 0)),
        "topk": int(cfg.get("num_experts_per_tok", 0)),
        "itemsize": _DTYPE_BYTES[cfg["torch_dtype"]],
    }


def matmul_params_per_token(cfg: Dict) -> int:
    """Weights one token multiplies by, over the whole stack: the four
    attention projections, the gated MLP (a MoE layer: the router and k of
    its E experts) and the LM head."""
    m = dims(cfg)
    d, f, hd = m["d"], m["f"], m["hd"]
    q, kv = m["hq"] * hd, m["hkv"] * hd
    attn = d * q + 2 * d * kv + q * d
    if m["experts"]:
        ffn = m["topk"] * 3 * d * f + d * m["experts"]
    else:
        ffn = 3 * d * f
    return m["layers"] * (attn + ffn) + m["vocab"] * d


def attention_flops(cfg: Dict, kv_len: int) -> int:
    """Scores and weighted values of one query token over ``kv_len`` keys,
    every layer: 2 FLOPs a multiply-add, twice (QK^T and PV)."""
    m = dims(cfg)
    return 4 * kv_len * m["hq"] * m["hd"] * m["layers"]


def decode_token_flops(cfg: Dict, kv_len: int) -> int:
    """Model FLOPs of one decode token whose context (the fed token
    included) is ``kv_len`` tokens long."""
    return 2 * matmul_params_per_token(cfg) + attention_flops(cfg, kv_len)


Lane = Tuple[int, Optional[object], int]
"""One sequence of a paged decode call: (kv_len, prefix group or None,
length of the prefix the group shares)."""


def paged_attn_rows(lanes: Iterable[Lane]) -> int:
    """K/V rows (token positions, per layer and kv head) that a paged
    decode call needs: each lane reads ``kv_len`` rows, but the rows of a
    prefix that several lanes share (same tokens at the same positions,
    so the same keys and values) count once."""
    rows = 0
    shared: Dict[object, int] = {}
    for kv_len, group, shared_len in lanes:
        if group is None or shared_len <= 0:
            rows += kv_len
            continue
        common = min(kv_len, shared_len)
        shared[group] = max(shared.get(group, 0), common)
        rows += kv_len - common
    return rows + sum(shared.values())


def paged_attn_least(cfg: Dict, lanes: Sequence[Lane]) -> Tuple[float, float]:
    """(least bytes, FLOPs) of one paged decode-attention call over every
    layer: each K/V row it needs read once (:func:`paged_attn_rows`), the
    query read and the output written once per lane; 4 FLOPs per query
    head, head dim and key."""
    m = dims(cfg)
    live = [ln for ln in lanes if ln[0] > 0]
    row_bytes = m["hkv"] * m["hd"] * m["itemsize"]
    kv_bytes = 2 * paged_attn_rows(live) * row_bytes
    qo_bytes = 2 * len(live) * m["hq"] * m["hd"] * m["itemsize"]
    flops = sum(4 * kv * m["hq"] * m["hd"] for kv, _, _ in live)
    return ((kv_bytes + qo_bytes) * m["layers"], float(flops * m["layers"]))


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the byte time at
    HBM bandwidth and the FLOP time at the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
