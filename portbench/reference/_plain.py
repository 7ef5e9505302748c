"""Building blocks of the plain references: float32 PyTorch, no kernel,
no cache, no batching, and nothing of the program imported.

``linear(x, w, precision)`` is the one place where precision changes:
``"f32"`` multiplies in float32 (TF32 off, see :func:`strict_f32`);
``"fp8"`` rounds the activation per row and the weight per output
column to float8 e4m3 with a scale each, then multiplies the rounded
values in float32: an fp8 matmul with float32 accumulation, the step
below bfloat16 that the control of ``correct`` takes.  ``"bf16"`` rounds
the activation to bfloat16 and the product back to it, as a bf16 GEMM
with float32 accumulation does: a witness of what bf16 arithmetic alone
does to the readings, not a path of the program.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def strict_f32() -> None:
    """Float32 matmuls in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (amax / 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., d_in) float32 @ w (d_in, d_out), any dtype."""
    wf = w.float()
    if precision == "f32":
        return x @ wf
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(wf, 0)
    if precision == "bf16":
        bf = torch.bfloat16
        return (x.to(bf).float() @ wf.to(bf).float()).to(bf).float()
    raise ValueError(f"precision {precision!r}: choose 'f32', 'bf16' or "
                     "'fp8'")


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the zero-centred gain of the parameter layout:
    x / rms(x) * (1 + g)."""
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + gain.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding at positions 0..S-1, frequencies
    theta^(-2i/D).  x (S, H, D)."""
    S, _, D = x.shape
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 1024) -> torch.Tensor:
    """Softmax(q k^T / sqrt(D)) v with a causal mask, query heads grouped
    over the kv heads (head h reads kv head h // G).  q (S, Hq, D), k, v
    (S, Hkv, D); queries in blocks of ``block`` rows so that the scores
    fit."""
    S, Hq, D = q.shape
    G = Hq // k.shape[1]
    kg = k.repeat_interleave(G, dim=1)            # (S, Hq, D)
    vg = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        scores = torch.einsum("qhd,khd->hqk", q[s0:s1], kg[:s1]) / D ** 0.5
        mask = pos[None, :s1] > pos[s0:s1, None]
        scores = scores.masked_fill(mask[None], float("-inf"))
        out[s0:s1] = torch.einsum("hqk,khd->qhd", scores.softmax(-1),
                                  vg[:s1])
    return out


def decoder_logits(params, cfg, tokens: torch.Tensor, rows: torch.Tensor,
                   precision: str, ffn) -> torch.Tensor:
    """Logits (len(rows), V) in float32 of a pre-norm decoder over
    ``tokens`` (S,), taken at positions ``rows``: embedding, then per
    layer x + attn(norm(x)) and x + ffn(norm(x)), then the final norm and
    the head (the embedding, transposed, where tied).  The weights are
    read one layer at a time in the parameter layout the benchmark draws
    (stacked over layers) and widened to float32 there; ``ffn(lp, h,
    precision)`` is the family's feed-forward block."""
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    hq, hkv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    hd = int(cfg.get("head_dim") or int(cfg["hidden_size"]) // hq)
    S = tokens.shape[0]
    layers = params["layers"]
    x = params["embed"][tokens].float()
    for i in range(int(cfg["num_hidden_layers"])):
        lp = _layer(layers, i)
        a = lp["attn"]
        h = rms_norm(x, lp["ln1"]["g"], eps)
        q = linear(h, a["w_q"], precision).reshape(S, hq, hd)
        k = linear(h, a["w_k"], precision).reshape(S, hkv, hd)
        v = linear(h, a["w_v"], precision).reshape(S, hkv, hd)
        if "q_norm" in a:
            q = rms_norm(q, a["q_norm"], eps)
            k = rms_norm(k, a["k_norm"], eps)
        o = causal_attention(rope(q, theta), rope(k, theta), v)
        x = x + linear(o.reshape(S, hq * hd), a["w_o"], precision)
        x = x + ffn(lp, rms_norm(x, lp["ln2"]["g"], eps), precision)
    h = rms_norm(x[rows], params["final_norm"]["g"], eps)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return linear(h, head, precision)


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked over layers (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
