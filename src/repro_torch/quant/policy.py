"""Serving quantization policy (``--quant`` / ``--kv-dtype``), as
``repro.quant.policy``.

:class:`QuantPolicy` is the one knob the serving stack threads from the
CLI down to the device layer (``EngineCore(quant=...)`` →
``ModelRunner``): which weight format to serve (``weights``), which KV
page format to allocate (``kv_dtype``), and how quantized matmuls
dispatch (``impl``, the ``repro_torch.kernels.ops.q4_matmul`` rule:
the CUDA kernel on CUDA tensors, the plain version on CPU tensors).

Weight quantization (``weights="q4"``) rewrites the attention and MLP
projection leaves of the params tree to Q4_0 at load
(:func:`quantize_serving_params`): each targeted ``(..., K, N)`` matrix
becomes a ``{"q4_packed", "q4_scales"}`` subtree in place, quantized
along K (padding K to the 32-row block exactly, see ``q4_0.quantize``).
Embedding, lm_head, norms and biases stay dense.  The model reads the
quantized leaves through the ``qmm`` hook (:func:`make_qmm`), which
``ModelRunner`` installs on the model.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .q4_0 import quantize, quantize_stacked

#: projection leaves `quantize_serving_params` targets, under an
#: ``attn`` / ``mlp`` parent
Q4_WEIGHT_NAMES = ("w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down")

WEIGHT_FORMATS = ("none", "q4")
KV_DTYPES = ("fp32", "int8")
Q4_IMPLS = ("auto", "ref", "kernel")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """What the serving engine quantizes and how it dispatches.

    ``weights``   "none" | "q4"   — Q4_0-quantize attn/MLP projections
                                    at load (4.5 bits/weight)
    ``kv_dtype``  "fp32" | "int8" — KV page-pool element format
                                    (int8 + per-(row, head) f32 scales);
                                    "fp32" means the model's own dtype
    ``impl``      "auto" | "ref" | "kernel" — q4 matmul dispatch
                  (``kernels.ops.q4_matmul``): "auto" = the CUDA kernel
                  on CUDA tensors, the plain version on CPU tensors
    ``min_size``  smallest element count a leaf must have to be
                  quantized
    """

    weights: str = "none"
    kv_dtype: str = "fp32"
    impl: str = "auto"
    min_size: int = 1024

    def __post_init__(self) -> None:
        if self.weights not in WEIGHT_FORMATS:
            raise ValueError(f"weights={self.weights!r}: "
                             f"choose from {WEIGHT_FORMATS}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype={self.kv_dtype!r}: "
                             f"choose from {KV_DTYPES}")
        if self.impl not in Q4_IMPLS:
            raise ValueError(f"impl={self.impl!r}: "
                             f"choose from {Q4_IMPLS}")

    @property
    def active(self) -> bool:
        return self.weights != "none" or self.kv_dtype != "fp32"


def is_q4_leaf(w: Any) -> bool:
    """True for a ``{"q4_packed", "q4_scales"}`` quantized-weight subtree."""
    return isinstance(w, dict) and "q4_packed" in w


def quantize_serving_params(params: Any, *, min_size: int = 1024) -> Any:
    """Rewrite attn/MLP projection leaves to Q4_0 subtrees (a new tree;
    other leaves are shared, not copied).

    Matches by name (:data:`Q4_WEIGHT_NAMES`) under an ``attn`` or
    ``mlp`` path component, on 2-D ``(K, N)`` or layer-stacked 3-D
    ``(L, K, N)`` tensors of at least ``min_size`` elements.  K is
    padded to the 32-row block when needed (exact).  Quantizes on each
    leaf's own device.
    """
    from ..models.weights import tree_map_with_path  # see _leaves

    def f(path, leaf):
        parts = [str(p) for p in path]
        if not parts or parts[-1] not in Q4_WEIGHT_NAMES:
            return leaf
        if "attn" not in parts and "mlp" not in parts:
            return leaf
        if not isinstance(leaf, torch.Tensor) or leaf.dim() not in (2, 3):
            return leaf
        if leaf.numel() < min_size:
            return leaf
        qfn = quantize_stacked if leaf.dim() == 3 else quantize
        packed, scales = qfn(leaf, pad=True)
        return {"q4_packed": packed, "q4_scales": scales}

    return tree_map_with_path(f, params)


def _leaves(params: Any):
    """``(path, leaf)`` pairs of a params tree.  ``models`` is imported
    here, not at the top: the model package imports the kernels, which
    import ``quant.q4_0``, so a top-level import would make a cycle."""
    from ..models.weights import tree_leaves_with_path
    return tree_leaves_with_path(params)


def count_q4_leaves(params: Any) -> int:
    """Number of quantized-weight subtrees in a params tree."""
    return sum(1 for path, _ in _leaves(params)
               if path and path[-1] == "q4_packed")


def param_bytes(params: Any) -> int:
    """Total bytes of every tensor leaf (dense and quantized alike)."""
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in _leaves(params)
               if isinstance(leaf, torch.Tensor))


def make_qmm(impl: str = "auto"):
    """Build the model's quantized-matmul hook (``Model.qmm``).

    The returned ``qmm(x, w)`` computes ``x @ w`` for dense ``w`` and
    sends Q4_0 subtrees through ``kernels.ops.q4_matmul`` with the given
    ``impl``, handling leading batch dims and the pad-to-block K
    mismatch (activations zero-pad to the packed row count: exact,
    because padded weight rows dequantize to exact zeros).  The result
    is in ``x.dtype``: the kernel takes x as it is and rounds its f32
    sums to x's type, the value the reference gets by casting x up and
    the f32 product back down.
    """
    if impl not in Q4_IMPLS:
        raise ValueError(f"impl={impl!r}: choose from {Q4_IMPLS}")
    from ..kernels.ops import q4_matmul  # imported here: see _leaves

    def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
        if not is_q4_leaf(w):
            return x @ w
        packed, scales = w["q4_packed"], w["q4_scales"]
        K = x.shape[-1]
        Kq = packed.shape[-2] * 2
        N = packed.shape[-1]
        x2 = x.reshape(-1, K)
        if Kq > K:                       # pad-to-block (exact, see above)
            x2 = F.pad(x2, (0, Kq - K))
        out = q4_matmul(x2, packed, scales, impl=impl)   # in x.dtype
        return out.reshape(x.shape[:-1] + (N,))

    return qmm
