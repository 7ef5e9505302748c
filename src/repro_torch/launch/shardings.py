"""Sharding policy for tensor-parallel paged serving (the serving subset
of ``repro.launch.shardings``).

The continuous engine's TP mode (``serving.runner.ModelRunner`` with
``mesh=``) runs the paged forward on every rank of the mesh's
``"model"`` axis — the paper's node≅shard mapping, with each rank
standing in for one NUMA node.  The cache splits by **kv head**: every
rank attends over its local heads of every page, so page allocation,
sharing, copy-on-write and eviction stay host bookkeeping with zero
cross-rank KV bytes, and one all-reduce per layer
(:func:`make_paged_head_merge`) gathers the heads' outputs.  Everything
outside attention (norms, MLP, embed / lm_head, ``w_o``) is replicated,
so that all-reduce is the forward's only collective.

Specs are :class:`~repro_torch.core.tp.Spec` records ("which dim is
split over which axis"); ``core.tp.shard_tree`` applies them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.tp import Spec, _path_str, all_reduce
from ..models.weights import tree_map_with_path


@dataclasses.dataclass(frozen=True)
class Policy:
    """The one knob of the reference's sharding policy that TP serving
    reads: ``shard_cache_head_dim``.  The runner refuses ``False``,
    which has no paged variant."""

    shard_cache_head_dim: bool = True


#: attention leaves sharded on their output-feature (head) dim in the
#: serving TP plan — the §3.2 "partitioned by attention heads" rule
SERVING_TP_HEAD_SHARDED = ("w_q", "w_k", "w_v", "b_q", "b_k", "b_v")


def serving_tp_param_specs(params: Any, *, axis: str = "model") -> Any:
    """Spec tree for the paged TP serving engine.

    ``w_q/w_k/w_v`` (L, d, heads*hd) and their biases (L, heads*hd)
    split their last (head) dim over ``axis``; every other leaf — w_o,
    MLP, norms, embed, lm_head — is replicated.

    Q4_0 weights (``--quant q4``) replace a projection leaf with a
    ``{"q4_packed", "q4_scales"}`` subtree; both members keep the
    column (N) layout in their last dim and Q4_0 quantizes along K, so
    splitting that dim by the *parent* weight's rule gives the same
    bytes as quantizing the already-split weight.
    """
    def f(path, leaf):
        p = _path_str(path)
        parts = p.split("/")
        name = parts[-1]
        if name in ("q4_packed", "q4_scales") and len(parts) >= 2:
            name = parts[-2]
        if name in SERVING_TP_HEAD_SHARDED and "attn" in p:
            return Spec((None,) * (leaf.dim() - 1) + (axis,))
        return Spec()
    return tree_map_with_path(f, params)


def paged_cache_specs(cache: Any, *, axis: str = "model") -> Any:
    """Spec tree for the paged device cache under TP.

    Each per-layer flat pool buffer (rows, Hkv, D) splits its **kv-head
    dim** over ``axis``: every rank holds its head slice of every page.
    Int8 pools add ``k_scale``/``v_scale`` (rows, Hkv), split the same
    way, so each rank dequantizes its heads with its own scales.  Block
    tables replicate (the host's page map).
    """
    def f(path, leaf):
        name = _path_str(path).split("/")[-1]
        if name in ("k", "v") and leaf.dim() == 3:
            return Spec((None, axis, None))
        if name in ("k_scale", "v_scale") and leaf.dim() == 2:
            return Spec((None, axis))
        return Spec()
    return tree_map_with_path(f, cache)


def make_paged_head_merge(n_heads: int, n_shards: int, mesh: Any, *,
                          axis: str = "model",
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Gather for head-sharded paged attention (§3.3 applied to heads).

    Each rank's attention output (B, S, H_local, D) holds its
    ``n_heads / n_shards`` query heads.  The merge writes that slice
    into zeros of the full head set at the rank's head offset and
    all-reduces over ``axis``: head supports are disjoint, so the sum is
    an exact concatenation (``x + 0 == x``) and the merged tensor equals
    the single-rank attention output bit for bit.  The sum runs in f32
    on every backend (bf16 → f32 → bf16 of ``x + 0`` is ``x``): one
    transport, whatever reductions a backend has for bf16.  One
    all-reduce per layer, the TP forward's only collective.
    """
    if n_heads % n_shards:
        raise ValueError(
            f"{n_heads} query heads do not shard over {n_shards} shards")
    local = n_heads // n_shards

    def merge(out: torch.Tensor) -> torch.Tensor:
        full = out.new_zeros(out.shape[:2] + (n_heads,) + out.shape[3:],
                             dtype=torch.float32)
        lo = mesh.axis_index(axis) * local
        full[:, :, lo:lo + local] = out
        return all_reduce(full, mesh, axis).to(out.dtype)

    return merge
