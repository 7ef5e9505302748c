"""Cross-NUMA tensor parallelism (paper §3) over ``torch.distributed``.

The port's form of ``repro.core.tp``.  A shard is a rank of a process
group, laid out on a :class:`~repro_torch.launch.mesh.Mesh` axis
(default ``"model"``, the NUMA-node axis): each rank holds its slice of
the partitioned weights and runs its subgraph; the collectives below are
the only traffic between ranks.

The paper's §3.2 weight-partition plan:

* **row-partitioned** (output features split): ``w_q, w_k, w_v`` (split
  by attention head), ``w_gate, w_up``;
* **column-partitioned** (input features split): ``w_o, w_down``;
* everything else (norm gains, biases on the replicated dim) replicated.

§3.3's operators: ``Scatter`` enters a TP block (row-partitioned weights
already live rank-locally, so the activation is the replicated input
every rank holds: no data moves); ``Gather`` leaves it (the
column-partitioned partial outputs are summed by an all-reduce).

§3.4's synchronisation schedules: **Sync A** all-gathers the activation
to full size and re-slices it after every partitioned op (one
collective per op, the "global coherence" schedule); **Sync B** keeps
activations rank-local for the whole block and issues only the Gather
all-reduce (ArcLight's schedule).  Both compute the same values; they
differ in collective traffic, which :func:`collective_ops_in` counts.

Every collective of the port's TP code goes through :func:`all_reduce`,
:func:`all_gather`, :func:`broadcast` or :func:`broadcast_object`, which
count themselves for :func:`collective_ops_in`.  On an axis of size 1
they are the identity and call no process group, as a collective over a
one-device mesh axis is in the reference.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.weights import tree_map_with_path


# ----------------------------------------------------------------------
# shard specs
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    """Which dims of a leaf are split over which mesh axes: ``dims[i]``
    names the axis dim ``i`` is split over (None: whole; a tuple of
    names: split over their product, row-major), and dims past the tuple
    are whole, so ``Spec()`` is a replicated leaf.  The port's form of a
    JAX ``PartitionSpec`` (``tuple(P(...)) == Spec(...).dims``)."""

    dims: Tuple[Any, ...] = ()


def axis_size(mesh: Any, axis: Any) -> int:
    """The number of ranks along ``axis`` (None: 1; a tuple of names:
    the product of their sizes)."""
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape.get(axis, 1)
    return math.prod(mesh.shape.get(a, 1) for a in axis)


def shard_leaf(x: torch.Tensor, spec: Spec, mesh: Any) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a contiguous copy
    where a dim is split; ``x`` itself where nothing is)."""
    out = x
    for dim, axis in enumerate(spec.dims):
        n = axis_size(mesh, axis)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does "
                             f"not split over the {n}-way {axis!r} axis")
        size = out.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(axis) * size, size)
    return out.contiguous() if out is not x else x


def shard_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    """:func:`shard_leaf` over a tree and its spec tree (same structure)."""
    flat: Dict[Tuple, Spec] = {}
    tree_map_with_path(lambda p, s: flat.__setitem__(p, s), specs)
    return tree_map_with_path(lambda p, x: shard_leaf(x, flat[p], mesh),
                              tree)


def _path_str(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


# ----------------------------------------------------------------------
# §3.2 — the weight-partition plan
# ----------------------------------------------------------------------

ROW_PARTITIONED = ("w_q", "w_k", "w_v", "w_gate", "w_up")
COL_PARTITIONED = ("w_o", "w_down")


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Paper §3.2 plan for one transformer layer's weights.

    Weight layout convention: every ``w_*`` is stored ``(d_in, d_out)``.
    Row-partitioning (by output feature / attention head) therefore
    shards axis 1; column-partitioning shards axis 0.
    """

    axis: str = "model"

    def spec_for(self, name: str) -> Spec:
        base = name.rsplit("/", 1)[-1]
        if base in ROW_PARTITIONED:
            return Spec((None, self.axis))
        if base in COL_PARTITIONED:
            return Spec((self.axis, None))
        if base in ("embed", "lm_head"):
            return Spec((None, self.axis))  # vocab-partitioned features
        return Spec()  # norms, biases on replicated dims

    def params_specs(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return tree_map_with_path(
            lambda path, _: self.spec_for(_path_str(path)), params)


# ----------------------------------------------------------------------
# collectives: the only inter-rank traffic of the port's TP code
# ----------------------------------------------------------------------

#: the counters :func:`collective_ops_in` and :func:`collective_bytes_in`
#: install (per thread/context)
_COUNTS: contextvars.ContextVar[Optional[Dict[str, int]]] = \
    contextvars.ContextVar("tp_collectives", default=None)
_BYTES: contextvars.ContextVar[Optional[Dict[str, int]]] = \
    contextvars.ContextVar("tp_collective_bytes", default=None)


def _count(name: str, moved: int = 0) -> None:
    """Count one call of collective ``name``, and the ``moved`` bytes of
    its output on this rank (0 on an axis of size 1: nothing moves)."""
    counts = _COUNTS.get()
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
    tally = _BYTES.get()
    if tally is not None and moved:
        tally[name] = tally.get(name, 0) + moved


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


_REDUCE_OPS = {"sum": ("all_reduce", dist.ReduceOp.SUM),
               "max": ("all_reduce_max", dist.ReduceOp.MAX)}


def all_reduce(x: torch.Tensor, mesh: Any, axis: Any = "model", *,
               op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the ranks of ``axis`` (a name or a tuple of
    names), in place; returns ``x``.  ``op``: "sum" (counted as
    ``all_reduce``) or "max" (counted as ``all_reduce_max``)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"op={op!r}: choose 'sum' or 'max'")
    name, red = _REDUCE_OPS[op]
    n = axis_size(mesh, axis)
    _count(name, _nbytes(x) if n > 1 else 0)
    if n > 1:
        dist.all_reduce(x, op=red, group=mesh.group(axis))
    return x


def all_gather(x: torch.Tensor, mesh: Any, axis: str = "model", *,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated along ``dim``, in rank
    order (JAX's ``all_gather(..., tiled=True)``)."""
    n = mesh.shape.get(axis, 1)
    _count("all_gather", n * _nbytes(x) if n > 1 else 0)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, mesh: Any, *, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of the mesh, in place (as raw
    bytes, so every dtype travels on every backend); returns ``x``."""
    _count("broadcast", _nbytes(x) if mesh.size > 1 else 0)
    if mesh.size > 1:
        if not x.is_contiguous():
            raise ValueError("broadcast needs a contiguous tensor")
        dist.broadcast(x.reshape(-1).view(torch.uint8), src=src)
    return x


def broadcast_object(obj: Any, mesh: Any, *, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank of the mesh (what
    keeps the ranks' host engines on the same inputs)."""
    _count("broadcast_object")
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def collective_ops_in(fn: Callable[..., Any], *args: Any,
                      **kwargs: Any) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` and count the collectives it issued
    through this module, by name (``{"all_reduce": n, ...}``): the torch
    form of the reference's jaxpr walk.  Unlike that walk it executes
    ``fn``, so every rank of the group must call it together."""
    counts: Dict[str, int] = {}
    token = _COUNTS.set(counts)
    try:
        fn(*args, **kwargs)
    finally:
        _COUNTS.reset(token)
    return counts


def collective_bytes_in(fn: Callable[..., Any], *args: Any,
                        **kwargs: Any) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` and sum, by collective, the bytes of
    each call's output on this rank (an all-reduce's and a broadcast's
    tensor, an all-gather's concatenation; ``broadcast_object`` is not
    counted), over axes of size above 1: the convention of the
    reference's HLO walk (``repro.launch.hlo_cost``), which
    ``launch.step_cost``'s rules follow.  Every rank of the group must
    call it together."""
    tally: Dict[str, int] = {}
    token = _BYTES.set(tally)
    try:
        fn(*args, **kwargs)
    finally:
        _BYTES.reset(token)
    return tally


# ----------------------------------------------------------------------
# reference (non-TP) blocks — the "vanilla MLP" of Fig 8a
# ----------------------------------------------------------------------

def mlp_reference(params: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """Z = W_down^T · (silu(W_gate^T X) * (W_up^T X)), weights (in, out)."""
    y = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return y @ params["w_down"]


def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ) -> torch.Tensor:
    """q/k/v (T, H, hd) -> (T, H, hd), causal softmax attention."""
    t, _, hd = q.shape
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask[None], float("-inf"))
    return torch.einsum("hqk,khd->qhd", scores.softmax(dim=-1), v)


def attention_reference(params: Dict[str, torch.Tensor], x: torch.Tensor,
                        n_heads: int) -> torch.Tensor:
    """Single-sequence causal attention block (no cache), for TP checks."""
    t, _ = x.shape
    hd = params["w_q"].shape[1] // n_heads
    q, k, v = ((x @ params[w]).reshape(t, n_heads, hd)
               for w in ("w_q", "w_k", "w_v"))
    return _causal_attention(q, k, v).reshape(t, n_heads * hd) \
        @ params["w_o"]


# ----------------------------------------------------------------------
# §3.3 / §3.4 — TP blocks over a process group
# ----------------------------------------------------------------------

def _sync_a_cohere(x_local: torch.Tensor, mesh: Any, axis: str,
                   dim: int) -> torch.Tensor:
    """Sync A global barrier: all-gather the sharded activation so every
    rank observes the coherent global value, then re-slice its shard.
    Numerically a no-op; one collective per call."""
    full = all_gather(x_local, mesh, axis, dim=dim)
    size = x_local.shape[dim]
    return full.narrow(dim, mesh.axis_index(axis) * size, size)


def mlp_tp(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
           mesh: Any, axis: str = "model",
           sync_mode: str = "sync_b") -> torch.Tensor:
    """The paper's TP MLP (Fig 8b) on one rank.

    ``x`` is the replicated input (Scatter's activation view);
    ``w_gate, w_up`` are this rank's row shards (axis 1), ``w_down`` its
    column shard (axis 0).  Returns the replicated Z = Σ_i B_i Y_i
    (Gather)."""
    y = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    if sync_mode == "sync_a":
        y = _sync_a_cohere(y, mesh, axis, dim=y.dim() - 1)
    return all_reduce(y @ params["w_down"], mesh, axis)       # Gather


def attention_tp(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                 n_heads: int, mesh: Any, axis: str = "model",
                 sync_mode: str = "sync_b") -> torch.Tensor:
    """Head-partitioned attention block (Fig 8c) on one rank."""
    heads_local = n_heads // mesh.shape.get(axis, 1)
    t = x.shape[0]
    hd = params["w_q"].shape[1] // heads_local
    q, k, v = ((x @ params[w]).reshape(t, heads_local, hd)
               for w in ("w_q", "w_k", "w_v"))
    if sync_mode == "sync_a":
        q, k, v = (_sync_a_cohere(a, mesh, axis, dim=1) for a in (q, k, v))
    o = _causal_attention(q, k, v).reshape(t, heads_local * hd)
    return all_reduce(o @ params["w_o"], mesh, axis)          # Gather


def make_tp_block(mesh: Any, kind: str, *, axis: str = "model",
                  sync_mode: str = "sync_b", n_heads: Optional[int] = None,
                  ) -> Callable[..., torch.Tensor]:
    """A TP block with the §3.2 weight specs.

    The returned callable takes (params, x) with *global* weights and
    the replicated ``x``; it slices this rank's weight shards (Scatter:
    the weights go rank-local, the activation stays replicated) and the
    all-reduce inside is the Gather.  Every rank of ``axis`` calls it
    together.
    """
    if sync_mode not in ("sync_a", "sync_b"):
        raise ValueError(f"unknown sync mode {sync_mode!r}")
    plan = PartitionPlan(axis)
    if kind == "mlp":
        body = functools.partial(mlp_tp, mesh=mesh, axis=axis,
                                 sync_mode=sync_mode)
        wnames = ("w_gate", "w_up", "w_down")
    elif kind == "attention":
        if n_heads is None:
            raise ValueError("attention block needs n_heads")
        body = functools.partial(attention_tp, n_heads=n_heads, mesh=mesh,
                                 axis=axis, sync_mode=sync_mode)
        wnames = ("w_q", "w_k", "w_v", "w_o")
    else:
        raise ValueError(f"unknown TP block kind {kind!r}")

    def block(params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        local = {w: shard_leaf(params[w], plan.spec_for(w), mesh)
                 for w in wnames}
        return body(local, x)

    return block


# ----------------------------------------------------------------------
# engine-level helpers
# ----------------------------------------------------------------------

def shard_params(params: Dict[str, Any], mesh: Any,
                 plan: Optional[PartitionPlan] = None) -> Dict[str, Any]:
    """This rank's slice of every weight under the plan (the node-local
    pool of each partition)."""
    plan = plan or PartitionPlan()
    return shard_tree(params, plan.params_specs(params), mesh)
