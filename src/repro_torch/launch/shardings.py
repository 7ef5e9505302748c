"""Sharding policy: the paper's §3.2 partition plan on a mesh
(``repro.launch.shardings``).

Specs are :class:`~repro_torch.core.tp.Spec` records ("which dim is split
over which axes"), the port's form of the reference's ``PartitionSpec``;
``core.tp.shard_tree`` cuts a rank's blocks by them.  The spec functions
read only a mesh's ``axis_names`` and ``shape``, so they take a
``launch.mesh.AbstractMesh`` (the dry run) or a ``Mesh`` of ranks alike.

Weight rules (name-driven, rank-aware: stacked layers carry a leading L
axis that stays whole):

    row-partitioned  (d_in, d_out): w_q w_k w_v w_gate w_up w_y w_x
                                    in_proj           -> (fsdp, "model")
    col-partitioned  (d_in, d_out): w_o w_down w_out out_proj
                                    -> ("model", fsdp)
    vocab-partitioned: embed (V, d) -> ("model", fsdp);
                       lm_head (d, V) -> (fsdp, "model")
    MoE experts (E, d, f): TP inside every expert
                       w_gate/w_up -> (ep, fsdp, "model"),
                       w_down (E, f, d) -> (ep, "model", fsdp)
                       (ep = the "model" axis on the expert dim in the
                       expert-parallel variant, None otherwise)
    everything else (norm gains, biases, A_log, conv, router): replicated

``fsdp`` is the "data" axis for archs above ``Policy.fsdp_threshold``
parameters, else None: the capacity analogue of ArcLight's per-node
pools.  Activations: batch over ("pod", "data"); KV caches split batch
over "data" and whole kv heads over "model", or their sequence over the
axes :func:`seq_shard_axes` picks.

Three hooks run on real ranks (a ``Mesh`` over a process group; every
rank calls them together):

* :func:`make_decode_attn_hook`: sequence-sharded flash-decoding over
  the ring cache (``Model.decode_attn_hook``);
* :func:`make_moe_hook`: the MoE FFN split over the model axis, TP
  inside the experts or expert-parallel (``Model.moe_hook``);
* :func:`make_layer_constraint`: the per-layer all-gather of FSDP
  leaves (``Model.param_constraint``).

The reference's ``with_sharding_constraint`` calls (in
:func:`make_activation_constraint` and around its hooks) only pin a
layout for XLA's partitioner and have no torch form: a rank already
holds only its own block.

Tensor-parallel paged serving has its own plan below
(:func:`serving_tp_param_specs`, :func:`paged_cache_specs`,
:func:`make_paged_head_merge`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.tp import (Spec, _path_str, all_gather, all_reduce, axis_size,
                       shard_leaf)
from ..models.config import ModelConfig
from ..models.weights import tree_map_with_path
from .mesh import data_axes

ROW_NAMES = ("w_q", "w_k", "w_v", "w_gate", "w_up", "w_y", "w_x",
             "in_proj")
COL_NAMES = ("w_o", "w_down", "w_out", "out_proj")


@dataclasses.dataclass(frozen=True)
class Policy:
    """The reference's sharding knobs, with its defaults.  Readers:
    ``fsdp`` / ``fsdp_threshold`` (:meth:`fsdp_active`),
    ``expert_parallel`` (:func:`param_spec`, :func:`make_moe_hook`),
    ``seq_shard_cache`` (:func:`cache_shardings`,
    :func:`make_decode_attn_hook`), ``shard_cache_head_dim`` (TP serving's
    ``ModelRunner``, which refuses ``False``: no paged variant),
    ``microbatches`` (``launch.specs``' train step) and ``head_aligned``
    (:func:`param_spec`)."""

    fsdp: bool = True               # shard big-arch params over "data"
    fsdp_threshold: float = 2e10    # params above this get FSDP
    expert_parallel: bool = False   # experts over "model" (vs TP inside)
    seq_shard_cache: bool = True    # long contexts: cache seq over axes
    shard_cache_head_dim: bool = True
    microbatches: int = 1           # gradient accumulation (train)
    head_aligned: bool = True       # replicate attention weights when Hq
                                    # does not divide the model axis
                                    # (§3.2 "partitioned by attention
                                    # heads"); off for prefill

    def fsdp_active(self, cfg: ModelConfig) -> bool:
        """FSDP on for ``cfg``: by ``cfg.param_count()``, as in the
        reference, so the port's specs stay equal to its."""
        return self.fsdp and cfg.param_count() > self.fsdp_threshold


def _one(axes: Tuple[str, ...]) -> Any:
    """A spec entry over ``axes``: the name itself for one axis (as
    ``PartitionSpec`` normalises a 1-tuple), else the tuple."""
    return axes[0] if len(axes) == 1 else axes


def param_spec(cfg: ModelConfig, path: str, ndim: int, shape: Any,
               mesh: Any, policy: Policy, *, use_time: bool = False) -> Spec:
    """The spec of the parameter leaf at ``path``.  ``use_time=True``
    drops the FSDP axis: the spec a weight must have at its point of use
    (what :func:`make_layer_constraint` gathers it to)."""
    name = path.split("/")[-1]
    fsdp = ("data" if (not use_time and policy.fsdp_active(cfg)
                       and "data" in mesh.axis_names) else None)
    n_model = mesh.shape.get("model", 1)

    def ok(dim_size: int, axis: Optional[str]) -> Optional[str]:
        if axis is None:
            return None
        return axis if dim_size % mesh.shape.get(axis, 1) == 0 else None

    # expert tensors (E, d, f) / (E, f, d), with an optional leading L
    if ndim == 3 + ("layers/" in path and cfg.uniform) and name in (
            "w_gate", "w_up", "w_down") and "moe" in path:
        lead = ndim - 3
        E, a, b = shape[lead:]
        ep = ("model" if (policy.expert_parallel and E % n_model == 0)
              else None)
        if ep:                       # expert-parallel: whole experts a rank
            spec = [None] * lead + [ep, None, None]
            if fsdp:
                spec[lead + 1] = ok(a, fsdp)
            return Spec(tuple(spec))
        if name == "w_down":         # (E, f, d): f is the split dim
            return Spec(tuple([None] * lead + [None, ok(a, "model"),
                                               ok(b, fsdp)]))
        return Spec(tuple([None] * lead + [None, ok(a, fsdp),
                                           ok(b, "model")]))

    if ndim >= 2:
        lead = ndim - 2
        a, b = shape[lead:]
        if name == "embed":
            return Spec((ok(a, "model"), ok(b, fsdp)))
        if name == "lm_head":
            return Spec((ok(a, fsdp), ok(b, "model")))
        # §3.2 "W_q, W_k, W_v are partitioned BY ATTENTION HEADS": when
        # the query heads do not divide the model axis, the whole
        # attention block is replicated (the MLP stays split)
        if (name in ("w_q", "w_k", "w_v", "w_o") and "attn" in path
                and policy.head_aligned and cfg.n_heads % n_model):
            if name == "w_o":
                return Spec(tuple([None] * lead + [None, ok(b, fsdp)]))
            return Spec(tuple([None] * lead + [ok(a, fsdp), None]))
        if name in ROW_NAMES:
            return Spec(tuple([None] * lead + [ok(a, fsdp),
                                               ok(b, "model")]))
        if name in COL_NAMES:
            return Spec(tuple([None] * lead + [ok(a, "model"),
                                               ok(b, fsdp)]))
    return Spec()


def params_shardings(cfg: ModelConfig, params: Any, mesh: Any,
                     policy: Policy) -> Any:
    """The spec tree of a parameter tree (tensors, meta ones too)."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(cfg, _path_str(path), leaf.dim(),
                                      tuple(leaf.shape), mesh, policy),
        params)


def shard_shape(shape: Tuple[int, ...], spec: Spec,
                mesh: Any) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` leaf under ``spec``
    (``NamedSharding.shard_shape``); a split must be even."""
    out = list(shape)
    for dim, axis in enumerate(spec.dims):
        n = axis_size(mesh, axis)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {n} ranks of {axis!r}")
        out[dim] //= n
    return tuple(out)


def _layer_specs(cfg: ModelConfig, mesh: Any,
                 policy: Policy) -> Dict[str, Spec]:
    """Path within one layer -> its stored spec, from the global shapes
    of every layer kind's parameters (a meta init: nothing is drawn)."""
    from ..models.common import meta_generator
    from ..models.transformer import build_model
    model = build_model(cfg)
    params = model.init(meta_generator())
    out: Dict[str, Spec] = {}
    for lp in model._layer_params(params["layers"]):
        tree_map_with_path(
            lambda path, spec: out.__setitem__(_path_str(path), spec),
            params_shardings(cfg, lp, mesh, policy))
    return out


def make_layer_constraint(cfg: ModelConfig, mesh: Any, policy: Policy,
                          ) -> Optional[Callable[[Any], Any]]:
    """The FSDP archs' per-layer weight unshard (``Model.param_constraint``);
    None when FSDP is off or the mesh has no "data" axis.

    A rank holds its block of each layer leaf under the stored spec
    (:func:`param_spec`), split over "data" where FSDP splits it; the
    returned ``constrain(layer_params)`` all-gathers every such leaf over
    "data" into its ``use_time=True`` block (still split over "model";
    that spec never names "data"), leaf by leaf in tree order on every
    rank.  Forward only: the gather has no gradient (the reference runs
    FSDP in no test either, only in its dry run's compile; the port's
    dry run counts it, ``launch.step_cost``)."""
    if not policy.fsdp_active(cfg) or "data" not in mesh.axis_names:
        return None
    stored = _layer_specs(cfg, mesh, policy)

    def constrain(layer_params: Any) -> Any:
        def f(path, leaf):
            for dim, axis in enumerate(stored[_path_str(path)].dims):
                if axis == "data":
                    leaf = all_gather(leaf, mesh, "data", dim=dim)
            return leaf
        return tree_map_with_path(f, layer_params)

    return constrain


def moe_hook_specs(cfg: ModelConfig, mesh: Any, policy: Policy) -> Dict:
    """The spec of each MoE leaf (one layer's ``moe`` subtree) that
    :func:`make_moe_hook` takes: expert-parallel, whole experts over
    "model"; else ``w_gate`` / ``w_up`` split on f (their last dim) and
    ``w_down`` on f (its middle dim); the router whole."""
    n_model = mesh.shape.get("model", 1)
    if policy.expert_parallel and cfg.n_experts % n_model == 0:
        w = {"w_gate": Spec(("model", None, None)),
             "w_up": Spec(("model", None, None)),
             "w_down": Spec(("model", None, None))}
    else:
        w = {"w_gate": Spec((None, None, "model")),
             "w_up": Spec((None, None, "model")),
             "w_down": Spec((None, "model", None))}
    out = {"router": Spec(), **w}
    if cfg.act != "silu":
        out.pop("w_gate")
    return out


def moe_hook_applies(cfg: ModelConfig, mesh: Any, *,
                     batch_size: int) -> bool:
    """Whether :func:`make_moe_hook` gives a hook on ``mesh``: experts,
    a data axis the batch splits over, and a d_ff the model axis
    splits."""
    dp = data_axes(mesh)
    return bool(cfg.n_experts and dp
                and batch_size % axis_size(mesh, dp) == 0
                and cfg.d_ff % mesh.shape.get("model", 1) == 0)


def make_moe_hook(cfg: ModelConfig, mesh: Any, policy: Policy, *,
                  batch_size: int) -> Optional[Callable]:
    """MoE dispatch split over the model axis, on real ranks
    (``Model.moe_hook``); None where the reference installs none (no
    experts, no data axis, a batch or d_ff that does not split).

    ``hook(moe_params, x) -> (y, aux)``: ``x`` is this rank's rows of the
    batch (its block over the data axes), ``moe_params`` this rank's
    blocks of one layer's ``moe`` leaves under :func:`moe_hook_specs`.
    Each rank dispatches its own tokens with local indices (no dispatch
    collective).  TP inside the experts: every rank runs the capacity
    scatter (``models.moe.moe_scatter``) with its f-slices, and one
    all-reduce over "model" sums the partial outputs (§3.3's Gather).
    Expert-parallel (``policy.expert_parallel``, E splits over "model"):
    :func:`_moe_expert_parallel`.  ``aux`` is averaged over the data
    axes.  The all-reduces run in float32 whatever ``x``'s type, as the
    head merge's do: one transport on every backend."""
    if not moe_hook_applies(cfg, mesh, batch_size=batch_size):
        return None
    from ..models.moe import moe_scatter
    dp = data_axes(mesh)
    n_model = mesh.shape.get("model", 1)
    ep = policy.expert_parallel and cfg.n_experts % n_model == 0

    def hook(moe_params: Dict[str, torch.Tensor], x: torch.Tensor):
        if ep:
            y, aux = _moe_expert_parallel(
                moe_params, x, k=cfg.experts_per_token, act=cfg.act,
                capacity_factor=cfg.capacity_factor, mesh=mesh,
                axis="model")
        else:
            y, aux = moe_scatter(moe_params, x, k=cfg.experts_per_token,
                                 act=cfg.act,
                                 capacity_factor=cfg.capacity_factor)
            y = all_reduce(y.float(), mesh, "model").to(x.dtype)  # Gather
        for a in dp:
            aux = all_reduce(aux.reshape(1), mesh, a)[0] / mesh.shape[a]
        return y, aux

    return hook


def _moe_expert_parallel(mp: Dict[str, torch.Tensor], x: torch.Tensor, *,
                         k: int, act: str, capacity_factor: float,
                         mesh: Any, axis: str):
    """Expert-parallel dispatch: each ``axis`` rank owns E/n whole
    experts at full width; the tokens are the same on every rank of
    ``axis``, so each rank fills the whole (E, capacity, d) buffer,
    runs its experts' rows, and one all-reduce of the (E, capacity, d)
    output over ``axis`` merges the combine (§3.3's Gather)."""
    from ..models.moe import (_aux_loss, _combine, _dispatch, _expert_ffn,
                              _router)
    n = mesh.shape.get(axis, 1)
    m_idx = mesh.axis_index(axis) if n > 1 else 0
    E_local = mp["w_up"].shape[0]
    E = E_local * n
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    _, probs, topv, topi = _router(mp, x2d, k)
    cap, buf, assign = _dispatch(x2d, topv, topi, E, capacity_factor)
    buf = buf[:-1].reshape(E, cap, d)
    lo = m_idx * E_local
    mine = _expert_ffn(mp, buf[lo:lo + E_local], act)
    out = torch.zeros((E, cap, d), dtype=torch.float32, device=x.device)
    out[lo:lo + E_local] = mine
    out = all_reduce(out, mesh, axis).to(x.dtype)
    y2d = _combine(out, x2d, assign)
    return y2d.reshape(x.shape), _aux_loss(probs, topi, E)


def seq_shard_axes(mesh: Any, batch_size: int, cache_len: int,
                   n_kv_heads: int) -> Tuple[Tuple[str, ...], bool]:
    """Tiered cache-sequence sharding decision, shared by the cache specs
    and the decode hook so they never diverge.

    Returns (axes, batch_sharded): the axes the cache sequence splits
    over ("model" for batch-split caches, up to data x model for a
    long-context batch of 1), or () where whole kv heads split for free
    or where a slice would drop below one 512-slot attention chunk."""
    n_data = mesh.shape.get("data", 1)
    n_model = mesh.shape.get("model", 1)
    batch_sharded = batch_size % max(n_data, 1) == 0 and n_data > 1
    if batch_sharded:
        if n_kv_heads % max(n_model, 1) == 0:
            return (), True
        if (n_model > 1 and cache_len % n_model == 0
                and cache_len // n_model >= 512):
            return ("model",), True
        return (), True
    for cand in (("data", "model"), ("data",), ("model",)):
        axes = tuple(a for a in cand if mesh.shape.get(a, 1) > 1)
        n = math.prod(mesh.shape[a] for a in axes)
        if axes and n > 1 and cache_len % n == 0 and cache_len // n >= 512:
            return axes, False
    return (), False


def make_decode_attn_hook(cfg: ModelConfig, mesh: Any, policy: Policy, *,
                          batch_size: int, cache_len: int,
                          ) -> Optional[Callable]:
    """Sequence-sharded flash-decoding with rank-local cache writes, on
    real ranks (``Model.decode_attn_hook``); None where the reference
    installs none.

    The ring's sequence splits over :func:`seq_shard_axes`' axes; a rank
    holds the block of each layer's ``k`` / ``v`` (B, M, Hkv, D) that
    :func:`cache_shardings` gives it, and the whole position array ``pos``
    (M,).  ``hook(q, k_new, v_new, ck, cv, cp, window, pos) -> out`` for
    one layer's decode step (q (B, 1, Hq, D), the new token's K/V (B, 1,
    Hkv, D), ``pos`` the host int position):

    * write: the new K/V lands in place on the one rank that owns ring
      slot ``pos % M``; every rank records ``pos`` in ``cp``;
    * attend: every rank runs ``flash_attention(return_partial=True)``
      over its slice with its slots' positions, the window and softcap;
    * Gather: :func:`~repro_torch.models.attention.combine_partials`.

    ``hook.writes`` counts the slots this rank wrote."""
    if not policy.seq_shard_cache:
        return None
    seq_axes, _ = seq_shard_axes(mesh, batch_size, cache_len,
                                 cfg.n_kv_heads)
    if not seq_axes:
        return None
    from ..models.attention import combine_partials, flash_attention
    local = cache_len // axis_size(mesh, seq_axes)

    def hook(q, kn, vn, ck, cv, cp, window, pos):
        idx = mesh.axis_index(seq_axes)
        slot = pos % cache_len
        local_slot = slot - idx * local
        if 0 <= local_slot < local:
            ck[:, local_slot] = kn[:, 0]
            cv[:, local_slot] = vn[:, 0]
            hook.writes += 1
        cp[slot] = pos
        part = flash_attention(
            q, ck, cv, causal=True, window=window, q_offset=pos,
            kv_positions=cp[idx * local:(idx + 1) * local],
            chunk=min(512, local), return_partial=True,
            softcap=cfg.attn_logit_softcap)
        return combine_partials(part, mesh, seq_axes, q.dtype)

    hook.writes = 0
    hook.seq_axes = seq_axes
    return hook


def make_activation_constraint(mesh: Any, *, batch_size: int,
                               ) -> Optional[Callable]:
    """The reference pins the batch axis of activations to ("pod",
    "data") for XLA's partitioner; a rank here already holds only its
    rows, so the port's constraint is the slice itself: ``constrain(x)``
    returns this rank's block of a global ``x`` over the data axes (the
    block the reference's spec gives it).  None where the reference
    installs none."""
    dp = data_axes(mesh)
    if not dp or batch_size % axis_size(mesh, dp):
        return None

    def constrain(x: torch.Tensor) -> torch.Tensor:
        return shard_leaf(x, Spec((_one(dp),) + (None,) * (x.dim() - 1)),
                          mesh)

    return constrain


def batch_shardings(cfg: ModelConfig, batch_shapes: Dict[str, Any],
                    mesh: Any, *, batch_size: int) -> Dict[str, Spec]:
    """The batch entries' specs: rows over the data axes when they
    split evenly."""
    dp = data_axes(mesh)
    bspec = (_one(dp) if (dp and batch_size % axis_size(mesh, dp) == 0)
             else None)
    return {k: Spec((bspec,) + (None,) * (v.dim() - 1))
            for k, v in batch_shapes.items()}


def cache_shardings(cfg: ModelConfig, cache: Any, mesh: Any,
                    policy: Policy, *, batch_size: int,
                    long_context: bool) -> Any:
    """The ring cache's spec tree.  Leaf layouts (a uniform stack and the
    block layout's super-blocks have a leading L):
    ``k``/``v`` (L, B, M, Hkv, hd), ``pos`` (L, M), ``ssd.state``
    (L, B, H, P, N), conv tails (L, B, W-1, C), ``memory`` (B, M, d)."""
    n_data = mesh.shape.get("data", 1)
    n_model = mesh.shape.get("model", 1)
    batch_ax = "data" if batch_size % n_data == 0 else None

    def f(path, leaf):
        p = _path_str(path)
        name = p.split("/")[-1]
        nd = leaf.dim()
        lead = 1 if (("blocks" in p) or (cfg.uniform and "layers" in p)) \
            else 0
        spec: list = [None] * nd
        if name in ("k", "v") and nd == lead + 4:
            B, M, H, hd = leaf.shape[lead:]
            axes, bs = seq_shard_axes(mesh, batch_size, M, H)
            if bs:
                spec[lead] = "data"
                if axes:
                    # sequence over "model": the decode hook merges
                    # flash partials
                    spec[lead + 1] = axes[0]
                elif H % n_model == 0:
                    spec[lead + 2] = "model"    # whole kv heads a rank
            elif axes and policy.seq_shard_cache:
                spec[lead + 1] = _one(axes)
        elif name in ("state", "h", "conv") and nd >= lead + 2:
            if batch_ax and leaf.shape[lead] % n_data == 0:
                spec[lead] = batch_ax
        elif name == "memory" and nd == 3:
            if batch_ax and leaf.shape[0] % n_data == 0:
                spec[0] = batch_ax
        return Spec(tuple(spec))
    return tree_map_with_path(f, cache)


def replicated(mesh: Any) -> Spec:
    """The spec of a leaf every rank of ``mesh`` holds whole.  A ``Spec``
    binds no mesh (the reference's ``NamedSharding`` does), so ``mesh``
    only keeps the reference's call form."""
    return Spec()


# ----------------------------------------------------------------------
# tensor-parallel paged serving (head-sharded page pools)
# ----------------------------------------------------------------------
#
# The continuous engine's TP mode (``serving.runner.ModelRunner`` with
# ``mesh=``) runs the paged forward on every rank of the mesh's
# ``"model"`` axis: the paper's node≅shard mapping, with each rank
# standing in for one NUMA node.  The cache splits by **kv head**: every
# rank attends over its local heads of every page, so page allocation,
# sharing, copy-on-write and eviction stay host bookkeeping with zero
# cross-rank KV bytes, and one all-reduce per layer
# (:func:`make_paged_head_merge`) gathers the heads' outputs.
# Everything outside attention (norms, MLP, embed / lm_head, ``w_o``) is
# replicated, so that all-reduce is the forward's only collective.

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
