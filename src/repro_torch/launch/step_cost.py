"""Step cost: FLOPs and collective bytes of one step, the port's
counterpart of ``repro.launch.hlo_cost``.

The reference walks the compiled HLO text for dot FLOPs and the output
bytes of every collective.  The port has no HLO and no partitioner, so
it answers the same two questions another way:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over one call
  of the step on **meta** tensors (nothing is allocated or computed).
  It counts the matrix products (``mm``, ``bmm``, ``einsum``'s
  products, attention), as the HLO walk counts dots; a train step's
  backward runs inside the call (``torch.autograd.grad``), so its
  products and remat's recomputation are counted too.  The count is
  **global**: the step runs unsplit (``launch.specs``).
* **Collective bytes** (per device): from the plan's rules below, each a
  :class:`Collective` (op, axes, bytes of its output on one rank, calls
  per step), in the HLO walk's convention (an all-reduce's tensor, an
  all-gather's gathered block, a reduce-scatter's shard).  The forward
  half of every rule, and all of rule 3, is checked against the bytes
  the port's wrappers move on real ranks (``core.tp.collective_bytes_in``;
  ``tests/test_torch_dryrun.py``).  The training halves of rules 1, 2
  and 5 (the backward's all-reduce, the gradient's reduce-scatter) are
  **analytic and unchecked**: no code of the port runs those collectives,
  as the reference runs them only inside the dry run's compile, so a
  train case's collective term rests on these counts alone:

  1. a ROW/COL pair (a column-partitioned leaf ``w_o`` / ``w_down`` /
     ``w_out`` / ``out_proj`` split over "model" on its input dim) gives
     one all-reduce over "model" of the activation it outputs, (rows,
     tokens, d) in the activation type, per layer (``core.tp.mlp_tp``);
     two in training, the backward's all-reduce of the input gradient
     besides;
  2. an FSDP leaf (split over "data") gives one all-gather over "data"
     at use, of its use-time block (``make_layer_constraint``), and in
     training one reduce-scatter of its gradient, of its stored block;
  3. replicated gradients under data parallelism (training, a data axis
     above 1) give one all-reduce over the data axes of the rank's
     gradient elements of every leaf FSDP does not split, in float32,
     with the loss in front, and one of the 4-byte token count (the
     train step's ``_reduce_data``);
  4. the sequence-sharded combine gives one all-reduce MAX of ``m`` and
     two SUMs (``out``, ``lsum``), float32, per attention layer
     (``make_decode_attn_hook``);
  5. the MoE hook gives one all-reduce per block over "model", in
     float32: the (tokens, d) output (TP inside the experts) or the (E,
     capacity, d) buffer (expert-parallel); and a 4-byte all-reduce of
     the aux loss per data axis (``make_moe_hook``); two of the first in
     training, as in rule 1.  Experts split over "model" without the hook
     (a batch the data axes do not split) take the first all the same;
  6. the TP head merge gives one all-reduce per layer of the (B, S, Hq,
     D) float32 attention output (``make_paged_head_merge``; TP serving,
     not a dry-run step).

  Not counted: the vocab-split embedding's all-reduce (one activation a
  step, against two a layer) and the loss's reductions over a split
  vocabulary.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..core.tp import _path_str, axis_size
from ..models.weights import tree_leaves_with_path
from . import shardings as shd
from .mesh import data_axes

F32 = 4


@dataclasses.dataclass(frozen=True)
class Collective:
    """One rule's collective: ``op`` ("all-reduce", "all-reduce-max",
    "all-gather", "reduce-scatter") over ``axes``, ``nbytes`` of output
    on one rank per call, ``count`` calls a step."""

    op: str
    axes: Tuple[str, ...]
    nbytes: float
    count: int = 1
    rule: str = ""

    @property
    def total(self) -> float:
        return self.nbytes * self.count


@dataclasses.dataclass
class StepCost:
    flops: float                       # global
    coll_bytes: float                  # per device
    coll_breakdown: Dict[str, float]   # per device, by op
    collectives: List[Collective] = dataclasses.field(default_factory=list)


def count_flops(fn: Callable, args: Sequence[Any]) -> float:
    """FLOPs of one call ``fn(*args)`` (meta tensors: nothing runs)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def analyse_step(fn: Callable, args: Sequence[Any],
                 collectives: Sequence[Collective] = ()) -> StepCost:
    """The :class:`StepCost` of one call of ``fn(*args)``: its FLOPs by
    :func:`count_flops`, and the bytes of ``collectives`` (the rules'
    list, :func:`plan_collectives`) summed by op."""
    breakdown: Dict[str, float] = {}
    for c in collectives:
        breakdown[c.op] = breakdown.get(c.op, 0.0) + c.total
    return StepCost(flops=count_flops(fn, args),
                    coll_bytes=float(sum(breakdown.values())),
                    coll_breakdown=breakdown, collectives=list(collectives))


# ----------------------------------------------------------------------
# the rules (module docstring), one function each
# ----------------------------------------------------------------------

def row_col_rule(tokens: int, width: int, itemsize: int, *,
                 train: bool = False) -> Collective:
    """Rule 1: the all-reduce of one ROW/COL pair's (tokens, width)
    output."""
    return Collective("all-reduce", ("model",), tokens * width * itemsize,
                      2 if train else 1, "row/col")


def fsdp_rules(shape: Tuple[int, ...], stored: shd.Spec, mesh: Any,
               itemsize: int, *, train: bool = False) -> List[Collective]:
    """Rule 2 for one FSDP leaf of global ``shape`` under its stored
    spec: the all-gather of its use-time block, and in training the
    reduce-scatter of its gradient to its stored block."""
    block = math.prod(shd.shard_shape(shape, stored, mesh)) * itemsize
    n = mesh.shape.get("data", 1)
    out = [Collective("all-gather", ("data",), block * n, 1, "fsdp")]
    if train:
        out.append(Collective("reduce-scatter", ("data",), block, 1,
                              "fsdp"))
    return out


def dp_grad_rules(n_elements: int, dp: Tuple[str, ...],
                  ) -> List[Collective]:
    """Rule 3: the token count's all-reduce and the float32 gradient
    (loss in front) of ``n_elements`` on one rank."""
    return [Collective("all-reduce", dp, F32, 1, "dp-grad"),
            Collective("all-reduce", dp, F32 * (1 + n_elements), 1,
                       "dp-grad")]


def seq_combine_rules(rows: int, n_heads: int, head_dim: int,
                      axes: Tuple[str, ...], *, layers: int = 1,
                      ) -> List[Collective]:
    """Rule 4: one layer's combine of (rows, 1, Hq) ``m`` / ``lsum`` and
    (rows, 1, Hq, D) ``out``, float32."""
    ml = rows * n_heads * F32
    return [Collective("all-reduce-max", axes, ml, layers, "seq-combine"),
            Collective("all-reduce", axes, ml * head_dim, layers,
                       "seq-combine"),
            Collective("all-reduce", axes, ml, layers, "seq-combine")]


def moe_rules(cfg: Any, tokens: int, mesh: Any, *, expert_parallel: bool,
              layers: int = 1, train: bool = False,
              aux: bool = True) -> List[Collective]:
    """Rule 5 for ``layers`` MoE blocks of ``tokens`` rows a rank; the aux
    loss's all-reduces with ``aux`` (the hook's, which averages it over
    the data axes)."""
    d = cfg.d_model
    if expert_parallel:
        E = cfg.n_experts
        cap = max(int(tokens * cfg.experts_per_token / E
                      * cfg.capacity_factor), cfg.experts_per_token)
        nbytes = E * cap * d * F32
    else:
        nbytes = tokens * d * F32
    out = [Collective("all-reduce", ("model",), nbytes,
                      layers * (2 if train else 1), "moe")]
    for a in data_axes(mesh) if aux else ():
        out.append(Collective("all-reduce", (a,), F32, layers, "moe-aux"))
    return out


def head_merge_rule(batch: int, seq: int, n_heads: int, head_dim: int,
                    *, layers: int = 1) -> Collective:
    """Rule 6: one layer's head merge of (B, S, Hq, D) float32."""
    return Collective("all-reduce", ("model",),
                      batch * seq * n_heads * head_dim * F32, layers,
                      "head-merge")


# ----------------------------------------------------------------------
# the plan of a dry-run case
# ----------------------------------------------------------------------

def _live(c: Collective, mesh: Any) -> bool:
    return axis_size(mesh, c.axes) > 1


def plan_collectives(case: Any) -> List[Collective]:
    """Every collective the plan of ``case`` (a ``launch.specs``
    ``DryRunCase``) implies on one rank, by the rules; those over axes
    of size 1 dropped (nothing moves)."""
    cfg, mesh, policy = case.cfg, case.mesh, case.policy
    train = case.kind == "train"
    dp = data_axes(mesh)
    n_dp = axis_size(mesh, dp)
    rows = case.batch // n_dp if (dp and case.batch % n_dp == 0) \
        else case.batch
    q_len = 1 if case.kind == "decode" else case.seq_len
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    params, params_sh = case.args[0], case.in_shardings[0]
    specs = {_path_str(p): s for p, s in tree_leaves_with_path(params_sh)}
    out: List[Collective] = []
    grad_elems = 0
    fsdp = policy.fsdp_active(cfg) and "data" in mesh.axis_names
    for path, leaf in tree_leaves_with_path(params):
        p = _path_str(path)
        spec, shape = specs[p], tuple(leaf.shape)
        if fsdp and "data" in spec.dims:
            out += fsdp_rules(shape, spec, mesh, leaf.element_size(),
                              train=train)
        elif train:
            grad_elems += math.prod(shd.shard_shape(shape, spec, mesh))
        name = p.split("/")[-1]
        if (name in shd.COL_NAMES and "moe" not in p and leaf.dim() >= 2
                and spec.dims[leaf.dim() - 2] == "model"):
            layers = math.prod(shape[:-2])
            tokens = rows * (cfg.n_audio_frames if p.startswith("encoder")
                             else q_len)
            if p.startswith("encoder") and case.kind == "decode":
                continue                  # the encoder ran at prefill
            c = row_col_rule(tokens, shape[-1], itemsize, train=train)
            out.append(dataclasses.replace(c, count=c.count * layers))
    if train and n_dp > 1:
        out += dp_grad_rules(grad_elems, dp)
    n_moe = sum(k == "attn" for k in cfg.layer_kinds) if cfg.n_experts \
        else 0
    n_model = mesh.shape.get("model", 1)
    if n_moe and n_model > 1:
        # the experts split over "model" with the hook or without it (a
        # batch the data axes do not split): one Gather a block either way
        out += moe_rules(cfg, rows * q_len, mesh,
                         expert_parallel=(policy.expert_parallel
                                          and cfg.n_experts % n_model == 0),
                         layers=n_moe, train=train, aux=case.moe_hook)
    if case.seq_axes:
        _, batch_split = shd.seq_shard_axes(mesh, case.batch,
                                            case.cache_len, cfg.n_kv_heads)
        n_attn = sum(k == "attn" for k in cfg.layer_kinds)
        out += seq_combine_rules(rows if batch_split else case.batch,
                                 cfg.n_heads, cfg.resolved_head_dim,
                                 case.seq_axes, layers=n_attn)
    return [c for c in out if _live(c, mesh)]

