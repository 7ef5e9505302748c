"""Roofline analysis against one H100 (``repro.launch.roofline``).

Three terms per (arch x shape x mesh), all per device, from a dry-run
case (``launch.specs``) on meta tensors; no wall clock, no device:

    compute    = FLOPs / chips / PEAK_FLOPS_BF16
    memory     = (argument + output bytes) / HBM_BW
    collective = sum over the plan's collectives of bytes / link rate

* FLOPs are ``launch.step_cost``'s global count of the unsplit step,
  divided evenly over the chips: a **lower bound** on a device's share.
  The reference's per-device HLO count also holds the redundant work of
  leaves a rank holds whole (replicated attention, norms), which a
  global count cannot see.
* Bytes are every argument's block on one device under its spec
  (parameters, optimizer state, cache, batch) plus every output that is
  new storage, each byte counted once: a cache or parameter updated in
  place counts once, with the argument (so a train step's bound leaves
  out the writing of its parameters and moments).  Activations are not
  counted.
* Each collective moves at the rate of the slowest link its axes span
  (``launch.mesh.axis_link_bw``: NVLink inside a node, InfiniBand
  across).

``MODEL_FLOPS`` is 6·N·D for training and 2·N·D for a forward-only
step, with N the parameters of the **tree** (MoE: only the active
experts, k of E), not ``ModelConfig.param_count``, which leaves out
RecurrentGemma's RG-LRU gate weights; the useful-FLOPs ratio divides it
by the global count.  Policy decisions (``Policy.fsdp_active``) still
read ``param_count``, as the reference's do, so the specs stay equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

from ..core.tp import _path_str
from ..models.weights import tree_leaves_with_path
from . import shardings as shd
from .mesh import HBM_BW, PEAK_FLOPS_BF16, axis_link_bw
from .step_cost import analyse_step, plan_collectives


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                     # per device (global / chips)
    mem_bytes: float                 # per device
    coll_bytes: float                # per device
    coll_breakdown: Dict[str, float]
    model_flops: float               # global
    t_compute: float
    t_memory: float
    t_collective: float
    bytes_per_device: Optional[float] = None   # arguments alone
    note: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_s(self) -> float:
        """The step's least time on one device: the larger of the
        compute and memory terms."""
        return max(self.t_compute, self.t_memory)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["useful_flops_ratio"] = self.useful_flops_ratio
        return d


def _active_fraction(cfg: Any, path: str) -> float:
    if cfg.n_experts and "moe" in path and path.split("/")[-1] in (
            "w_gate", "w_up", "w_down"):
        return cfg.experts_per_token / cfg.n_experts
    return 1.0


def model_flops_for(cfg: Any, params: Any, *, kind: str,
                    tokens: int) -> float:
    """MODEL_FLOPS: 6·N·D training, 2·N·D forward-only, with N counted
    over the parameter tree ``params`` (meta tensors will do), MoE
    expert stacks at k/E."""
    n = sum(leaf.numel() * _active_fraction(cfg, _path_str(path))
            for path, leaf in tree_leaves_with_path(params))
    return (6.0 if kind == "train" else 2.0) * n * tokens


def _bytes(tree: Any, specs: Any, mesh: Any, skip=()) -> float:
    """Per-device bytes of the tensors (and 4 per host int) of ``tree``
    under ``specs`` (the same structure, or one spec for all), leaving
    out the tensors in ``skip`` (by identity)."""
    flat = ({} if isinstance(specs, shd.Spec) else
            {_path_str(p): s for p, s in tree_leaves_with_path(specs)})
    skip_ids = {id(x) for x in skip}
    total = 0.0
    for path, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, int):
            total += 4
            continue
        if not hasattr(leaf, "element_size") or id(leaf) in skip_ids:
            continue
        spec = flat.get(_path_str(path), specs if isinstance(
            specs, shd.Spec) else shd.Spec())
        total += math.prod(shd.shard_shape(tuple(leaf.shape), spec, mesh)) \
            * leaf.element_size()
    return total


def argument_bytes(case: Any) -> float:
    """Per-device bytes of the case's arguments under their specs."""
    return sum(_bytes(a, s, case.mesh)
               for a, s in zip(case.args, case.in_shardings))


def analyse(case: Any) -> RooflineReport:
    """The roofline of a dry-run case (``launch.specs.build_case``) on
    the mesh it was built for (``case.mesh``, named by its sizes, e.g.
    "16x16"): one meta call of its step for the FLOPs and the outputs,
    the plan's collectives for the rest."""
    mesh = case.mesh
    chips = mesh.size
    outs: List[Any] = []

    def step(*args):
        outs.append(case.step_fn(*args))

    args_leaves = [x for a in case.args for _, x in tree_leaves_with_path(a)]
    cost = analyse_step(step, case.args, plan_collectives(case))
    arg_b = argument_bytes(case)
    out_b = sum(_bytes(o, s, mesh, skip=args_leaves)
                for o, s in zip(outs[0], case.out_shardings))
    t_coll = sum(c.total / axis_link_bw(mesh, c.axes)
                 for c in cost.collectives)
    flops = cost.flops / chips
    return RooflineReport(
        arch=case.arch, shape=case.shape_name,
        mesh="x".join(str(n) for n in mesh.shape.values()),
        chips=chips, flops=flops, mem_bytes=arg_b + out_b,
        coll_bytes=cost.coll_bytes, coll_breakdown=cost.coll_breakdown,
        model_flops=model_flops_for(case.cfg, case.args[0], kind=case.kind,
                                    tokens=case.tokens),
        t_compute=flops / PEAK_FLOPS_BF16, t_memory=(arg_b + out_b) / HBM_BW,
        t_collective=t_coll, bytes_per_device=arg_b, note=case.note)


def format_table(reports: List[RooflineReport]) -> str:
    hdr = (f"| {'arch':22s} | {'shape':11s} | {'mesh':9s} | "
           f"{'compute_s':>10s} | {'memory_s':>10s} | {'coll_s':>10s} | "
           f"{'dominant':10s} | {'useful':>6s} | {'GiB/dev':>8s} |")
    sep = "|" + "|".join("-" * (len(c) + 2)
                         for c in hdr.split("|")[1:-1]) + "|"
    rows = [hdr, sep]
    for r in reports:
        gib = (f"{r.bytes_per_device / 2**30:8.2f}"
               if r.bytes_per_device else "     n/a")
        rows.append(
            f"| {r.arch:22s} | {r.shape:11s} | {r.mesh:9s} | "
            f"{r.t_compute:10.3e} | {r.t_memory:10.3e} | "
            f"{r.t_collective:10.3e} | {r.dominant:10s} | "
            f"{r.useful_flops_ratio:6.2f} | {gib} |")
    return "\n".join(rows)
