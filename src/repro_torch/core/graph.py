"""ArcLight forward graph builder + computation scheduler (paper §2.5, §2.6, A.1).

The port's ``repro.core.graph``: the builder is host bookkeeping,
copied; the scheduler executes each node with torch on its device.

The builder exposes tensor-operation interfaces that create graph nodes;
each interface takes source tensor pointers (``TensorBundle``) plus
parameters and returns the output bundle.  Because model definitions are
written in execution order, the paper observes that the construction
order *is* a topological order — so instead of re-analysing the graph we
simply append every node to a static sequential container at the end of
its construction function.  The container supports four construction
modes (paper A.1):

* **Serial**   — append a single-tensor bundle to the tail.
* **Scatter**  — append a multi-tensor bundle after a single tensor:
  transition from one graph to ``n`` parallel subgraphs.
* **Parallel** — within TP-enabled modules, append each tensor of a
  bundle one-to-one onto the previous bundle.
* **Gather**   — append a single tensor after a multi-tensor bundle:
  transition from subgraphs back to a single graph.

The **scheduler** (§2.6) then walks the container in order, executing
each node and synchronising afterwards.  Here execution means
interpreting the node with torch; on the real engine each node also
carries the thread-group and NUMA-pool assignment produced by
``core.threads`` / ``core.memory``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .tensor import OpType, TensorBundle, TensorHeader, as_bundle, make_header


class GraphError(RuntimeError):
    pass


@dataclasses.dataclass
class KVCacheSlot:
    """A KV-cache tensor managed by the graph module (paper §2.5)."""

    name: str
    header: TensorHeader
    # live value; persists across graph executions.
    value: Optional[torch.Tensor] = None


class ForwardGraph:
    """Static computation graph with an append-order execution list."""

    def __init__(self, *, n_nodes: int = 1) -> None:
        #: static linked list (array-based) of execution order (A.1).
        self.order: List[TensorHeader] = []
        #: NUMA / TP degree the graph is built for (1 = no TP).
        self.n_nodes = n_nodes
        #: whether construction is currently inside a Scatter..Gather span.
        self._tp_depth = 0
        #: KV cache slots, keyed by name (§2.5).
        self.kv_slots: Dict[str, KVCacheSlot] = {}
        #: inputs in declaration order.
        self.inputs: List[TensorHeader] = []
        #: weights in declaration order.
        self.weights: List[TensorHeader] = []

    # ------------------------------------------------------------------
    # static-list construction modes (A.1)
    # ------------------------------------------------------------------
    def _append(self, header: TensorHeader) -> TensorHeader:
        if self.order:
            # each node stores the index of its successor
            self.order[-1].next_index = len(self.order)
        self.order.append(header)
        return header

    def _append_serial(self, bundle: TensorBundle) -> TensorBundle:
        self._append(bundle.single)
        return bundle

    def _append_parallel(self, bundle: TensorBundle) -> TensorBundle:
        for h in bundle:
            self._append(h)
        return bundle

    # ------------------------------------------------------------------
    # node constructors
    # ------------------------------------------------------------------
    def input(self, shape: Sequence[int], dtype: Any = np.float32,
              name: Optional[str] = None) -> TensorBundle:
        h = make_header(shape, dtype, name=name, op=OpType.INPUT)
        self.inputs.append(h)
        return TensorBundle(h)

    def weight(self, shape: Sequence[int], dtype: Any = np.float32,
               name: Optional[str] = None,
               node_id: Optional[int] = None) -> TensorBundle:
        h = make_header(shape, dtype, name=name, op=OpType.WEIGHT,
                        node_id=node_id)
        self.weights.append(h)
        return TensorBundle(h)

    def _unary(self, op: OpType, x: TensorBundle | TensorHeader,
               out_shape: Optional[Callable[[Tuple[int, ...]], Tuple[int, ...]]] = None,
               **params: Any) -> TensorBundle:
        x = as_bundle(x)
        outs = []
        for h in x:
            shape = out_shape(h.shape) if out_shape else h.shape
            outs.append(make_header(shape, h.dtype, op=op, srcs=(h,),
                                    node_id=h.node_id, **params))
        out = TensorBundle(outs)
        return (self._append_parallel(out) if out.is_parallel
                else self._append_serial(out))

    def _binary(self, op: OpType, a: TensorBundle | TensorHeader,
                b: TensorBundle | TensorHeader,
                shape_fn: Callable[[Tuple[int, ...], Tuple[int, ...]], Tuple[int, ...]],
                **params: Any) -> TensorBundle:
        a, b = as_bundle(a), as_bundle(b)
        if len(a) != len(b):
            if len(a) == 1:
                a = TensorBundle([a.single] * len(b))
            elif len(b) == 1:
                b = TensorBundle([b.single] * len(a))
            else:
                raise GraphError(f"bundle arity mismatch: {len(a)} vs {len(b)}")
        outs = []
        for ha, hb in zip(a, b):
            node = ha.node_id if ha.node_id is not None else hb.node_id
            outs.append(make_header(shape_fn(ha.shape, hb.shape), ha.dtype,
                                    op=op, srcs=(ha, hb), node_id=node,
                                    **params))
        out = TensorBundle(outs)
        return (self._append_parallel(out) if out.is_parallel
                else self._append_serial(out))

    # -- public op interfaces (the module interfaces of A.1) ----------

    def gemm(self, w: TensorBundle, x: TensorBundle) -> TensorBundle:
        """y = w @ x with w (out, in), x (in, cols) -> y (out, cols)."""

        def shape_fn(ws: Tuple[int, ...], xs: Tuple[int, ...]) -> Tuple[int, ...]:
            if ws[-1] != xs[0]:
                raise GraphError(f"gemm shape mismatch {ws} @ {xs}")
            return ws[:-1] + xs[1:]

        return self._binary(OpType.GEMM, w, x, shape_fn)

    def add(self, a: TensorBundle, b: TensorBundle) -> TensorBundle:
        return self._binary(OpType.ADD, a, b, lambda s, _: s)

    def mul(self, a: TensorBundle, b: TensorBundle) -> TensorBundle:
        return self._binary(OpType.MUL, a, b, lambda s, _: s)

    def silu(self, x: TensorBundle) -> TensorBundle:
        return self._unary(OpType.SILU, x)

    def gelu(self, x: TensorBundle) -> TensorBundle:
        return self._unary(OpType.GELU, x)

    def softmax(self, x: TensorBundle, axis: int = -1) -> TensorBundle:
        return self._unary(OpType.SOFTMAX, x, axis=axis)

    def rmsnorm(self, x: TensorBundle, gain: TensorBundle,
                eps: float = 1e-6) -> TensorBundle:
        return self._binary(OpType.RMSNORM, x, gain, lambda s, _: s, eps=eps)

    def reshape(self, x: TensorBundle, shape: Sequence[int]) -> TensorBundle:
        shape = tuple(int(s) for s in shape)
        return self._unary(OpType.RESHAPE, x, out_shape=lambda _: shape,
                           new_shape=shape)

    def transpose(self, x: TensorBundle, perm: Sequence[int]) -> TensorBundle:
        perm = tuple(perm)
        return self._unary(
            OpType.TRANSPOSE, x,
            out_shape=lambda s: tuple(s[p] for p in perm), perm=perm)

    def copy(self, x: TensorBundle) -> TensorBundle:
        return self._unary(OpType.COPY, x)

    def embed(self, table: TensorBundle, ids: TensorBundle) -> TensorBundle:
        def shape_fn(ts: Tuple[int, ...], is_: Tuple[int, ...]) -> Tuple[int, ...]:
            return is_ + (ts[-1],)
        return self._binary(OpType.EMBED, table, ids, shape_fn)

    # -- KV cache management (§2.5) ------------------------------------

    def kv_create(self, name: str, shape: Sequence[int],
                  dtype: Any = np.float32) -> KVCacheSlot:
        if name in self.kv_slots:
            raise GraphError(f"kv slot {name!r} already exists")
        h = make_header(shape, dtype, name=name, op=OpType.WEIGHT)
        slot = KVCacheSlot(name=name, header=h)
        self.kv_slots[name] = slot
        return slot

    def kv_set(self, name: str, value: TensorBundle,
               position: TensorBundle) -> TensorBundle:
        slot = self.kv_slots[name]
        h = make_header(slot.header.shape, slot.header.dtype, op=OpType.KV_SET,
                        srcs=(slot.header, value.single, position.single),
                        kv_name=name)
        return self._append_serial(TensorBundle(h))

    def kv_get(self, name: str) -> TensorBundle:
        slot = self.kv_slots[name]
        h = make_header(slot.header.shape, slot.header.dtype, op=OpType.KV_GET,
                        srcs=(slot.header,), kv_name=name)
        return self._append_serial(TensorBundle(h))

    # -- Scatter / Gather (§3.3) ---------------------------------------

    def scatter(self, x: TensorBundle, *, axis: Optional[int] = None,
                n: Optional[int] = None) -> TensorBundle:
        """Enter TP mode: produce one view tensor per subgraph.

        ``axis=None`` replicates ``x`` into each subgraph (the paper's
        Scatter makes *views* of the input activation for each NUMA
        node; the row-partitioned weights already live node-locally so
        a replicated activation view means zero data motion for the
        activation too — each node reads the same buffer).
        ``axis=k`` slices ``x`` along axis ``k`` instead.
        """
        n = n or self.n_nodes
        if n < 2:
            raise GraphError("scatter needs n >= 2 subgraphs")
        src = x.single
        outs = []
        for i in range(n):
            if axis is None:
                shape = src.shape
            else:
                if src.shape[axis] % n:
                    raise GraphError(
                        f"scatter axis {axis} ({src.shape[axis]}) not divisible by {n}")
                shape = tuple(
                    s // n if d == axis % len(src.shape) else s
                    for d, s in enumerate(src.shape))
            outs.append(make_header(
                shape, src.dtype, op=OpType.SCATTER, srcs=(src,),
                node_id=i, axis=axis, part=i, n=n))
        self._tp_depth += 1
        bundle = TensorBundle(outs)
        # Scatter mode: a multi-tensor bundle appended after a single tensor.
        return self._append_parallel(bundle)

    def gather(self, x: TensorBundle, *, mode: str = "sum",
               axis: int = 0) -> TensorBundle:
        """Leave TP mode: combine subgraph outputs into a single tensor.

        ``mode='sum'`` adds partial outputs (column-partitioned weights:
        the paper's Z = Z1 + Z2); ``mode='concat'`` concatenates along
        ``axis`` (row-partitioned outputs kept split).
        """
        if not x.is_parallel:
            raise GraphError("gather needs a parallel bundle")
        if mode == "sum":
            shape = x[0].shape
        elif mode == "concat":
            shape = tuple(
                s * len(x) if d == axis % len(x[0].shape) else s
                for d, s in enumerate(x[0].shape))
        else:
            raise GraphError(f"unknown gather mode {mode!r}")
        h = make_header(shape, x[0].dtype, op=OpType.GATHER,
                        srcs=tuple(x), mode=mode, axis=axis)
        self._tp_depth -= 1
        # Gather mode: a single tensor appended after a multi-tensor bundle.
        return self._append_serial(TensorBundle(h))

    # ------------------------------------------------------------------
    # properties / verification
    # ------------------------------------------------------------------
    def verify_topological(self) -> bool:
        """Check the append-order container is a valid topological order."""
        seen = set(id(h) for h in self.inputs)
        seen |= set(id(h) for h in self.weights)
        seen |= set(id(s.header) for s in self.kv_slots.values())
        for h in self.order:
            for s in h.srcs:
                if id(s) not in seen and s not in self.order[: self.order.index(h)]:
                    return False
            seen.add(id(h))
        return True

    def node_count(self) -> int:
        return len(self.order)


# ----------------------------------------------------------------------
# Graph computation scheduler (§2.6)
# ----------------------------------------------------------------------

class GraphScheduler:
    """Executes a ForwardGraph node-by-node in static-list order.

    The C++ scheduler runs each node on the thread pool and barriers
    after every node; this interpreter binds each header to a concrete
    tensor on ``device`` in a values dict, which keeps the same
    sequential semantics.  It is deliberately simple — the production
    fast path is the model zoo — but it is *complete*: every op the
    graph builder can emit is executable, so models defined through the
    builder run end to end (and the TP scatter/gather semantics can be
    checked numerically against the non-TP graph).  ``device`` is the
    torch device the nodes run on (CUDA unless the caller asks for the
    CPU; nothing falls back).
    """

    def __init__(self, graph: ForwardGraph,
                 barrier_hook: Optional[Callable[[TensorHeader], None]] = None,
                 *, device: Any = "cuda"):
        self.graph = graph
        self.barrier_hook = barrier_hook
        self.device = torch.device(device)
        #: count of per-node barrier synchronisations performed.
        self.barrier_count = 0

    # -- op semantics ---------------------------------------------------
    def _exec_node(self, h: TensorHeader,
                   env: Dict[int, torch.Tensor]) -> torch.Tensor:
        def val(src: TensorHeader) -> torch.Tensor:
            return env[id(src)]

        op = h.op
        if op is OpType.GEMM:
            w, x = h.srcs
            return torch.matmul(val(w), val(x))
        if op is OpType.ADD:
            return val(h.srcs[0]) + val(h.srcs[1])
        if op is OpType.MUL:
            return val(h.srcs[0]) * val(h.srcs[1])
        if op is OpType.SILU:
            return F.silu(val(h.srcs[0]))
        if op is OpType.GELU:
            # jax.nn.gelu's default is the tanh approximation
            return F.gelu(val(h.srcs[0]), approximate="tanh")
        if op is OpType.SOFTMAX:
            return torch.softmax(val(h.srcs[0]), dim=h.params["axis"])
        if op is OpType.RMSNORM:
            x, g = val(h.srcs[0]), val(h.srcs[1])
            eps = h.params["eps"]
            var = x.square().mean(dim=-1, keepdim=True)
            return x * torch.rsqrt(var + eps) * g
        if op is OpType.RESHAPE:
            return val(h.srcs[0]).reshape(h.params["new_shape"])
        if op is OpType.TRANSPOSE:
            return val(h.srcs[0]).permute(h.params["perm"])
        if op is OpType.COPY or op is OpType.VIEW:
            return val(h.srcs[0])
        if op is OpType.EMBED:
            table, ids = h.srcs
            return val(table)[val(ids).long()]
        if op is OpType.SCATTER:
            src = val(h.srcs[0])
            axis, part, n = h.params["axis"], h.params["part"], h.params["n"]
            if axis is None:
                return src
            size = src.shape[axis] // n
            return src.narrow(axis, part * size, size)
        if op is OpType.GATHER:
            parts = [val(s) for s in h.srcs]
            if h.params["mode"] == "sum":
                out = parts[0]
                for p in parts[1:]:
                    out = out + p
                return out
            return torch.cat(parts, dim=h.params["axis"])
        if op is OpType.KV_SET:
            slot_h, value, pos = h.srcs
            cache, v = env[id(slot_h)], val(value)
            # jax.lax.dynamic_update_slice_in_dim: the start clamps so
            # the update fits; the cache is a new value, not written in
            # place (the caller's kv input stays as it was)
            start = min(max(int(val(pos).reshape(())), 0),
                        cache.shape[1] - v.shape[1])
            updated = cache.clone()
            updated.narrow(1, start, v.shape[1]).copy_(v)
            env[id(slot_h)] = updated
            return updated
        if op is OpType.KV_GET:
            return env[id(h.srcs[0])]
        raise GraphError(f"scheduler cannot execute op {op}")

    def _tensor(self, value: Any) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.as_tensor(np.asarray(value), device=self.device)

    def run(self, inputs: Dict[str, Any], weights: Dict[str, Any],
            kv: Optional[Dict[str, Any]] = None,
            ) -> Dict[str, torch.Tensor]:
        """Execute the whole graph; returns name -> value for every node.
        Inputs, weights and KV values may be numpy arrays or tensors."""
        g = self.graph
        env: Dict[int, torch.Tensor] = {}
        for h in g.inputs:
            if h.name not in inputs:
                raise GraphError(f"missing graph input {h.name!r}")
            env[id(h)] = self._tensor(inputs[h.name])
        for h in g.weights:
            if h.name not in weights:
                raise GraphError(f"missing weight {h.name!r}")
            env[id(h)] = self._tensor(weights[h.name])
        for name, slot in g.kv_slots.items():
            if kv and name in kv:
                env[id(slot.header)] = self._tensor(kv[name])
            else:
                env[id(slot.header)] = self._tensor(
                    np.zeros(slot.header.shape, slot.header.dtype))
        for h in g.order:
            env[id(h)] = self._exec_node(h, env)
            # barrier synchronisation after each node (§2.6)
            self.barrier_count += 1
            if self.barrier_hook is not None:
                self.barrier_hook(h)
        return {h.name: env[id(h)] for h in g.order}
