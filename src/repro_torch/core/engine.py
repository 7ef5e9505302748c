"""The ArcLight inference engine (paper §2.1, Fig 2), the port's
``repro.core.engine``.

Decoupled architecture: a high-level decoding *frontend* (weight
loading, model definition, autoregressive loop — ``repro_torch.serving``)
over an *inference engine backend* made of the five core modules:

    memory manager   -> core.memory.MemoryManager
    thread manager   -> core.threads.ThreadPool
    tensor library   -> core.tensor
    graph builder    -> core.graph.ForwardGraph
    graph scheduler  -> core.graph.GraphScheduler

``Engine`` composes them behind the streamlined API the paper
describes: build a graph once (static), plan memory (per-node pools +
double buffering), configure the thread pool, then execute the graph
repeatedly.  The engine is the faithful, inspectable reproduction of
the C++ system; its nodes run in one process, each with torch on the
engine's device (a NUMA node is a partition of the graph here, not a
rank).  The high-throughput path for the served architectures is the
model zoo (``repro_torch.models``) under the serving stack, whose
tensor-parallel mode partitions by the same §3.2 rule
(``core.tp.PartitionPlan``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .graph import ForwardGraph, GraphScheduler
from .memory import MemoryManager, plan_graph_memory
from .tensor import TensorBundle
from .threads import ThreadPool


@dataclasses.dataclass
class EngineConfig:
    n_nodes: int = 1                 # NUMA nodes / TP degree
    n_threads: int = 8
    numa: bool = True                # per-node pools vs UMA buffer
    double_buffer: bool = True
    sync_mode: str = "sync_b"        # §3.4
    binding: str = "distribute"
    device: str = "cuda"             # torch device the nodes run on


@dataclasses.dataclass
class ExecutionReport:
    node_count: int
    barrier_count: int
    weight_bytes: Dict[str, int]
    activation_bytes: Dict[str, int]
    per_node_bytes: Dict[int, int]
    outputs: Dict[str, torch.Tensor]


class Engine:
    """Backend engine: graph + memory + threads + scheduler."""

    def __init__(self, config: EngineConfig) -> None:
        self.config = config
        self.graph = ForwardGraph(n_nodes=config.n_nodes)
        self.threads = ThreadPool(config.n_threads, n_nodes=config.n_nodes,
                                  binding=config.binding)
        self.memory: Optional[MemoryManager] = None
        self._layer_of: Dict[int, int] = {}
        self._current_layer = 0

    # -- model-definition API (used by the frontend) -------------------
    def begin_layer(self, index: Optional[int] = None) -> None:
        """Advance the activation double-buffer parity (Fig 4)."""
        self._current_layer = (index if index is not None
                               else self._current_layer + 1)

    def track(self, bundle: TensorBundle) -> TensorBundle:
        for h in bundle:
            self._layer_of[id(h)] = self._current_layer
        return bundle

    # -- lifecycle ------------------------------------------------------
    def plan(self) -> MemoryManager:
        """Pre-allocate pools and bind every tensor (§2.3)."""
        for h in self.graph.order:
            self._layer_of.setdefault(id(h), self._current_layer)
        self.memory = plan_graph_memory(
            list(self.graph.weights) + list(self.graph.order),
            self.config.n_nodes, numa=self.config.numa,
            double_buffer=self.config.double_buffer,
            layer_of=self._layer_of)
        return self.memory

    def execute(self, inputs: Dict[str, Any], weights: Dict[str, Any],
                kv: Optional[Dict[str, Any]] = None) -> ExecutionReport:
        if self.memory is None:
            self.plan()
        # reconfigure the pool for the graph's TP degree (Scatter does
        # this dynamically in the C++ engine; the static graph lets us
        # do it once up front).
        if self.config.n_nodes > 1:
            self.threads.split(self.config.n_nodes)
        sched = GraphScheduler(self.graph, device=self.config.device)
        outputs = sched.run(inputs, weights, kv)
        if self.config.n_nodes > 1:
            self.threads.merge()
        assert self.memory is not None
        return ExecutionReport(
            node_count=self.graph.node_count(),
            barrier_count=sched.barrier_count,
            weight_bytes=self.memory.weight_bytes(),
            activation_bytes=self.memory.activation_bytes(),
            per_node_bytes=self.memory.per_node_bytes(),
            outputs=outputs)


# ----------------------------------------------------------------------
# frontend helper: define a TP transformer MLP through the graph builder
# ----------------------------------------------------------------------

def build_tp_mlp_graph(engine: Engine, d_model: int, d_ff: int,
                       n_tokens: int, *, dtype: Any = np.float32,
                       ) -> Tuple[TensorBundle, TensorBundle]:
    """Paper Fig 8b: Scatter -> per-node [silu(A_i X) ; B_i Y_i] -> Gather.

    Returns (input bundle, output bundle).  Weight headers are created
    per node with ``node_id`` set, so the memory manager places each
    partition in its node-local pool.
    """
    g = engine.graph
    n = engine.config.n_nodes
    x = engine.track(g.input((d_model, n_tokens), dtype, name="x"))
    if n == 1:
        a = g.weight((d_ff, d_model), dtype, name="w_gate")
        u = g.weight((d_ff, d_model), dtype, name="w_up")
        b = g.weight((d_model, d_ff), dtype, name="w_down")
        y = engine.track(g.mul(g.silu(g.gemm(a, x)), g.gemm(u, x)))
        z = engine.track(g.gemm(b, y))
        return x, z
    if d_ff % n:
        raise ValueError(f"d_ff={d_ff} not divisible by {n} nodes")
    xs = engine.track(g.scatter(x, n=n))  # replicated views, one per node
    gates, ups, downs = [], [], []
    for i in range(n):
        gates.append(g.weight((d_ff // n, d_model), dtype,
                              name=f"w_gate/node{i}", node_id=i).single)
        ups.append(g.weight((d_ff // n, d_model), dtype,
                            name=f"w_up/node{i}", node_id=i).single)
        downs.append(g.weight((d_model, d_ff // n), dtype,
                              name=f"w_down/node{i}", node_id=i).single)
    a_b, u_b, b_b = (TensorBundle(gates), TensorBundle(ups),
                     TensorBundle(downs))
    y = engine.track(g.mul(g.silu(g.gemm(a_b, xs)), g.gemm(u_b, xs)))
    z_part = engine.track(g.gemm(b_b, y))
    z = engine.track(g.gather(z_part, mode="sum"))
    return x, z


def split_mlp_weights(weights: Dict[str, Any], n: int,
                      ) -> Dict[str, Any]:
    """Partition reference MLP weights (numpy arrays or tensors) the way
    §3.2 prescribes.

    ``w_gate/w_up`` (d_ff, d_model) row-partitioned; ``w_down``
    (d_model, d_ff) column-partitioned."""
    out: Dict[str, np.ndarray] = {}
    for i in range(n):
        f = weights["w_gate"].shape[0] // n
        out[f"w_gate/node{i}"] = weights["w_gate"][i * f:(i + 1) * f]
        out[f"w_up/node{i}"] = weights["w_up"][i * f:(i + 1) * f]
        out[f"w_down/node{i}"] = weights["w_down"][:, i * f:(i + 1) * f]
    return out
