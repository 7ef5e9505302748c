"""repro_torch.core — the paper's contribution: ArcLight's engine, the
port of ``repro.core``.

Modules mirror the five C++ engine modules (paper Fig 2) plus the
cross-NUMA tensor-parallelism layer of §3:

- ``tensor``  — tensor library (§2.2): headers + bundles
- ``graph``   — forward graph builder + scheduler (§2.5/2.6, A.1); the
  scheduler runs each node with torch on its device
- ``memory``  — memory manager (§2.3): per-node pools, double buffering
- ``threads`` — thread manager (§2.4): groups, Sync A/B schedules
- ``numa``    — NUMA topology, Table-1 bandwidth matrix, cost model (the
  paper's CPU platform)
- ``tp``      — cross-NUMA TP (§3) over ``torch.distributed`` ranks
- ``engine``  — the composed backend engine (§2.1)
"""

from .engine import Engine, EngineConfig, build_tp_mlp_graph, split_mlp_weights
from .graph import ForwardGraph, GraphScheduler
from .memory import MemoryManager, plan_graph_memory
from .numa import (KUNPENG_920_4NODE, QWEN3_4B, ModelTraffic, NumaTopology,
                   decode_throughput, prefill_throughput)
from .tensor import OpType, TensorBundle, TensorHeader, make_header
from .threads import SyncSchedule, ThreadPool
from .tp import PartitionPlan, make_tp_block, mlp_reference, shard_params

__all__ = [
    "Engine", "EngineConfig", "ForwardGraph", "GraphScheduler",
    "MemoryManager", "ModelTraffic", "NumaTopology", "OpType",
    "PartitionPlan", "SyncSchedule", "TensorBundle", "TensorHeader",
    "ThreadPool", "KUNPENG_920_4NODE", "QWEN3_4B",
    "build_tp_mlp_graph", "decode_throughput", "make_header",
    "make_tp_block", "mlp_reference", "plan_graph_memory",
    "prefill_throughput", "shard_params", "split_mlp_weights",
]
