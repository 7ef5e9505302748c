"""Host-side pieces of the ArcLight engine core that the serving stack
needs: tensor headers (``tensor``) and the per-node memory planner
(``memory``), copied from ``repro.core`` (both are device-free)."""

from .memory import MemoryManager, plan_graph_memory
from .tensor import OpType, TensorBundle, TensorHeader, make_header

__all__ = ["MemoryManager", "OpType", "TensorBundle", "TensorHeader",
           "make_header", "plan_graph_memory"]
