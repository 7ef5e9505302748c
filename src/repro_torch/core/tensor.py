"""ArcLight tensor library (paper §2.2): the host-side headers.

An ArcLight tensor has two distinct components: a *header* holding
metadata (name, shape, dtype, op type, auxiliary parameters, source
pointers) and a *data* area.  In the C++ original the data area is a
contiguous block of virtual memory carved out of a per-NUMA-node pool;
here the data area is a device array (materialised lazily by the graph
interpreter) while the header remains an explicit, inspectable Python
object so the graph builder / scheduler / memory planner can reason
about the computation without touching device state.

The paper's appendix A.1 extends the single ``tensor*`` pointer type to
a ``tensor_ptrs`` bundle so that module interfaces are reused unchanged
when tensor parallelism splits the graph into subgraphs.  That is
``TensorBundle`` below: it holds one header per TP subgraph and supports
"mutual assignment with a single tensor pointer" (a bundle of size one
is interchangeable with a bare header).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class OpType(enum.Enum):
    """Graph node operation types (the paper's operator library, §2.7)."""

    INPUT = "input"            # graph input (activation entering the graph)
    WEIGHT = "weight"          # parameter tensor (lives in the weight pool)
    VIEW = "view"              # zero-copy view (Scatter creates these)
    COPY = "copy"
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    GEMM = "gemm"
    ADD = "add"
    MUL = "mul"
    SILU = "silu"
    GELU = "gelu"
    SOFTMAX = "softmax"
    RMSNORM = "rmsnorm"
    ROPE = "rope"
    ATTENTION = "attention"    # fused (flash-style) attention
    SCATTER = "scatter"        # enter TP mode: split pool into groups, make views
    GATHER = "gather"          # leave TP mode: sum partials, merge pool
    KV_SET = "kv_set"          # KV cache injection
    KV_GET = "kv_get"          # KV cache retrieval
    EMBED = "embed"


#: op types whose output may alias their input (no new allocation).
ALIASING_OPS = frozenset({OpType.VIEW, OpType.RESHAPE, OpType.KV_GET})


_uid = itertools.count()


def _fresh_name(prefix: str) -> str:
    return f"{prefix}_{next(_uid)}"


@dataclasses.dataclass
class TensorHeader:
    """Metadata header of an ArcLight tensor (paper §2.2).

    ``srcs`` are the source-tensor pointers used for computation-graph
    construction; ``params`` are the auxiliary operation parameters
    (e.g. transpose permutation, attention scale).  ``node_id`` is the
    NUMA node (mesh shard, after adaptation) whose local pool owns the
    data area; ``None`` means replicated / node-agnostic.
    """

    name: str
    shape: Tuple[int, ...]
    dtype: Any
    op: OpType = OpType.INPUT
    srcs: Tuple["TensorHeader", ...] = ()
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    node_id: Optional[int] = None
    #: index of the successor node in the static execution list (A.1);
    #: filled in by the graph builder when the node is appended.
    next_index: Optional[int] = None
    #: buffer assigned by the memory manager (pool name, offset).
    buffer: Optional[Tuple[str, int]] = None

    # -- high-level interfaces the paper lists ("get/set names and
    # shapes, or calculate the total byte size required") -------------

    def nbytes(self) -> int:
        return self.numel() * np.dtype(self.dtype).itemsize

    def numel(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    def set_name(self, name: str) -> "TensorHeader":
        self.name = name
        return self

    def with_shape(self, shape: Sequence[int]) -> "TensorHeader":
        self.shape = tuple(int(s) for s in shape)
        return self

    def is_weight(self) -> bool:
        return self.op is OpType.WEIGHT

    def __hash__(self) -> int:  # headers are identity-hashed graph nodes
        return id(self)

    def __eq__(self, other: object) -> bool:
        return self is other

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"TensorHeader({self.name!r}, shape={self.shape}, "
            f"op={self.op.value}, node={self.node_id})"
        )


class TensorBundle:
    """``tensor_ptrs``: a set of tensor pointers (paper A.1).

    Supports "mutual assignment with a single tensor pointer": a bundle
    constructed from one header behaves like that header, and every
    module interface in the graph builder accepts either.  When TP is
    enabled a bundle holds one header per subgraph (per NUMA node /
    model shard).
    """

    __slots__ = ("headers",)

    def __init__(self, headers: Sequence[TensorHeader] | TensorHeader):
        if isinstance(headers, TensorHeader):
            headers = [headers]
        if not headers:
            raise ValueError("empty tensor bundle")
        self.headers: List[TensorHeader] = list(headers)

    # -- single-pointer interchangeability ----------------------------
    @property
    def single(self) -> TensorHeader:
        if len(self.headers) != 1:
            raise ValueError(
                f"bundle of size {len(self.headers)} used where a single "
                "tensor is required (missing Gather?)"
            )
        return self.headers[0]

    def __len__(self) -> int:
        return len(self.headers)

    def __iter__(self) -> Iterator[TensorHeader]:
        return iter(self.headers)

    def __getitem__(self, i: int) -> TensorHeader:
        return self.headers[i]

    @property
    def is_parallel(self) -> bool:
        return len(self.headers) > 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.single.shape

    def nbytes(self) -> int:
        return sum(h.nbytes() for h in self.headers)

    def __repr__(self) -> str:  # pragma: no cover
        return f"TensorBundle({[h.name for h in self.headers]})"


def as_bundle(x: TensorBundle | TensorHeader) -> TensorBundle:
    return x if isinstance(x, TensorBundle) else TensorBundle(x)


def make_header(
    shape: Sequence[int],
    dtype: Any = np.float32,
    *,
    name: Optional[str] = None,
    op: OpType = OpType.INPUT,
    srcs: Sequence[TensorHeader] = (),
    node_id: Optional[int] = None,
    **params: Any,
) -> TensorHeader:
    return TensorHeader(
        name=name or _fresh_name(op.value),
        shape=tuple(int(s) for s in shape),
        dtype=np.dtype(dtype),
        op=op,
        srcs=tuple(srcs),
        params=dict(params),
        node_id=node_id,
    )
