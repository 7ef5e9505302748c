"""ArcLight memory manager (paper §2.3).

Responsibilities, mirroring the C++ engine:

* pre-allocate a memory **pool** per NUMA node at startup (vs the single
  UMA buffer of llama.cpp, Fig 3) and bind every tensor's data area to
  the pool of the node whose threads consume it;
* a **double-buffering** mechanism for activations (Fig 4): two
  activation buffers alternated on layer parity, so layer *i* writes
  buffer ``i % 2`` while reading buffer ``(i-1) % 2`` — runtime
  activation memory is 2 × the per-layer peak instead of graph-lifetime
  liveness.

On TPU the "pool" is HBM of a mesh shard and binding is a
``NamedSharding``; this module is the *planner* that decides, before any
allocation, which pool each tensor lives in and how big each pool must
be.  The planner is exact enough to reproduce the paper's memory
accounting and is unit/property-tested (allocation never overlaps, peak
is minimal under the parity policy, UMA vs NUMA placement bytes match).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .tensor import OpType, TensorHeader


_ALIGN = 128  # byte alignment of every carve-out (TPU lane/ sublane friendly)


def _align(n: int, a: int = _ALIGN) -> int:
    return (n + a - 1) // a * a


@dataclasses.dataclass
class Allocation:
    pool: str
    offset: int
    nbytes: int


@dataclasses.dataclass
class Pool:
    """A pre-allocated memory pool bound to one NUMA node (or UMA).

    ``shard_id`` is set only for KV page pools planned over a TP mesh
    (``plan_kv_pages(n_shards=)``): the mesh shard holding this pool's
    head-slice of every page resident on ``node_id``.
    """

    name: str
    node_id: Optional[int]  # None = UMA / replicated
    cursor: int = 0
    peak: int = 0
    shard_id: Optional[int] = None
    allocations: Dict[str, Allocation] = dataclasses.field(default_factory=dict)

    def alloc(self, name: str, nbytes: int) -> Allocation:
        a = Allocation(self.name, self.cursor, _align(nbytes))
        self.cursor += a.nbytes
        self.peak = max(self.peak, self.cursor)
        self.allocations[name] = a
        return a

    def reset(self) -> None:
        self.cursor = 0


class MemoryManager:
    """Plans weight + activation placement over per-node pools.

    ``numa=True``  -> one weight pool and one activation double-buffer
    pair per node (ArcLight strategy, Fig 3 bottom).
    ``numa=False`` -> a single monolithic buffer whose pages the OS
    interleaves (llama.cpp UMA strategy, Fig 3 top); modelled as one
    pool with ``node_id=None``.
    """

    def __init__(self, n_nodes: int = 1, *, numa: bool = True,
                 double_buffer: bool = True) -> None:
        if n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")
        self.n_nodes = n_nodes
        self.numa = numa and n_nodes > 1
        self.double_buffer = double_buffer
        self.weight_pools: List[Pool] = []
        self.act_pools: List[List[Pool]] = []  # [node][parity]
        self.kv_pools: List[Pool] = []         # populated by plan_kv_pages
        self._kv_nodes = 1                     # nodes the KV plan stripes
        self._kv_shards = 1                    # TP shards per page
        if self.numa:
            for i in range(n_nodes):
                self.weight_pools.append(Pool(f"weights/node{i}", i))
                self.act_pools.append(
                    [Pool(f"acts/node{i}/buf{p}", i) for p in range(2)])
        else:
            self.weight_pools.append(Pool("weights/uma", None))
            self.act_pools.append(
                [Pool(f"acts/uma/buf{p}", None) for p in range(2)])

    # ------------------------------------------------------------------
    def place_weight(self, h: TensorHeader) -> Allocation:
        """Bind a weight tensor to its node-local pool."""
        if not h.is_weight():
            raise ValueError(f"{h.name} is not a weight")
        pool = self._pool_for(h.node_id, kind="weight")
        a = pool.alloc(h.name, h.nbytes())
        h.node_id = pool.node_id if pool.node_id is not None else h.node_id
        h.buffer = (a.pool, a.offset)
        return a

    def _pool_for(self, node_id: Optional[int], *, kind: str,
                  parity: int = 0) -> Pool:
        idx = 0
        if self.numa:
            idx = 0 if node_id is None else node_id % self.n_nodes
        if kind == "weight":
            return self.weight_pools[idx]
        return self.act_pools[idx][parity % 2]

    # ------------------------------------------------------------------
    def plan_activations(self, layer_tensors: Sequence[Sequence[TensorHeader]],
                         ) -> Dict[str, Allocation]:
        """Double-buffered activation plan (Fig 4).

        ``layer_tensors[i]`` lists the activation headers produced by
        layer ``i``.  Layer parity selects the buffer; each buffer's
        cursor resets when its parity comes round again, which is safe
        because layer ``i+2`` never reads layer ``i``'s outputs in a
        standard layerwise forward pass.  Without double buffering the
        plan degenerates to one linear region (llama.cpp-style graph
        arena), whose peak we also report for comparison.
        """
        plan: Dict[str, Allocation] = {}
        if not self.double_buffer:
            for layer in layer_tensors:
                for h in layer:
                    pool = self._pool_for(h.node_id, kind="act", parity=0)
                    plan[h.name] = pool.alloc(h.name, h.nbytes())
            return plan

        for i, layer in enumerate(layer_tensors):
            parity = i % 2
            # reset every pool of this parity: the previous same-parity
            # layer's activations are dead once the next layer ran.
            for node_pools in self.act_pools:
                node_pools[parity].reset()
            for h in layer:
                if h.op in (OpType.WEIGHT,):
                    raise ValueError(f"weight {h.name} in activation plan")
                pool = self._pool_for(h.node_id, kind="act", parity=parity)
                plan[h.name] = pool.alloc(h.name, h.nbytes())
                h.buffer = (plan[h.name].pool, plan[h.name].offset)
        return plan

    # ------------------------------------------------------------------
    # KV-cache page pools (serving)
    # ------------------------------------------------------------------
    def plan_kv_pages(self, n_pages: int, page_bytes: int, *,
                      n_shards: int = 1) -> List[Allocation]:
        """Carve the serving KV cache into fixed-size pages, one carve-out
        per page, striped round-robin across the node pools.

        The paged KV pool (``repro_torch.serving.kv_pool``) is the runtime
        allocator on top of this plan: a page's *placement* (node, pool
        offset) is decided here at startup, exactly like weights and
        activations, while which *sequence* owns the page changes at
        runtime without moving bytes — ArcLight's pre-allocate-then-bind
        discipline (§2.3) applied to the serving cache.  Returns the
        per-page allocations indexed by page id.

        ``n_shards`` > 1 is the tensor-parallel serving layout: the
        page pool is **head-sharded** over the mesh's ``model`` axis, so
        every page's bytes live 1/S on each of the S shards.  Planning
        then carves one ``page_bytes / n_shards`` region per (node,
        shard) pool for every page — ``kv_page_placement`` reports the
        page's (node, shard byte map) and the per-page return value is
        the page's *node-local shard-0* allocation (offsets are
        identical on every shard of the node, so one allocation
        describes all S carve-outs).  Page *rows* never move between
        nodes and head-slices never move between shards: the block
        table is replicated and all runtime ownership changes stay
        host-side, exactly as in the single-shard plan.
        """
        if self.kv_pools:
            raise ValueError("KV pages already planned")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if page_bytes % n_shards:
            raise ValueError(
                f"page_bytes={page_bytes} does not split over "
                f"{n_shards} shards")
        self._kv_shards = n_shards
        node_ids = list(range(self.n_nodes)) if self.numa else [None]
        self._kv_nodes = len(node_ids)
        self.kv_pools = []
        for i in node_ids:
            tag = f"node{i}" if i is not None else "uma"
            if n_shards == 1:
                self.kv_pools.append(Pool(f"kv/{tag}", i))
            else:
                self.kv_pools.extend(
                    Pool(f"kv/{tag}/shard{s}", i, shard_id=s)
                    for s in range(n_shards))
        allocs = []
        shard_bytes = page_bytes // n_shards
        for pid in range(n_pages):
            node_idx = pid % self._kv_nodes
            first: Optional[Allocation] = None
            for pool in self.kv_pools[node_idx * n_shards:
                                      (node_idx + 1) * n_shards]:
                a = pool.alloc(f"kv_page{pid}", shard_bytes)
                first = first if first is not None else a
            assert first is not None
            allocs.append(first)
        return allocs

    def kv_page_node(self, page_id: int) -> int:
        """NUMA node a planned page is resident on (0 under UMA)."""
        if not self.kv_pools:
            raise ValueError("no KV pages planned")
        node_id = self.kv_pools[
            (page_id % self._kv_nodes) * self._kv_shards].node_id
        return node_id or 0

    def kv_page_placement(self, page_id: int) -> Tuple[int, Tuple[int, ...]]:
        """(node, shards) of a planned page: the NUMA node its rows are
        bound to and the mesh shards its bytes live on — every shard
        under head-sharded TP (each holds the page's local head slice),
        just ``(0,)`` in the single-shard plan."""
        return (self.kv_page_node(page_id), tuple(range(self._kv_shards)))

    @property
    def kv_node_count(self) -> int:
        """Distinct NUMA nodes the KV plan stripes pages across."""
        if not self.kv_pools:
            raise ValueError("no KV pages planned")
        return self._kv_nodes

    @property
    def kv_shard_count(self) -> int:
        """Mesh shards each KV page's bytes are split over (1 = no TP)."""
        if not self.kv_pools:
            raise ValueError("no KV pages planned")
        return self._kv_shards

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def weight_bytes(self) -> Dict[str, int]:
        return {p.name: p.peak for p in self.weight_pools}

    def activation_bytes(self) -> Dict[str, int]:
        return {p.name: p.peak for pools in self.act_pools for p in pools}

    def kv_bytes(self) -> Dict[str, int]:
        return {p.name: p.peak for p in self.kv_pools}

    def total_bytes(self) -> int:
        return (sum(self.weight_bytes().values())
                + sum(self.activation_bytes().values())
                + sum(self.kv_bytes().values()))

    def per_node_bytes(self) -> Dict[int, int]:
        """Bytes resident in each node's local memory."""
        out: Dict[int, int] = {}
        for p in self.weight_pools:
            out[p.node_id or 0] = out.get(p.node_id or 0, 0) + p.peak
        for pools in self.act_pools:
            for p in pools:
                out[p.node_id or 0] = out.get(p.node_id or 0, 0) + p.peak
        for p in self.kv_pools:
            out[p.node_id or 0] = out.get(p.node_id or 0, 0) + p.peak
        return out


def plan_graph_memory(order: Sequence[TensorHeader], n_nodes: int, *,
                      numa: bool, double_buffer: bool,
                      layer_of: Optional[Dict[int, int]] = None,
                      ) -> MemoryManager:
    """Convenience: place a whole ForwardGraph execution list.

    ``layer_of`` maps ``id(header) -> layer index`` for the parity
    policy; when absent, every node is treated as layer 0 (single
    buffer).
    """
    mm = MemoryManager(n_nodes, numa=numa, double_buffer=double_buffer)
    acts_by_layer: Dict[int, List[TensorHeader]] = {}
    for h in order:
        if h.is_weight():
            mm.place_weight(h)
            continue
        layer = (layer_of or {}).get(id(h), 0)
        acts_by_layer.setdefault(layer, []).append(h)
    layers = [acts_by_layer[k] for k in sorted(acts_by_layer)]
    mm.plan_activations(layers)
    return mm
