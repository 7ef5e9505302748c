"""ArcLight thread manager (paper §2.4) — multi-view thread organisation.

The C++ engine creates one pool of worker threads before inference and
introduces the *logical* abstraction of **thread groups** inside it: the
pool can be dynamically reconfigured into ``n`` groups that execute
``n`` independent tensor operations in parallel (Fig 5), with a
**local barrier** confined to each group and a **global barrier** across
the whole pool (Fig 6).

Copied from ``repro.core.threads`` (numpy and plain Python).  In the
port's tensor-parallel serving a "group" is the ranks of a mesh axis
(``repro_torch.launch.mesh``): every rank runs its own subgraph — the
multi-view organisation — and an all-reduce over an axis is a barrier
over that axis's group.  This module provides:

* ``ThreadPool`` / ``ThreadGroup`` — the logical organisation with the
  paper's reconfiguration interface (``split``/``merge``), used by the
  engine and the NUMA cost model;
* ``SyncSchedule`` — the Sync A (global barrier after every operator)
  vs Sync B (local barriers; global barriers only at Scatter/Gather)
  execution schedules of §3.4, with an analytic idle-time model that
  reproduces Fig 9's behaviour and the paper's ≈5 tok/s async gain.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ThreadError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class ThreadGroup:
    """A logical view over a contiguous span of pool threads."""

    group_id: int
    threads: Tuple[int, ...]
    node_id: Optional[int] = None  # NUMA node the group is bound to

    def __len__(self) -> int:
        return len(self.threads)


class ThreadPool:
    """Worker pool with dynamically reconfigurable logical groups."""

    def __init__(self, n_threads: int, *, n_nodes: int = 1,
                 binding: str = "distribute") -> None:
        """``binding``: 'distribute' spreads threads round-robin across
        NUMA nodes (llama.cpp --numa distribute); 'isolate' packs them
        into the fewest nodes (llama.cpp --numa isolate)."""
        if n_threads < 1:
            raise ThreadError("need at least one thread")
        self.n_threads = n_threads
        self.n_nodes = n_nodes
        self.binding = binding
        #: thread -> NUMA node affinity
        if binding == "distribute":
            self.affinity = [t % n_nodes for t in range(n_threads)]
        elif binding == "isolate":
            per = -(-n_threads // n_nodes)  # ceil; pack greedily
            self.affinity = [min(t // per, n_nodes - 1) for t in range(n_threads)]
        else:
            raise ThreadError(f"unknown binding {binding!r}")
        self.groups: List[ThreadGroup] = []
        self.merge()

    # -- explicit reconfiguration interface (paper §2.4) ---------------
    def split(self, n_groups: int) -> List[ThreadGroup]:
        """Reconfigure the pool into ``n_groups`` groups.

        Threads are grouped by NUMA affinity so that each group is
        node-local (the Scatter operator's reconfiguration): group *i*
        gets the threads bound to node ``i % n_nodes``.
        """
        if n_groups < 1 or n_groups > self.n_threads:
            raise ThreadError(f"cannot split {self.n_threads} threads into "
                              f"{n_groups} groups")
        by_node: Dict[int, List[int]] = {}
        for t, node in enumerate(self.affinity):
            by_node.setdefault(node, []).append(t)
        groups: List[ThreadGroup] = []
        if n_groups == len(by_node):
            for gid, node in enumerate(sorted(by_node)):
                groups.append(ThreadGroup(gid, tuple(by_node[node]), node))
        else:
            # fall back to contiguous equal spans
            spans = np.array_split(np.arange(self.n_threads), n_groups)
            for gid, span in enumerate(spans):
                nodes = {self.affinity[t] for t in span}
                node = nodes.pop() if len(nodes) == 1 else None
                groups.append(ThreadGroup(gid, tuple(int(t) for t in span), node))
        self.groups = groups
        return groups

    def merge(self) -> ThreadGroup:
        """Restore the single-group view (the Gather operator's merge)."""
        g = ThreadGroup(0, tuple(range(self.n_threads)),
                        None if self.n_nodes > 1 else 0)
        self.groups = [g]
        return g

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_of(self, thread: int) -> ThreadGroup:
        for g in self.groups:
            if thread in g.threads:
                return g
        raise ThreadError(f"thread {thread} not in any group")


# ----------------------------------------------------------------------
# Sync A / Sync B schedules (§3.4, Fig 9)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class SyncReport:
    mode: str
    makespan: float          # total time of the TP span
    idle_time: float         # summed thread-group idle time at barriers
    global_barriers: int
    local_barriers: int


class SyncSchedule:
    """Analytic model of thread-group synchronisation during TP.

    Given per-group per-op durations ``durations[g][k]`` (group ``g``'s
    time on the ``k``-th operator of the TP span):

    * **Sync A** (global): every group waits for the slowest group after
      *each* operator — makespan = Σ_k max_g d[g][k].
    * **Sync B** (async subgraphs): groups run their whole subgraph
      independently; one global barrier at the end —
      makespan = max_g Σ_k d[g][k].

    Sync B's makespan is never larger (max of sums ≤ sum of maxes) and
    the gap is the idle time ArcLight recovers (Fig 9).
    """

    @staticmethod
    def sync_a(durations: Sequence[Sequence[float]],
               barrier_cost: float = 0.0) -> SyncReport:
        d = np.asarray(durations, dtype=float)
        if d.ndim != 2:
            raise ThreadError("durations must be [group][op]")
        per_op_max = d.max(axis=0)
        makespan = float(per_op_max.sum() + barrier_cost * d.shape[1])
        idle = float((per_op_max[None, :] - d).sum())
        return SyncReport("sync_a", makespan, idle,
                          global_barriers=d.shape[1], local_barriers=0)

    @staticmethod
    def sync_b(durations: Sequence[Sequence[float]],
               barrier_cost: float = 0.0) -> SyncReport:
        d = np.asarray(durations, dtype=float)
        if d.ndim != 2:
            raise ThreadError("durations must be [group][op]")
        per_group = d.sum(axis=1)
        # one global barrier at the start (Scatter) and one at the end
        # (Gather); local barriers after each op inside a group are
        # intra-group and do not stall other groups.
        makespan = float(per_group.max() + 2 * barrier_cost)
        idle = float((per_group.max() - per_group).sum())
        return SyncReport("sync_b", makespan, idle, global_barriers=2,
                          local_barriers=int(d.shape[0] * d.shape[1]))

    @staticmethod
    def speedup(durations: Sequence[Sequence[float]],
                barrier_cost: float = 0.0) -> float:
        a = SyncSchedule.sync_a(durations, barrier_cost).makespan
        b = SyncSchedule.sync_b(durations, barrier_cost).makespan
        return a / b
