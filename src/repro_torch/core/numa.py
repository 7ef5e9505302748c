"""NUMA topology + analytical throughput cost model (paper §3.1, §4),
copied from ``repro.core.numa`` (numpy and plain Python).

**Every constant here describes the paper's CPU platform**, a 192-core,
4-node Kunpeng-920 (``KUNPENG_920_4NODE``), serving Qwen3-4B in Q4_0
(``QWEN3_4B``).  None of them is a number of the GPU the port runs on,
and nothing here was measured on one: the model reproduces the paper's
experiments from first principles instead of wall-clock timing.  It
derives per-token time from

  * the bandwidth matrix of Table 1 (local ≈ 102 GB/s per node, remote
    ≈ 22–26 GB/s per node pair),
  * the byte/FLOP traffic of the served model (weights read once per
    decoded token — decode is bandwidth-bound; prefill is
    compute-bound),
  * the placement policy (llama.cpp UMA-distribute vs ArcLight
    NUMA-TP), which determines *which fraction of that traffic crosses
    nodes*, and
  * the synchronisation schedule (Sync A global barriers vs Sync B
    async subgraphs, §3.4).

All constants are exposed so benchmarks can sweep them; defaults are
calibrated to the paper's platform and reproduce Figs 10–13 and the
headline +46 % / +5 tok/s claims (the reference's
``benchmarks/numa_sim.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np



# ----------------------------------------------------------------------
# topology
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NumaTopology:
    """A many-core machine organised as NUMA nodes (Fig 1)."""

    n_nodes: int = 4
    cores_per_node: int = 48
    #: peak local DRAM bandwidth per node, GB/s (6x DDR4 channels)
    local_bw: float = 102.0
    #: cross-node bandwidth per (src,dst) node pair, GB/s
    remote_bw: float = 24.0
    #: achievable per-core streaming bandwidth during Q4_0 GEMV
    #: (dequant + dot; well below pure-STREAM), GB/s
    core_bw: float = 2.6
    #: fraction of STREAM bandwidth a Q4_0 GEMV kernel sustains at node
    #: saturation (dequant overhead, TLB, page-crossing)
    gemv_eff: float = 0.55
    #: per-core compute throughput, GFLOP/s (NEON fp32 FMA @2.6GHz)
    core_gflops: float = 20.8
    #: fixed + per-thread barrier latency, microseconds
    barrier_us: float = 0.8
    barrier_us_per_thread: float = 0.006
    #: cacheline/write-allocate amplification of remote activation reads
    act_amplification: float = 1.8

    @property
    def total_cores(self) -> int:
        return self.n_nodes * self.cores_per_node

    def bandwidth_matrix(self) -> np.ndarray:
        """Reproduce Table 1 (GB/s, rows = core node, cols = memory node).

        The paper's matrix is nearly symmetric with mild ring locality:
        adjacent nodes ~26 GB/s, distant ~22–24 GB/s; diagonal ~101–103.
        """
        m = np.full((self.n_nodes, self.n_nodes), self.remote_bw)
        for i in range(self.n_nodes):
            for j in range(self.n_nodes):
                if i == j:
                    m[i, j] = self.local_bw
                else:
                    hop = min(abs(i - j), self.n_nodes - abs(i - j))
                    m[i, j] = self.remote_bw + (2.0 if hop == 1 else -1.0)
        return m

    def aggregate_remote_bw(self, node: int) -> float:
        """Total bandwidth node ``node``'s cores see to all remote memory."""
        m = self.bandwidth_matrix()
        return float(m[node].sum() - m[node, node])


#: the paper's CPU platform (Table 1), not the port's GPU
KUNPENG_920_4NODE = NumaTopology()


# ----------------------------------------------------------------------
# model traffic
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelTraffic:
    """Per-token byte/FLOP footprint of a decoder-only LLM."""

    name: str
    n_layers: int
    d_model: int
    d_ff: int
    n_heads: int
    n_kv_heads: int
    vocab: int
    bytes_per_weight: float = 0.5625   # Q4_0: 4 bits + scale/32
    act_bytes: int = 4                 # fp32 activations (llama.cpp default)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * f
        return L * (attn + mlp) + 2 * self.vocab * d

    @property
    def weight_bytes(self) -> float:
        return self.n_params * self.bytes_per_weight

    @property
    def decode_flops(self) -> float:
        return 2.0 * self.n_params

    def gemm_input_dims(self) -> List[int]:
        """d_in of every GEMM in one layer (row-partitioned view)."""
        d, hd = self.d_model, self.head_dim
        return [d, d, d,                    # q, k, v
                self.n_heads * hd,          # o
                d, d,                       # gate, up
                self.d_ff]                  # down

    @property
    def ops_per_layer(self) -> int:
        # gemms + norms + rope + attention + residuals + activation
        return len(self.gemm_input_dims()) + 6

    def activation_read_bytes_per_thread(self) -> float:
        """Bytes of GEMM input each thread streams per token.

        Row partitioning means every thread reads the *full* input
        vector of every GEMM (for its slice of output rows)."""
        return float(sum(self.gemm_input_dims()) * self.n_layers
                     * self.act_bytes)


#: Qwen3-4B — the paper's evaluation model (Q4_0).
#: the paper's served model and format (Q4_0 on the CPU platform above)
QWEN3_4B = ModelTraffic(
    name="qwen3-4b", n_layers=36, d_model=2560, d_ff=9728,
    n_heads=32, n_kv_heads=8, vocab=151936)


# ----------------------------------------------------------------------
# placement policies + throughput model
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CostBreakdown:
    tokens_per_s: float
    t_weight_local_s: float
    t_weight_remote_s: float
    t_act_remote_s: float
    t_compute_s: float
    t_sync_s: float
    remote_bytes: float
    policy: str


def _sync_time(topo: NumaTopology, n_threads: int, n_barriers: float,
               ) -> float:
    per_barrier = (topo.barrier_us
                   + topo.barrier_us_per_thread * n_threads) * 1e-6
    return n_barriers * per_barrier


def _node_bw_gbs(n_threads_on_node: float, topo: NumaTopology) -> float:
    """Effective local GB/s n streaming threads achieve on one node.

    Few threads cannot saturate the channels (per-core GEMV cap); at
    saturation the Q4_0 kernel sustains ``gemv_eff`` of STREAM, with a
    small (~8 %) contention loss at full core occupancy."""
    if n_threads_on_node <= 0:
        return 0.0
    cap = min(n_threads_on_node * topo.core_bw,
              topo.local_bw * topo.gemv_eff)
    contention = 1.0 - 0.08 * (n_threads_on_node / topo.cores_per_node)
    return cap * contention


def decode_throughput(
    model: ModelTraffic,
    topo: NumaTopology,
    n_threads: int,
    n_nodes_used: int,
    policy: str,
    *,
    sync_mode: str = "sync_b",
    uma_local_fraction: Optional[float] = None,
    batch: int = 1,
) -> CostBreakdown:
    """Per-token decode cost under a placement policy.

    Policies:
      * ``"llama_uma_isolate"``   — all threads on one node; monolithic
        buffer whose pages the OS spreads (a small fraction lands
        remote even in the isolate case — Fig 10's gap).
      * ``"llama_uma_distribute"``— threads round-robin across nodes;
        weights first-touch local but *activations* are scattered, so
        (M-1)/M of every GEMM input read is remote (Fig 7).
      * ``"arclight_numa_tp"``    — ArcLight: per-node pools + TP;
        weights and activations node-local, remote traffic only at the
        per-block Gather (§3.2/3.3).
      * ``"arclight_single"``     — ArcLight on one node (node-local
        enforced; Fig 10's upper curve).
    """
    M = max(1, n_nodes_used)
    threads_per_node = n_threads / M
    node_bw = _node_bw_gbs(threads_per_node, topo) * 1e9   # B/s per node
    remote_bw = topo.aggregate_remote_bw(0) * 1e9          # B/s per node

    W = model.weight_bytes                 # bytes, read once per token
    A_thread = (model.activation_read_bytes_per_thread()
                * topo.act_amplification)
    n_ops = model.ops_per_layer * model.n_layers

    w_local = w_remote = a_remote = 0.0
    if policy == "llama_uma_isolate":
        # isolate packs threads on one node, but the mmap'd model file's
        # page cache spills a small fraction rho to remote nodes; with a
        # single node's worth of threads those remote streams are
        # latency-bound (~30 % of aggregate remote bandwidth).
        rho = 0.06 if uma_local_fraction is None else 1 - uma_local_fraction
        w_local = W * (1 - rho) / node_bw
        # remote streams are latency-bound at ~30 % of per-core bandwidth,
        # capped by 30 % of the aggregate remote link bandwidth
        remote_eff = min(n_threads * topo.core_bw * 0.3e9, 0.3 * remote_bw)
        w_remote = W * rho / remote_eff
        n_barriers = n_ops
    elif policy == "arclight_single":
        w_local = W / node_bw
        n_barriers = n_ops
    elif policy == "llama_uma_distribute":
        # weights: first-touch local per partition -> parallel across nodes
        w_local = (W / M) / node_bw
        # activations: every thread streams full GEMM inputs, (M-1)/M remote
        a_remote = (A_thread * n_threads * (M - 1) / M) / (M * remote_bw)
        # plus the local 1/M share rides the local channels with weights
        w_local += (A_thread * n_threads / M) / (M * node_bw)
        n_barriers = n_ops
    elif policy == "arclight_numa_tp":
        w_local = (W / M) / node_bw
        # Gather: partial outputs (d_model fp32) from M-1 nodes,
        # twice per layer (attention block + MLP block)
        gather_bytes = (model.d_model * model.act_bytes * (M - 1)
                        * 2 * model.n_layers)
        a_remote = gather_bytes / remote_bw
        n_barriers = (2 * 2 * model.n_layers if sync_mode == "sync_b"
                      else n_ops)
    else:
        raise ValueError(f"unknown policy {policy!r}")

    t_mem = w_local + w_remote + a_remote
    t_compute = (model.decode_flops * batch
                 / (n_threads * topo.core_gflops * 1e9))
    t_sync = _sync_time(topo, n_threads, n_barriers)
    t_token = max(t_mem, t_compute) + t_sync
    return CostBreakdown(
        tokens_per_s=batch / t_token,
        t_weight_local_s=w_local, t_weight_remote_s=w_remote,
        t_act_remote_s=a_remote, t_compute_s=t_compute, t_sync_s=t_sync,
        remote_bytes=w_remote * remote_bw + a_remote * remote_bw,
        policy=policy)


def prefill_throughput(
    model: ModelTraffic,
    topo: NumaTopology,
    n_threads: int,
    n_nodes_used: int,
    policy: str,
    *,
    prompt_len: int = 300,
    sync_mode: str = "sync_b",
) -> CostBreakdown:
    """Prefill is compute-bound (paper A.2): weights are reused across
    the whole prompt, so the memory term is amortised by prompt_len."""
    d = decode_throughput(model, topo, n_threads, n_nodes_used, policy,
                          sync_mode=sync_mode)
    t_mem = (d.t_weight_local_s + d.t_weight_remote_s
             + d.t_act_remote_s * prompt_len / 8)  # acts scale w/ tokens; cache reuse
    t_compute = (model.decode_flops * prompt_len
                 / (n_threads * topo.core_gflops * 1e9 * 0.75))  # GEMM eff.
    t_sync = d.t_sync_s
    t_total = max(t_mem, t_compute) + t_sync
    return CostBreakdown(
        tokens_per_s=prompt_len / t_total,
        t_weight_local_s=d.t_weight_local_s,
        t_weight_remote_s=d.t_weight_remote_s,
        t_act_remote_s=d.t_act_remote_s * prompt_len / 8,
        t_compute_s=t_compute, t_sync_s=t_sync,
        remote_bytes=d.remote_bytes, policy=policy)


# ----------------------------------------------------------------------
# figure-level sweeps (consumed by benchmarks/numa_sim.py)
# ----------------------------------------------------------------------

def fig10_single_node(model: ModelTraffic = QWEN3_4B,
                      topo: NumaTopology = KUNPENG_920_4NODE,
                      threads: Sequence[int] = (6, 12, 24, 36, 48),
                      ) -> Dict[str, List[float]]:
    """Decoding speed, all threads on a single NUMA node (Fig 10)."""
    out = {"threads": list(threads), "llama.cpp": [], "arclight": []}
    for t in threads:
        out["llama.cpp"].append(
            decode_throughput(model, topo, t, 1, "llama_uma_isolate").tokens_per_s)
        out["arclight"].append(
            decode_throughput(model, topo, t, 1, "arclight_single").tokens_per_s)
    return out


def fig11_multi_node(model: ModelTraffic = QWEN3_4B,
                     topo: NumaTopology = KUNPENG_920_4NODE,
                     ) -> Dict[str, Dict[int, List[float]]]:
    """Decoding speed across nodes (Fig 11): N=2 and N=4, threads/node
    swept 6..48."""
    per_node = (6, 12, 24, 36, 48)
    out: Dict[str, Dict[int, List[float]]] = {
        "threads_per_node": {n: list(per_node) for n in (2, 4)},
        "llama.cpp": {}, "arclight_tp": {}, "arclight_tp_sync_a": {}}
    for n in (2, 4):
        out["llama.cpp"][n] = [
            decode_throughput(model, topo, t * n, n,
                              "llama_uma_distribute").tokens_per_s
            for t in per_node]
        out["arclight_tp"][n] = [
            decode_throughput(model, topo, t * n, n, "arclight_numa_tp",
                              sync_mode="sync_b").tokens_per_s
            for t in per_node]
        out["arclight_tp_sync_a"][n] = [
            decode_throughput(model, topo, t * n, n, "arclight_numa_tp",
                              sync_mode="sync_a").tokens_per_s
            for t in per_node]
    return out


def fig12_13_long_prompt(model: ModelTraffic = QWEN3_4B,
                         topo: NumaTopology = KUNPENG_920_4NODE,
                         prompt_len: int = 300,
                         ) -> Dict[str, Dict[str, Dict[int, float]]]:
    """Decode + prefill throughput at prompt length 300 (Figs 12/13)."""
    out: Dict[str, Dict[str, Dict[int, float]]] = {
        "decode": {"llama.cpp": {}, "arclight_tp": {}},
        "prefill": {"llama.cpp": {}, "arclight_tp": {}}}
    for n in (2, 4):
        t = 48 * n
        out["decode"]["llama.cpp"][n] = decode_throughput(
            model, topo, t, n, "llama_uma_distribute", batch=1).tokens_per_s * 0.97
        out["decode"]["arclight_tp"][n] = decode_throughput(
            model, topo, t, n, "arclight_numa_tp", batch=1).tokens_per_s * 0.97
        out["prefill"]["llama.cpp"][n] = prefill_throughput(
            model, topo, t, n, "llama_uma_distribute",
            prompt_len=prompt_len).tokens_per_s
        out["prefill"]["arclight_tp"][n] = prefill_throughput(
            model, topo, t, n, "arclight_numa_tp",
            prompt_len=prompt_len).tokens_per_s
    return out


def headline_gain(model: ModelTraffic = QWEN3_4B,
                  topo: NumaTopology = KUNPENG_920_4NODE) -> float:
    """ArcLight-TP over llama.cpp-distribute at 4 nodes x 48 threads —
    the paper's 'up to 46 %' configuration."""
    a = decode_throughput(model, topo, 192, 4, "arclight_numa_tp").tokens_per_s
    b = decode_throughput(model, topo, 192, 4, "llama_uma_distribute").tokens_per_s
    return a / b - 1.0


def async_gain_tokens_per_s(model: ModelTraffic = QWEN3_4B,
                            topo: NumaTopology = KUNPENG_920_4NODE) -> float:
    """Sync B over Sync A in absolute tok/s (paper: ≈ +5 tok/s)."""
    b = decode_throughput(model, topo, 192, 4, "arclight_numa_tp",
                          sync_mode="sync_b").tokens_per_s
    a = decode_throughput(model, topo, 192, 4, "arclight_numa_tp",
                          sync_mode="sync_a").tokens_per_s
    return b - a
