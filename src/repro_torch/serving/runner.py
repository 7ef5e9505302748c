"""Device-execution layer of the serving stack (``ModelRunner``).

Counterpart of ``repro.serving.runner``: a :class:`ModelRunner` owns
everything that touches the device for the paged continuous engine —
the model parameters, the per-layer paged KV cache, prefill / decode
calls, block-table upload and the copy-on-write row copier — and knows
nothing about scheduling, sequences or sampling policy.  The
:class:`~repro_torch.serving.core.EngineCore` turns scheduler decisions
into these calls.

Where the reference donates the cache to a jit call and gets new
buffers back (``donate_argnums``), this runner updates the per-layer
pool tensors **in place** (``index_copy_``): each step writes only the
rows it touches, so a step costs O(touched bytes), never O(pool bytes).
Block tables are copied into one preallocated device tensor.

Prefill chunks are padded to power-of-two buckets as in the reference
(there they bound XLA recompiles; here they keep the prefill maths —
and so the logits — the reference's).

Quantized serving (``quant=``, a ``repro_torch.quant.QuantPolicy``):
Q4_0 weights are written once at load, on the runner's device, and the
model reads them through its ``qmm`` hook; int8 KV pages are allocated
by ``init_cache`` and quantized / dequantized inside each call.

:class:`BucketRunner` is the same seam for the length-bucket engine
(``serving.engine.ServingEngine``): ring-cache prefill and lockstep
decode, one call each, with no cache of its own.

Speculative decoding runs through :meth:`ModelRunner.verify`: one
batched forward over each lane's last token plus its drafts
(``Model.verify_step``).

Each call of :meth:`ModelRunner.prefill_chunk`, :meth:`~ModelRunner.decode`
and :meth:`~ModelRunner.verify` runs in a span (``repro_torch.obs.spans``,
``runner.prefill`` / ``runner.decode`` / ``runner.verify``) that writes
its ``runner.*.dispatch_ms`` histogram.

On a single CUDA rank the decode step is a **CUDA graph**
(:class:`DecodeGraph`): its one shape, ``max_running`` lanes of one
token, is captured once at construction, and each
:meth:`~ModelRunner.decode` call copies ``fed`` and ``pos`` into the
graph's input buffers and replays it, one launch for the thousands of
operations Python would enqueue one by one.  The graph reads the block
tables from the cache's device tensor, which :meth:`set_block_tables`
updates in place, and writes the pool buffers in place, as an eager step
does.  The CPU, tensor-parallel ranks (``mesh=``) and
:meth:`~ModelRunner.verify` run eagerly.  ``runner.decode.calls``
counts the decode calls by ``path`` (``graph`` / ``eager``).

``mesh=`` (a ``repro_torch.launch.mesh.Mesh``) switches on the
**tensor-parallel mode**, the paper's §3 partition over the ranks of a
process group (rank ≅ NUMA node): this rank runs a **local model** with
its share of the query and kv heads (``head_dim`` pinned), holds its
head slice of ``w_q/w_k/w_v`` (Q4_0 codes and scales alike) and of every
page of the pool (its buffers are simply the local model's pool: (rows,
Hkv / S, D)), and one all-reduce per layer
(``launch.shardings.make_paged_head_merge``) gathers the heads' outputs
before the replicated ``w_o``.  Every rank runs every call with the same
inputs; the pool buffers keep their storage across calls, as the
reference's donation keeps each shard's.  ``policy``
(``launch.shardings.Policy``) is validated: only the head-sharded cache
layout exists, and the shard count must divide both head counts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import Model
from ..models.weights import params_to
from ..obs.spans import Span
from ..quant.policy import QuantPolicy, make_qmm, quantize_serving_params


def _pad_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def resolve_device(device: Any) -> torch.device:
    """``device`` as a torch.device, a CUDA device with its index (the
    calling thread's current device where none is given, so that another
    thread, such as the async engine's stepper, can make it current);
    asking for CUDA without a GPU raises (the port never carries on on
    the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DecodeGraph:
    """One decode step captured as a CUDA graph over persistent inputs.

    ``step(fed, pos)`` is the eager step: it takes the (B, 1) and (B,)
    int64 device tensors and returns the logits.  Construction runs it
    :attr:`WARMUP` times on a side stream with every lane idle (``pos``
    -1: idle lanes write the scratch page only and are fully masked, so
    no sequence's pages are touched), which builds the kernels and makes
    the cuBLAS handles before the capture, and then captures it once.
    :meth:`replay` stages ``fed`` and ``pos`` in pinned host buffers,
    copies them into the graph's inputs and replays it on the calling
    thread's current stream.

    A replay runs no Python: the kernel wrappers' ``.launches`` counts
    move at the capture only, and a replayed step's launches are read
    from the device trace, by kernel name.
    """

    #: eager passes before the capture (torch's capture recipe)
    WARMUP = 3

    def __init__(self, step, batch: int, device: torch.device) -> None:
        self.device = device
        with torch.cuda.device(device):
            self.fed = torch.zeros((batch, 1), dtype=torch.int64,
                                   device=device)
            self.pos = torch.full((batch,), -1, dtype=torch.int64,
                                  device=device)
            self._fed_host = torch.zeros((batch, 1), dtype=torch.int64,
                                         pin_memory=True)
            self._pos_host = torch.full((batch,), -1, dtype=torch.int64,
                                        pin_memory=True)
            self._fed_np = self._fed_host.numpy()
            self._pos_np = self._pos_host.numpy()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    step(self.fed, self.pos)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                #: the graph's output, overwritten by each replay
                self.logits = step(self.fed, self.pos)
            #: recorded after each call's copies out of the staging
            #: buffers, which the next call waits for before it rewrites
            #: them
            self._staged = torch.cuda.Event()
            self._staged.record()

    def replay(self, fed: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        with torch.cuda.device(self.device):
            self._staged.synchronize()
            self._fed_np[...] = fed
            self._pos_np[...] = pos
            self.fed.copy_(self._fed_host, non_blocking=True)
            self.pos.copy_(self._pos_host, non_blocking=True)
            self._staged.record()
            self.graph.replay()
        return self.logits


class ModelRunner:
    """``(device state, chunk/batch) -> logits`` over a paged KV cache.
    No scheduling knowledge; see module docstring."""

    def __init__(self, model: Model, params: Any, *, max_running: int,
                 max_len: int, page_size: int, n_pages: int,
                 window_override: Optional[int] = None,
                 mesh: Optional[Any] = None, policy: Optional[Any] = None,
                 quant: Optional[Any] = None,
                 registry: Optional[Any] = None,
                 clock: Optional[Any] = None, device: Any = "cuda") -> None:
        self.device = resolve_device(device)
        self.model = model
        self.params = params_to(params, self.device)
        #: serving quantization policy: Q4_0 weights are rewritten ONCE
        #: here, on the runner's device (the caller's tree is left
        #: dense), and the model reads them through the ``qmm`` hook
        self.quant = quant if quant is not None else QuantPolicy()
        if self.quant.weights == "q4":
            self.params = quantize_serving_params(
                self.params, min_size=self.quant.min_size)
            model.qmm = make_qmm(self.quant.impl)
        self.max_running = max_running
        self.max_len = max_len
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_pages = -(-max_len // page_size)
        self.window_override = window_override
        self.mesh = mesh
        self.tp_axis = "model"
        self.tp_shards = (int(mesh.shape.get(self.tp_axis, 1))
                          if mesh is not None else 1)
        #: the model every call runs: this rank's local model under TP
        self.local_model = model
        if mesh is not None:
            self._init_tp(policy)
        # observability: per-call dispatch time (enqueue-to-return —
        # device completion is owned by whoever synchronises), written
        # by each call's span (obs.spans)
        now = clock.now if clock is not None else time.perf_counter
        graphed = self.device.type == "cuda" and mesh is None
        h_decode = h_prefill = h_verify = None
        self._c_q4_decode = self._c_q4_prefill = self._c_q4_verify = None
        self._c_decode_calls = None
        if registry is not None:
            self._c_decode_calls = registry.counter(
                "runner.decode.calls",
                "decode calls by path: replayed from the captured CUDA "
                "graph or run eagerly").labels(
                    path="graph" if graphed else "eager")
            h_decode = registry.histogram(
                "runner.decode.dispatch_ms",
                "batched decode dispatch wall per call").labels(
                    shards=str(self.tp_shards))
            h_prefill = registry.histogram(
                "runner.prefill.dispatch_ms",
                "prefill-chunk dispatch wall per call").labels(
                    shards=str(self.tp_shards))
            h_verify = registry.histogram(
                "runner.verify.dispatch_ms",
                "speculative verify dispatch wall per call").labels(
                    shards=str(self.tp_shards))
            if self.quant.weights == "q4":
                # every forward under Q4_0 weights routes each projection
                # through the dequantizing matmul: count them per phase
                c = registry.counter(
                    "runner.quant.q4_dispatch",
                    "forward dispatches whose projections ran through "
                    "Q4_0 dequantizing matmuls")
                self._c_q4_decode = c.labels(phase="decode")
                self._c_q4_prefill = c.labels(phase="prefill")
                self._c_q4_verify = c.labels(phase="verify")
        self._span_decode = Span("runner.decode", ms=h_decode, now=now)
        self._span_prefill = Span("runner.prefill", ms=h_prefill, now=now)
        self._span_verify = Span("runner.verify", ms=h_verify, now=now)
        self.cache = self.local_model.init_cache(
            max_running, max_len, page_size=page_size, n_pages=n_pages,
            kv_dtype=self.quant.kv_dtype, device=self.device)
        #: the decode step's CUDA graph (module docstring); None: eager
        self.decode_graph = (DecodeGraph(self._decode_step, max_running,
                                         self.device) if graphed else None)

    # ------------------------------------------------------------------
    # tensor-parallel mode
    # ------------------------------------------------------------------
    def _init_tp(self, policy: Optional[Any]) -> None:
        from ..core.tp import shard_tree
        from ..launch.shardings import (make_paged_head_merge,
                                        serving_tp_param_specs)

        cfg = self.model.cfg
        S, axis = self.tp_shards, self.tp_axis
        if policy is not None and not policy.shard_cache_head_dim:
            raise ValueError(
                "TP serving implements the head-sharded KV layout; "
                "Policy(shard_cache_head_dim=False) has no paged variant")
        if cfg.n_heads % S or cfg.n_kv_heads % S:
            raise ValueError(
                f"arch {cfg.name!r}: {cfg.n_heads} query / "
                f"{cfg.n_kv_heads} kv heads do not shard over the "
                f"{S}-way {axis!r} mesh axis (§3.2 partitions by "
                "attention heads)")
        # head counts divided, head_dim pinned (resolved_head_dim would
        # otherwise re-derive it from d_model)
        local_cfg = dataclasses.replace(
            cfg, n_heads=cfg.n_heads // S, n_kv_heads=cfg.n_kv_heads // S,
            head_dim=cfg.resolved_head_dim)
        self.local_model = Model(local_cfg)
        self.local_model.paged_head_merge = make_paged_head_merge(
            cfg.n_heads, S, self.mesh, axis=axis)
        self.local_model.qmm = self.model.qmm
        self.params = shard_tree(
            self.params, serving_tp_param_specs(self.params, axis=axis),
            self.mesh)

    # ------------------------------------------------------------------
    def set_block_tables(self, tables: np.ndarray) -> None:
        """Upload the host (max_running, max_pages) block-table array
        into the cache's device tensor."""
        self.cache["block_tables"].copy_(torch.from_numpy(
            np.ascontiguousarray(tables, dtype=np.int32)))

    def apply_copy_rows(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Apply a ``KVCachePool.copy_row_plan`` to every per-layer
        buffer, in place: whole-page K/V row copies, int8 codes and their
        scales alike (the gather copies first, so overlapping plans read
        the old rows)."""
        s = torch.from_numpy(np.asarray(src, np.int64)).to(self.device)
        d = torch.from_numpy(np.asarray(dst, np.int64)).to(self.device)
        for layer in self.cache["layers"]:
            for buf in layer["self"].values():
                buf.index_copy_(0, d, buf.index_select(0, s))

    def prefill_chunk(self, tokens: Sequence[int], *, slot: int,
                      start: int, fresh: bool) -> torch.Tensor:
        """Run one prefill chunk (``tokens`` at absolute positions
        ``[start, start + len)``) into batch slot ``slot``; returns the
        chunk's last-token logits (1, 1, V).  ``fresh`` selects the
        one-shot path (nothing resident to attend over)."""
        n = len(tokens)
        padded = _pad_bucket(n)
        toks = np.zeros((1, padded), np.int64)
        toks[0, :n] = tokens
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        with self._span_prefill:
            if fresh:
                logits, _ = self.local_model.prefill_paged(
                    self.params, batch, self.cache, slot, n,
                    page_size=self.page_size,
                    window_override=self.window_override)
            else:
                ctx_pages = min(
                    _pad_bucket(-(-(start + n) // self.page_size), lo=1),
                    self.max_pages)
                logits, _ = self.local_model.prefill_paged(
                    self.params, batch, self.cache, slot, n, start=start,
                    ctx_pages=ctx_pages, page_size=self.page_size,
                    window_override=self.window_override)
        if self._c_q4_prefill is not None:
            self._c_q4_prefill.inc()
        return logits

    def _decode_step(self, fed: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
        return self.local_model.decode_step(
            self.params, self.cache, fed, pos, page_size=self.page_size,
            window_override=self.window_override)[0]

    def decode(self, fed: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One batched decode step: ``fed`` (max_running, 1) tokens,
        ``pos`` (max_running,) absolute fed-token positions (-1 = idle
        slot, masked + scratch-paged).  Returns (max_running, 1, V).

        The logits are valid until the next ``decode`` call: under the
        CUDA graph they are the graph's output, which the next replay
        overwrites in place (prefill chunks, verify steps and table
        uploads in between leave them be).  ``EngineCore`` samples from
        them, which synchronises, before it calls again."""
        with self._span_decode:
            if self.decode_graph is not None:
                logits = self.decode_graph.replay(fed, pos)
            else:
                logits = self._decode_step(
                    torch.from_numpy(np.asarray(fed, np.int64)).to(
                        self.device),
                    torch.from_numpy(np.asarray(pos, np.int64)).to(
                        self.device))
        if self._c_decode_calls is not None:
            self._c_decode_calls.inc()
        if self._c_q4_decode is not None:
            self._c_q4_decode.inc()
        return logits

    def verify(self, fed: np.ndarray, pos: np.ndarray,
               n_fed: np.ndarray) -> torch.Tensor:
        """One batched speculative verify step: ``fed`` (max_running, S)
        = last sampled token + up to S - 1 draft tokens per lane,
        ``pos`` (max_running,) absolute position of column 0 (-1 = idle
        slot), ``n_fed`` (max_running,) real leading columns per lane.
        Returns (max_running, S, V): column j's argmax is what plain
        decode would emit after j accepted drafts (see
        ``Model.verify_step``)."""
        with self._span_verify:
            logits, _ = self.local_model.verify_step(
                self.params, self.cache,
                torch.from_numpy(np.asarray(fed, np.int64)).to(self.device),
                torch.from_numpy(np.asarray(pos, np.int64)).to(self.device),
                torch.from_numpy(np.asarray(n_fed, np.int64)).to(
                    self.device),
                page_size=self.page_size,
                window_override=self.window_override)
        if self._c_q4_verify is not None:
            self._c_q4_verify.inc()
        return logits


class BucketRunner:
    """Device seam for the length-bucket engine: ring-cache prefill and
    lockstep decode over the caller's cache (``Model.prefill`` /
    ``Model.decode_step``), on ``device`` (CUDA unless the caller asks
    for the CPU; CUDA without a GPU raises)."""

    def __init__(self, model: Model, params: Any, *,
                 window_override: Optional[int] = None,
                 device: Any = "cuda") -> None:
        self.device = resolve_device(device)
        self.model = model
        self.params = params_to(params, self.device)
        self.window_override = window_override

    def init_cache(self, batch: int, max_len: int, *,
                   cache_len: Optional[int] = None,
                   memory_len: int = 0) -> Dict[str, Any]:
        # memory_len is there for signature parity with the reference
        # runner: prefill stores the memory whole, so no caller sets it
        return self.model.init_cache(batch, max_len, cache_len=cache_len,
                                     memory_len=memory_len,
                                     device=self.device)

    def prefill(self, batch: Dict[str, Any], cache: Dict[str, Any]):
        return self.model.prefill(self.params, batch, cache,
                                  window_override=self.window_override)

    def decode(self, cache: Dict[str, Any], tokens: torch.Tensor,
               pos: int):
        return self.model.decode_step(self.params, cache, tokens, pos,
                                      window_override=self.window_override)
