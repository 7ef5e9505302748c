"""Synchronous batch driver over the engine core (``EngineCore``).

``ContinuousServingEngine`` is the pre-declared-arrivals front of the
layered serving stack (runner / core / front ends — the reference's
``docs/serving.md`` "Layered architecture"): ``generate(requests,
arrivals=)`` admits each request onto the core's timeline at its
arrival offset, loops ``EngineCore.step`` until everything drains, and
parks on the injected clock when nothing is runnable (no busy-wait —
with a :class:`~repro_torch.serving.core.VirtualClock` idle waits cost
zero wall time).  All engine mechanics — continuous batching, paged KV pool,
prefix caching + retention, chunked prefill, copy-on-write, preemption
— live in the core; this file is only the loop.

This is the port's ``ContinuousServingEngine``: the same driver over
the PyTorch core, ``spec_decode=k`` (speculative verify) included.  It
runs on ``device="cuda"`` unless the caller passes ``device="cpu"``.
For live traffic (submit/stream/cancel while the engine steps) use
:class:`~repro_torch.serving.async_engine.AsyncEngine`, which drives the
same core from a background stepper thread.

Under a tensor-parallel mesh every rank calls ``generate`` with the same
requests; each step's clock reading is rank 0's (``EngineCore.shared``),
so every rank admits the same requests at the same step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ..models.transformer import Model
from .core import Clock, EngineCore
from .engine import Completion, Request


class ContinuousServingEngine:
    def __init__(self, model: Model, params: Any, *, max_len: int = 1024,
                 max_running: int = 8, page_size: int = 16,
                 n_pages: Optional[int] = None, n_nodes: int = 1,
                 numa: bool = True,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 window_override: Optional[int] = None,
                 mesh=None, policy=None, quant=None, spec_decode: int = 0,
                 seed: int = 0, clock: Optional[Clock] = None,
                 registry=None, tracer=None, device: str = "cuda") -> None:
        self.core = EngineCore(
            model, params, max_len=max_len, max_running=max_running,
            page_size=page_size, n_pages=n_pages, n_nodes=n_nodes,
            numa=numa, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, window_override=window_override,
            mesh=mesh, policy=policy, quant=quant,
            spec_decode=spec_decode, seed=seed, clock=clock,
            registry=registry, tracer=tracer, device=device)
        self.last_phase_s: Dict[str, float] = {}

    # engine internals tests/benches reach for, now owned by the core
    model = property(lambda self: self.core.model)
    params = property(lambda self: self.core.params)
    registry = property(lambda self: self.core.registry)
    tracer = property(lambda self: self.core.tracer)
    pool = property(lambda self: self.core.pool)
    scheduler = property(lambda self: self.core.scheduler)
    max_len = property(lambda self: self.core.max_len)
    max_running = property(lambda self: self.core.max_running)
    page_size = property(lambda self: self.core.page_size)
    n_pages = property(lambda self: self.core.n_pages)
    runner = property(lambda self: self.core.runner)

    def generate(self, requests: Sequence[Request], *,
                 arrivals: Optional[Sequence[float]] = None,
                 ) -> List[Completion]:
        """Serve ``requests``; ``arrivals[i]`` (seconds from call start)
        delays request i's admission, modelling live traffic."""
        arrivals = list(arrivals or [0.0] * len(requests))
        if len(arrivals) != len(requests):
            raise ValueError("one arrival per request")
        core = self.core
        for r in requests:
            core.check_request(r)
        pending = sorted(zip(arrivals, range(len(requests))))
        core.reset_run_stats()
        clock0 = core.clock.now()
        done: List[Completion] = []
        while pending or core.has_work():
            now = core.shared(core.clock.now() - clock0)
            while pending and pending[0][0] <= now:
                t_arr, i = pending.pop(0)
                core.submit(requests[i], arrival=t_arr, t0=clock0 + t_arr)
            res = core.step(now)
            done.extend(res.finished)
            if res.idle and pending:
                # nothing runnable: park until the next arrival
                wait = pending[0][0] - (core.clock.now() - clock0)
                core.clock.sleep(wait)
        # raw phase times — a zero-duration phase (prefill-only run,
        # virtual clock) passes through as 0.0; ``throughput_report``
        # now reports 0.0 tok/s for it instead of a clamp-distorted rate
        phase = core.phase_s
        self.last_phase_s = {
            "wall_s": core.clock.now() - clock0,
            "prefill_s": phase["prefill_s"],
            "decode_s": phase["decode_s"]}
        return sorted(done, key=lambda c: c.uid)
