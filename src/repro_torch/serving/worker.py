"""Engine-worker subprocess: ``python -m repro_torch.serving.worker``.

The port's counterpart of ``repro.serving.worker``: one replica of the
multi-replica serving stack, a private model + ``AsyncEngine`` + KV page
pool behind an :class:`~repro_torch.serving.http.HttpFrontend`, owned and
monitored by ``repro_torch.serving.supervisor`` and routed to by
``repro_torch.serving.router`` (``launch/serve.py --http --replicas N``).

Startup handshake: the worker builds its engine on ``--device`` (default
``cuda``; with no GPU it exits non-zero before the handshake, it never
serves on the CPU unasked), loads the CUDA kernels its serving path
launches, binds (``--port 0`` picks a free port), then prints one line
``READY port=<N>`` on stdout — the supervisor blocks on that line before
wiring the replica into the router's ring.  Shutdown is SIGTERM/SIGINT
-> drain (the engine's stepper is joined before the interpreter tears
CUDA down) -> exit 0; anything harder (SIGKILL, the fault drills) is
detected upstream as a broken connection + dead process.

``--arch tiny`` is the benchmark suite's ``bench-tiny`` model; any
registry arch id serves its REDUCED variant in float32, as
``repro_torch.launch.serve`` does.  The weights are drawn from
``--seed`` with a ``torch.Generator`` on the serving device, or loaded
with ``--params PATH`` from an ``.npz`` the weight bridge wrote: that is
how a port worker serves the very weights the reference draws from
``PRNGKey(0)``, so a seeded greedy request answered over the wire can be
held against the reference's in-process engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import threading
from typing import Any, Optional, Tuple


def build_served(arch: str, device: Any, *, seed: int = 0,
                 params_path: Optional[str] = None) -> Tuple[Any, Any]:
    """``(model, params)`` for ``--arch arch`` on ``device``: bench-tiny
    for ``"tiny"``, else the registry arch's reduced float32 variant
    (vocabulary at least the byte tokenizer's 259).  Weights are drawn
    from ``seed``, or read from ``params_path`` and checked leaf by leaf
    against the drawn tree's shapes.  Raises ValueError for an unknown
    arch or weights that do not fit it."""
    import torch

    from ..configs import BENCH_TINY, get_config, list_archs
    from ..models import build_model, reduced_config
    from ..models.weights import load_params_like

    if arch == "tiny":
        cfg = BENCH_TINY
    elif arch not in list_archs():
        raise ValueError(
            f"unknown arch; choose 'tiny' or one of {list_archs()}")
    else:
        cfg = reduced_config(get_config(arch))
        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  vocab_size=max(cfg.vocab_size, 259))
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = model.init(gen)
    if params_path:
        params = load_params_like(params_path, params, device)
    return model, params


def build_tiny(seed: int = 0, device: Any = "cuda") -> Tuple[Any, Any]:
    """The benchmark suite's ``bench-tiny`` model with weights drawn from
    an explicit ``torch.Generator`` seeded with ``seed`` on ``device``,
    so every process derives identical weights (torch cannot draw the
    reference's ``PRNGKey(seed)``)."""
    return build_served("tiny", device, seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (reported via READY)")
    ap.add_argument("--arch", default="tiny",
                    help="'tiny' (bench-tiny model) or a registry arch "
                         "id served reduced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; no GPU "
                         "exits before READY instead of falling back)")
    ap.add_argument("--params", metavar="PATH", default=None,
                    help="load the weights from this .npz (written by "
                         "repro_torch.models.weights.save_params_npz) "
                         "instead of drawing them from --seed")
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--max-running", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--quant", choices=("none", "q4"), default="none",
                    help="weight format")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8"),
                    default="fp32", help="KV page format")
    ap.add_argument("--spec-decode", type=int, default=0,
                    help="self-speculative decoding lookahead k "
                         "(0 disables)")
    ap.add_argument("--token-timeout", type=float, default=120.0)
    args = ap.parse_args(argv)

    from ..data.tokenizer import ByteTokenizer
    from ..quant import QuantPolicy
    from . import faults
    from .async_engine import AsyncEngine
    from .http import HttpFrontend
    from .runner import resolve_device

    device = resolve_device(args.device)    # no GPU: raises before READY
    model, params = build_served(args.arch, device, seed=args.seed,
                                 params_path=args.params)

    # fault-injection harness: workers inherit REPRO_FAULTS from the
    # launching shell / supervisor (no-op unless set)
    faults.load_env()
    quant = None
    if args.quant != "none" or args.kv_dtype != "fp32":
        quant = QuantPolicy(weights=args.quant, kv_dtype=args.kv_dtype)
    engine = AsyncEngine(
        model, params, max_len=args.max_len, max_running=args.max_running,
        page_size=args.page_size, n_pages=args.n_pages,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=not args.no_prefix_cache, quant=quant,
        spec_decode=args.spec_decode, device=device)
    if device.type == "cuda":
        # build (or load the cached build of) the kernels this replica
        # launches now, so a cold replica's first request does not wait
        # on nvcc; it changes no result
        from ..kernels import build
        from ..kernels import decode_attention as da
        from ..kernels import q4_gemm as qg
        build.load(da.KERNEL)
        if args.quant == "q4":
            build.load(qg.KERNEL)
    fe = HttpFrontend(engine, tokenizer=ByteTokenizer(), host=args.host,
                      port=args.port, token_timeout=args.token_timeout)
    fe.start()

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    # the supervisor's handshake line — keep the format stable
    print(f"READY port={fe.port}", flush=True)
    stop.wait()
    fe.close(shutdown_backend=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
