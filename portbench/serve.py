"""Set-up of the system under test: a configuration file read into the
port's ``ModelConfig``, weights drawn from the seed on the device, the KV
pool sized to the card, ``repro_torch.serving.AsyncEngine`` built, and the
cell's shapes warmed up.

A configuration file (``portbench/configs/<name>.json``) holds the model
as it is run: the source's keys (``hidden_size``, ...) with the values
run, ``reduced`` and ``assumed``, the ``port`` fields of the
``ModelConfig`` that runs it (checked here against the source's keys),
the ``reference`` family (``portbench/reference/<family>.py``), the
``engine`` settings and the ``check`` limits.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

CONFIG_DIR = Path(__file__).resolve().parent / "configs"

#: source key -> ModelConfig field that must hold the same value
_SAME = (("hidden_size", "d_model"), ("intermediate_size", "d_ff"),
         ("num_hidden_layers", "n_layers"),
         ("num_attention_heads", "n_heads"),
         ("num_key_value_heads", "n_kv_heads"), ("head_dim", "head_dim"),
         ("vocab_size", "vocab_size"), ("num_local_experts", "n_experts"),
         ("num_experts_per_tok", "experts_per_token"),
         ("rope_theta", "rope_theta"), ("rms_norm_eps", "norm_eps"),
         ("tie_word_embeddings", "tie_embeddings"))
#: leaves drawn at this standard deviation; other leaves of shape
#: (..., d_in, d_out) at 1 / sqrt(d_in)
_EMBED_STD = 0.02
_GAIN_STD = 0.1
#: leaf offsets in the flat weight buffers are multiples of this many
#: elements (512 bytes of bf16)
_ALIGN = 256


def load_config(name: str, directory: Path = CONFIG_DIR) -> Dict:
    with open(directory / f"{name}.json") as f:
        return json.load(f)


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` for a configuration file; raises where
    its ``port`` fields disagree with the source's keys."""
    from repro_torch.models.config import ModelConfig

    port = dict(cfg["port"])
    mc = ModelConfig(name=cfg["name"], dtype=getattr(torch, cfg["torch_dtype"]),
                     **port)
    for key, field in _SAME:
        if key in cfg and getattr(mc, field) != cfg[key]:
            raise ValueError(f"{cfg['name']}: {key} = {cfg[key]} but the "
                             f"port runs {field} = {getattr(mc, field)}")
    return mc


def _leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _set(tree: Any, path: Tuple, value: Any) -> None:
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _std(path: Tuple, shape: Tuple[int, ...]) -> float:
    name = path[-1]
    if name == "embed":
        return _EMBED_STD
    if name in ("g", "q_norm", "k_norm"):
        return _GAIN_STD
    return 1.0 / math.sqrt(shape[-2])


def draw_params(model, seed: int, device: Any) -> Dict:
    """Random weights in the port's parameter layout, drawn on ``device``
    from ``seed``: one flat buffer a dtype, filled by one ``normal_``
    call in the type it is served in, then each leaf (a view into it)
    scaled once: N(0, 1/d_in) projections, N(0, 0.02^2) embeddings,
    N(0, 0.1^2) norm gains (the layout's zero-centred gains, drawn away
    from 0 so the check sees them)."""
    from repro_torch.models.common import meta_generator

    shapes = model.init(meta_generator())
    leaves = _leaves(shapes)
    by_dtype: Dict[torch.dtype, int] = {}
    offsets = []
    for _, t in leaves:
        off = by_dtype.get(t.dtype, 0)
        offsets.append(off)
        by_dtype[t.dtype] = off + -(-t.numel() // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flats = {}
    for dt, n in by_dtype.items():
        flats[dt] = torch.empty(n, dtype=dt, device=device)
        flats[dt].normal_(generator=gen)
    params = shapes
    for (path, t), off in zip(leaves, offsets):
        leaf = flats[t.dtype][off:off + t.numel()].view(t.shape)
        leaf.mul_(_std(path, tuple(t.shape)))
        _set(params, path, leaf)
    return params


def pool_pages(cfg: Dict, mc, device: Any) -> Tuple[int, Dict[str, float]]:
    """KV pages for the card's memory: ``memory_fraction`` of it, less what
    is allocated now (the weights) and ``activation_reserve_gib``, in
    pages, at most what every slot at ``max_len`` can use."""
    eng = cfg["engine"]
    ps = int(eng["page_size"])
    page_bytes = (ps * mc.n_layers * 2 * mc.n_kv_heads
                  * mc.resolved_head_dim * mc.dtype.itemsize)
    full = 1 + int(eng["max_running"]) * -(-int(eng["max_len"]) // ps)
    if torch.device(device).type != "cuda":
        return full, {"page_bytes": page_bytes}
    total = torch.cuda.get_device_properties(device).total_memory
    used = torch.cuda.memory_allocated(device)
    budget = (float(eng["memory_fraction"]) * total - used
              - float(eng["activation_reserve_gib"]) * 2**30)
    n = min(full, int(budget // page_bytes))
    return n, {"page_bytes": page_bytes, "card_bytes": total,
               "weights_bytes": used, "pool_bytes": n * page_bytes,
               "full_pages": full}


def build_engine(cfg: Dict, seed: int, device: Any):
    """(engine, params, ModelConfig, set-up facts) for one run."""
    from repro_torch.models import build_model
    from repro_torch.serving import AsyncEngine

    mc = model_config(cfg)
    model = build_model(mc)
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    if cuda:                    # the context, apart from the draw
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = draw_params(model, seed, device)
    if cuda:
        torch.cuda.synchronize()
    facts = {"cuda_init_s": t1 - t0, "draw_s": time.perf_counter() - t1}
    n_pages, pool = pool_pages(cfg, mc, device)
    facts.update(pool)
    facts["n_pages"] = n_pages
    eng = cfg["engine"]
    engine = AsyncEngine(
        model, params, max_len=int(eng["max_len"]),
        max_running=int(eng["max_running"]), page_size=int(eng["page_size"]),
        n_pages=n_pages, prefill_chunk=int(eng["prefill_chunk"]),
        prefix_cache=bool(eng["prefix_cache"]), seed=seed, device=device)
    return engine, params, mc, facts


def warm_lengths(lo: int, hi: int, chunk: int) -> List[int]:
    """Prompt lengths that reach every prefill shape a prompt of ``lo`` to
    ``hi`` tokens can take: each power-of-two chunk bucket from ``lo``'s
    up (the first chunk) and each resumed chunk's context bucket up to
    ``hi`` (chunks past the first attend over the pages before them)."""
    out = {lo, hi}
    b = 8
    while b < min(hi, chunk):
        if b >= lo:
            out.add(b)
        b *= 2
    n = chunk
    while n < hi:
        n *= 2
        out.add(min(n, hi))
        out.add(min(n + 7, hi))
    return sorted(out)


def warm_up(engine, prompts: List[List[int]], timeout_s: float = 600.0,
            out_len: int = 2) -> None:
    """Serve ``prompts`` (``out_len`` greedy tokens each) through the
    engine and wait for all of them."""
    from repro_torch.serving import Request, SamplingParams

    handles = [engine.submit(Request(uid=0, prompt=list(p),
                                     sampling=SamplingParams(
                                         max_new_tokens=out_len)))
               for p in prompts]
    for h in handles:
        engine.result(h, timeout=timeout_s)
