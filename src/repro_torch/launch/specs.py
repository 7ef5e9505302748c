"""Dry-run case builder: step function, meta arguments and spec trees
(``repro.launch.specs``).

``build_case(arch, shape, mesh)`` assembles, allocating nothing (every
argument is a meta tensor; the parameters come from
``Model.init(meta_generator())``, which draws nothing, where the
reference uses ``jax.eval_shape(model.init)``):

    train_4k     -> train_step(params, opt_state, batch)
    prefill_32k  -> prefill_step(params, batch, cache)
    decode_32k   -> serve_step(params, cache, tokens, pos)
    long_500k    -> serve_step with a sequence-sharded or windowed cache

plus the in / out spec trees of the §3.2 partition plan
(``launch.shardings``), leaf for leaf the reference's ``PartitionSpec``s.

The step is the **global** computation on one device: a meta tensor
has no rank, and the port has no partitioner to split a step by its
specs.  So ``launch.step_cost`` counts its FLOPs globally, and the
collectives the plan implies come from the case's plan fields
(``mesh``, ``policy``, ``batch``, ``seq_len``, ``cache_len``,
``seq_axes``, ``moe_hook``), which record what the reference's hooks
would do on that mesh.  ``pos`` is the host int ``seq_len - 1`` (a full context), where
the reference passes a traced scalar.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import SHAPES, get_config
from ..models.common import meta_generator
from ..models.config import ModelConfig
from ..models.transformer import Model, build_model
from ..training.loop import make_train_step
from ..training.optimizer import AdamWConfig, AdamWState, adamw_init
from . import shardings as shd
from .shardings import Policy, Spec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int,
                ) -> Dict[str, torch.Tensor]:
    """A training batch as meta tensors: int32 ``tokens`` / ``labels``
    (batch, seq), and the image or audio stub a cross-attention model
    reads."""
    out = {"tokens": _meta((batch, seq), torch.int32),
           "labels": _meta((batch, seq), torch.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = _meta((batch, cfg.n_audio_frames, cfg.d_model),
                              cfg.dtype)
    if cfg.cross_attn_every:
        out["image_embeds"] = _meta((batch, cfg.n_image_tokens,
                                     cfg.d_model), cfg.dtype)
    return out


def _memory_len(cfg: ModelConfig) -> int:
    if cfg.is_encoder_decoder:
        return cfg.n_audio_frames
    if cfg.cross_attn_every:
        return cfg.n_image_tokens
    return 0


def decode_cache_plan(cfg: ModelConfig, seq_len: int,
                      ) -> Tuple[int, Optional[int], str]:
    """(cache_len, window_override, note) for a decode shape."""
    windows = [w for k, w in zip(cfg.layer_kinds,
                                 cfg.layer_windows(seq_len))
               if k in ("attn", "xattn")]
    has_global = any(w == 0 for w in windows)
    if seq_len > 65_536 and cfg.long_context == "sliding_window":
        w = cfg.long_context_window
        return w, w, "SW"      # the flagged sliding-window variant
    if windows and not has_global:
        return min(max(windows), seq_len), None, "native-window"
    return seq_len, None, "native"


@dataclasses.dataclass
class DryRunCase:
    arch: str
    shape_name: str
    kind: str
    tokens: int                      # tokens processed per step
    cfg: ModelConfig
    step_fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    note: str = ""
    # the plan the step's collectives follow (``launch.step_cost``)
    model: Optional[Model] = None
    mesh: Any = None
    policy: Optional[Policy] = None
    batch: int = 0
    seq_len: int = 0
    cache_len: int = 0               # the ring's slots (decode)
    seq_axes: Tuple[str, ...] = ()   # the decode hook's sequence axes
    moe_hook: bool = False           # the MoE hook would be installed


def _opt_shardings(params_sh: Any, mesh: Any) -> AdamWState:
    return AdamWState(step=shd.replicated(mesh), m=params_sh, v=params_sh)


def build_case(arch: str, shape_name: str, mesh: Any,
               policy: Optional[Policy] = None,
               cfg_override: Optional[ModelConfig] = None) -> DryRunCase:
    """The dry-run case of ``arch`` at ``shape_name`` on ``mesh`` (an
    ``AbstractMesh`` or a ``Mesh``), with the reference's policy
    rewrites: remat for training, ``head_aligned`` off at prefill, FSDP
    off for inference."""
    policy = policy or Policy()
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train" and not cfg.remat:
        # every production-size train step needs per-layer remat
        cfg = dataclasses.replace(cfg, remat=True)
    if shape.kind == "prefill" and policy.head_aligned:
        # prefill is compute-bound: replicated attention costs more
        # than the head-split gathers
        policy = dataclasses.replace(policy, head_aligned=False)
    if shape.kind != "train" and policy.fsdp:
        # FSDP exists to shard optimizer state; for inference it only
        # adds a per-layer weight all-gather every token
        policy = dataclasses.replace(policy, fsdp=False)
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    plan = dict(model=model, mesh=mesh, policy=policy, batch=B, seq_len=S,
                moe_hook=shd.moe_hook_applies(cfg, mesh, batch_size=B))
    params = model.init(meta_generator())
    params_sh = shd.params_shardings(cfg, params, mesh, policy)
    repl = shd.replicated(mesh)
    dp = shd.batch_shardings(cfg, {"x": _meta((B, 1), torch.int32)}, mesh,
                             batch_size=B)["x"].dims[0]
    # the logits' vocab axis splits over "model" only when it divides
    vocab_ax = ("model" if cfg.vocab_size % mesh.shape.get("model", 1) == 0
                else None)
    logits_sh = Spec((dp, None, vocab_ax))

    if shape.kind == "train":
        batch = batch_specs(cfg, B, S)
        batch_sh = shd.batch_shardings(cfg, batch, mesh, batch_size=B)
        step = make_train_step(model, AdamWConfig(),
                               microbatches=policy.microbatches)
        metrics_sh = {k: repl for k in
                      ("ce", "aux", "lr", "grad_norm", "loss")}
        opt_sh = _opt_shardings(params_sh, mesh)
        return DryRunCase(
            arch=arch, shape_name=shape_name, kind="train",
            tokens=B * S, cfg=cfg, step_fn=step,
            args=(params, adamw_init(params), batch),
            in_shardings=(params_sh, opt_sh, batch_sh),
            out_shardings=(params_sh, opt_sh, metrics_sh), **plan)

    if shape.kind == "prefill":
        batch = batch_specs(cfg, B, S)
        batch.pop("labels")
        batch_sh = shd.batch_shardings(cfg, batch, mesh, batch_size=B)
        cache = model.init_cache(B, S, memory_len=_memory_len(cfg),
                                 device="meta")
        cache_sh = shd.cache_shardings(cfg, cache, mesh, policy,
                                       batch_size=B, long_context=False)

        def prefill_step(params_, batch_, cache_):
            return model.prefill(params_, batch_, cache_)

        return DryRunCase(
            arch=arch, shape_name=shape_name, kind="prefill",
            tokens=B * S, cfg=cfg, step_fn=prefill_step,
            args=(params, batch, cache),
            in_shardings=(params_sh, batch_sh, cache_sh),
            out_shardings=(logits_sh, cache_sh), **plan)

    # decode
    cache_len, window_override, note = decode_cache_plan(cfg, S)
    seq_axes: Tuple[str, ...] = ()
    if policy.seq_shard_cache:
        seq_axes = shd.seq_shard_axes(mesh, B, cache_len, cfg.n_kv_heads)[0]
    cache = model.init_cache(B, S, cache_len=cache_len,
                             memory_len=_memory_len(cfg), device="meta")
    cache_sh = shd.cache_shardings(cfg, cache, mesh, policy, batch_size=B,
                                   long_context=shape_name == "long_500k")
    tokens_sh = Spec((dp, None))

    def serve_step(params_, cache_, tokens_, pos_):
        return model.decode_step(params_, cache_, tokens_, pos_,
                                 window_override=window_override)

    plan.update(seq_axes=seq_axes, cache_len=cache_len)
    return DryRunCase(
        arch=arch, shape_name=shape_name, kind="decode",
        tokens=B, cfg=cfg, step_fn=serve_step,
        args=(params, cache, _meta((B, 1), torch.int32), S - 1),
        in_shardings=(params_sh, cache_sh, tokens_sh, repl),
        out_shardings=(logits_sh, cache_sh),
        note=note + ("+seqshard" if seq_axes else ""), **plan)


__all__ = ["DryRunCase", "batch_specs", "build_case", "decode_cache_plan"]
