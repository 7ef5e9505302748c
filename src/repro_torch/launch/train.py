"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The port's counterpart of ``repro.launch.train``: trains a REDUCED
variant of the architecture (float32, MoE capacity factor 4.0, as the
reference trains it) end to end with the production pipeline — the
packed synthetic corpus, the model, AdamW, microbatching and
checkpointing — and prints the reference's lines (``arch=... params=...``,
``step N loss ... lr ... gnorm ...``, ``loss a -> b``, ``checkpoint:
...``).  ``--full-config`` trains the architecture as configured
(bfloat16, full width and depth).  The weights are drawn from a
``torch.Generator`` seeded with 0 on the device.

It runs on the GPU (``--device cuda``, the default: the RG-LRU scan and
its gradient run the port's hand-written kernel there) and raises when
no GPU is present; ``--device cpu`` runs it on the CPU.  The reference's
``--devices N`` (a host data-parallel mesh) is not ported and is
refused, as is tensor parallelism in the serve CLI.

Examples:
    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 60
    python -m repro_torch.launch.train --arch mamba2-370m --steps 40 \\
        --seq-len 64 --batch 8
    python -m repro_torch.launch.train --arch qwen3-1.7b --full-config \\
        --steps 5 --batch 4 --seq-len 512
"""

import argparse
import dataclasses
import sys


def stub_extras(cfg):
    """``extra_fn(step, batch_size)`` for ``PackedLMDataset.batches``: the
    seed-``step`` audio frames of an encoder-decoder model and image
    embeddings of a cross-attention model (the reference's numpy stubs),
    nothing for the others."""
    from ..data.pipeline import stub_frames, stub_image_embeds

    def extra_fn(step, bs):
        extra = {}
        if cfg.is_encoder_decoder:
            extra["frames"] = stub_frames(bs, cfg.n_audio_frames,
                                          cfg.d_model, seed=step)
        if cfg.cross_attn_every:
            extra["image_embeds"] = stub_image_embeds(
                bs, cfg.n_image_tokens, cfg.d_model, seed=step)
        return extra

    return extra_fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the production config (bf16, full size)")
    ap.add_argument("--devices", type=int, default=0,
                    help="the reference's host data-parallel mesh (not "
                         "ported: refused)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; no GPU "
                         "raises instead of falling back to the CPU)")
    args = ap.parse_args(argv)
    if args.devices:
        ap.error("--devices: data-parallel training is not ported yet "
                 "(one device; see ROADMAP)")
    if args.microbatches < 1 or args.batch % args.microbatches:
        ap.error("--microbatches must divide --batch")

    import time

    import torch

    from ..configs import get_config, list_archs
    from ..data.pipeline import PackedLMDataset
    from ..models import build_model, reduced_config
    from ..serving.runner import resolve_device
    from ..training.checkpoint import save_checkpoint
    from ..training.loop import make_train_step
    from ..training.optimizer import AdamWConfig, adamw_init

    if args.arch not in list_archs():
        ap.error(f"unknown arch; choose from {list_archs()}")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced_config(cfg)
        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  capacity_factor=4.0)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"(reduced={not args.full_config}) devices=1 ({device})")

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen)
    ds = PackedLMDataset(seq_len=args.seq_len, n_docs=2000,
                         vocab_size=cfg.vocab_size)
    batches = ds.batches(args.batch, extra_fn=stub_extras(cfg))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg,
                              microbatches=args.microbatches)
    opt_state = adamw_init(params)
    t0 = time.time()
    first = last = None
    for step in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             next(batches))
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        last = loss
        if step % 10 == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({time.time() - t0:.1f}s)")
    print(f"loss {first:.3f} -> {last:.3f}")
    if args.ckpt:
        print("checkpoint:", save_checkpoint(args.ckpt, args.steps,
                                             {"params": params}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
