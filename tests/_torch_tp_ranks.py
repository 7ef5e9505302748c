"""Rank bodies of the port's tensor- and data-parallel CPU tests.

Each function runs on every rank of a gloo group that
``repro_torch.launch.mesh.run_ranks`` starts (fresh ``spawn``
interpreters, one thread each) and returns host values to the test.
This module imports no JAX, so a rank starts fast; the tests compare
what the ranks return with the JAX reference in the parent process.
"""

import numpy as np
import torch

from repro_torch.core import tp
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.weights import params_from_numpy, tree_leaves

# ----------------------------------------------------------------------
# core/tp blocks (tests/test_torch_tp.py)
# ----------------------------------------------------------------------


def tp_blocks(rank, world, mlp_w, attn_w, x, n_heads):
    """``make_tp_block`` MLP and attention under both schedules, their
    collective counts, ``shard_params`` slices, and the meshes' axis
    layout, on this rank."""
    mesh = make_mesh((world,), ("model",))
    xt = torch.from_numpy(x)
    mw = {k: torch.from_numpy(v) for k, v in mlp_w.items()}
    aw = {k: torch.from_numpy(v) for k, v in attn_w.items()}
    out = {"blocks": {}, "counts": {}}
    for mode in ("sync_a", "sync_b"):
        for kind, w, kw in (("mlp", mw, {}),
                            ("attention", aw, {"n_heads": n_heads})):
            blk = tp.make_tp_block(mesh, kind, sync_mode=mode, **kw)
            res = {}
            out["counts"][(kind, mode)] = tp.collective_ops_in(
                lambda: res.setdefault("z", blk(w, xt)))
            out["blocks"][(kind, mode)] = res["z"].numpy()
    out["shards"] = {k: v.numpy()
                     for k, v in tp.shard_params({**mw, **aw}, mesh).items()}
    dp = make_host_mesh(model=1, data=world)
    mp = make_host_mesh(model=world, data=1)
    out["layout"] = {"data": (dict(dp.shape), dp.axis_index("data")),
                     "model": (dict(mp.shape), mp.axis_index("model"))}
    b = torch.full((3,), float(rank + 1), dtype=torch.bfloat16)
    tp.broadcast(b, mesh)
    out["broadcast"] = b.float().tolist()
    return out


# ----------------------------------------------------------------------
# tensor-parallel serving (tests/test_torch_tp_serving.py)
# ----------------------------------------------------------------------

TP_TINY = dict(name="tp-tiny", arch_type="dense", n_layers=3, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=259)


def tp_tiny_model():
    return build_model(ModelConfig(**TP_TINY, dtype=torch.float32))


def waves(seed=11):
    """The reference test's two-wave workload: 26-token prompts behind a
    20-token shared system prompt (block 3 fills and registers, so wave
    2 diverges mid-page: a CoW)."""
    rng = np.random.default_rng(seed)
    system = [int(t) for t in rng.integers(1, 258, 20)]
    return [[system + [int(t) for t in rng.integers(1, 258, 6)]
             for _ in range(2)] for _ in range(2)]


def run_waves(S, model, params, mesh=None, n_nodes=1, **kw):
    """Serve the two waves back to back through one engine; returns the
    engine and the tokens in submission order."""
    eng = S.ContinuousServingEngine(
        model, params, max_len=64, max_running=4, page_size=8,
        prefill_chunk=8, mesh=mesh, n_nodes=n_nodes, **kw)
    toks = []
    for w, wave in enumerate(waves()):
        reqs = [S.Request(uid=9 * w + i, prompt=p,
                          sampling=S.SamplingParams(max_new_tokens=8))
                for i, p in enumerate(wave)]
        toks += [c.tokens for c in eng.generate(reqs)]
    return eng, toks


def spec_prompts():
    """Repeated segments, so prompt lookup drafts."""
    rng = np.random.default_rng(5)
    return [[int(t) for t in np.tile(rng.integers(1, 258, n), 3)]
            for n in (5, 9, 7)]


def run_spec(S, model, params, mesh=None, **kw):
    eng = S.ContinuousServingEngine(
        model, params, max_len=64, max_running=4, page_size=8,
        spec_decode=2, mesh=mesh, **kw)
    reqs = [S.Request(uid=i, prompt=p,
                      sampling=S.SamplingParams(max_new_tokens=8))
            for i, p in enumerate(spec_prompts())]
    return eng, [c.tokens for c in eng.generate(reqs)]


def tp_serving(rank, world, params_np):
    """Everything the TP serving tests read, on one rank of a
    ``world``-way ``"model"`` mesh."""
    import time

    import repro_torch.serving as S
    from repro_torch.quant import QuantPolicy
    from repro_torch.serving.async_engine import TP_HEARTBEAT_S

    mesh = make_mesh((world,), ("model",))
    model = tp_tiny_model()
    params = params_from_numpy(params_np, "cpu")
    out = {}
    eng, out["tokens"] = run_waves(S, model, params, mesh, n_nodes=world,
                                   device="cpu")
    out["stats"] = dict(eng.pool.stats)
    r = eng.runner
    k0 = r.cache["layers"][0]["self"]["k"]
    out["k_shape"] = tuple(k0.shape)
    ptrs = [buf.data_ptr() for layer in r.cache["layers"]
            for buf in layer["self"].values()]
    B = r.max_running
    fed = np.ones((B, 1), np.int32)
    pos = np.zeros((B,), np.int32)
    out["counts"] = {
        "decode": tp.collective_ops_in(r.decode, fed, pos),
        "prefill": tp.collective_ops_in(
            r.prefill_chunk, list(range(1, 9)), slot=0, start=0,
            fresh=True),
        "chunk": tp.collective_ops_in(
            r.prefill_chunk, list(range(9, 17)), slot=0, start=8,
            fresh=False),
        "verify": tp.collective_ops_in(
            r.verify, np.ones((B, 3), np.int32), pos,
            np.full((B,), 3, np.int32)),
    }
    out["in_place"] = ptrs == [buf.data_ptr() for layer in r.cache["layers"]
                               for buf in layer["self"].values()]
    qp = QuantPolicy(weights="q4", kv_dtype="int8")
    _, out["q4_int8"] = run_waves(S, tp_tiny_model(), params, mesh,
                                  n_nodes=world, quant=qp, device="cpu")
    eng, out["spec"] = run_spec(S, tp_tiny_model(), params, mesh,
                                device="cpu")
    out["spec_drafted"] = eng.registry.get("spec.drafted").value()
    eng = S.AsyncEngine(tp_tiny_model(), params, max_len=64, max_running=2,
                        page_size=8, mesh=mesh, n_nodes=world,
                        device="cpu")
    if rank == 0:
        hs = [eng.submit(S.Request(
            uid=0, prompt=p, sampling=S.SamplingParams(max_new_tokens=8)))
            for p in spec_prompts()]
        out["async"] = [eng.result(h, timeout=60).tokens for h in hs]
        steps = eng.core.registry.get("serving.steps")
        s0 = steps.value()
        time.sleep(2.5 * TP_HEARTBEAT_S)    # idle: heartbeats only
        out["async_idle_steps"] = steps.value() - s0
        eng.shutdown()
    else:
        eng.shutdown(timeout=60)
    out["async_steps"] = eng.core.registry.get("serving.steps").value()
    return out


# ----------------------------------------------------------------------
# data-parallel training (tests/test_torch_tp_serving.py)
# ----------------------------------------------------------------------

def uneven_masks(b):
    """``b`` with -100 on a different number of each row's last labels
    (row r keeps ``S >> r`` of its S): the ranks' shares of the loss
    tokens differ, so only token weighting gives the full batch."""
    labels = np.array(b["labels"], copy=True)
    S = labels.shape[1]
    for r in range(labels.shape[0]):
        labels[r, S >> r:] = -100
    return {**b, "labels": labels}


def train_dp(rank, world, steps, batch, seq_len):
    """``steps`` data-parallel train steps of reduced qwen3 from seed 0,
    on the corpus's batches as drawn ("plain") and with
    :func:`uneven_masks` ("masked"); returns for each the losses and the
    final parameters as numpy arrays."""
    return {kind: _train_dp(rank, world, steps, batch, seq_len, kind)
            for kind in ("plain", "masked")}


def _train_dp(rank, world, steps, batch, seq_len, kind):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PackedLMDataset
    from repro_torch.models import reduced_config
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    import dataclasses

    cfg = dataclasses.replace(reduced_config(get_config("qwen3-1.7b")),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    mesh = make_host_mesh(model=1, data=world) if world > 1 else None
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=steps), mesh=mesh)
    ds = PackedLMDataset(seq_len=seq_len, n_docs=200,
                         vocab_size=cfg.vocab_size)
    batches = ds.batches(batch)
    state = adamw_init(params)
    losses = []
    for _ in range(steps):
        b = next(batches)
        params, state, m = step(params, state,
                                uneven_masks(b) if kind == "masked" else b)
        losses.append(float(m["loss"]))
    return losses, [p.numpy().copy() for p in tree_leaves(params)]


# ----------------------------------------------------------------------
# sequence-sharded decode and combine (tests/test_torch_seqshard.py)
# ----------------------------------------------------------------------

def _seq_mesh(world):
    """(1, 2) or (2, 2) ("data", "model"): the ring's sequence splits
    over every axis of size above 1."""
    return make_mesh((1, 2) if world == 2 else (2, world // 2),
                     ("data", "model"))


def seqshard_ranks(rank, world, jobs):
    """Each job of ``jobs`` (name -> dict) on this rank; see
    :func:`_combine_job` and :func:`_decode_job`."""
    mesh = _seq_mesh(world)
    return {name: (_combine_job if job["kind"] == "combine"
                   else _decode_job)(mesh, job)
            for name, job in jobs.items()}


def _combine_job(mesh, job):
    """This rank's blocks of k / v (the sequence split over every axis),
    ``flash_attention(return_partial=True)`` at their global offset, then
    ``combine_partials``; its collectives."""
    from repro_torch.models.attention import combine_partials, flash_attention
    axes = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    q, k, v = (torch.from_numpy(job[n]) for n in ("q", "k", "v"))
    S = k.shape[1]
    size = S // tp.axis_size(mesh, axes)
    idx = mesh.axis_index(axes)
    part = flash_attention(q, k[:, idx * size:(idx + 1) * size],
                           v[:, idx * size:(idx + 1) * size], causal=True,
                           q_offset=S - 1, kv_offset=idx * size,
                           chunk=job["chunk"], return_partial=True)
    res = {}
    counts = tp.collective_ops_in(lambda: res.setdefault(
        "out", combine_partials(part, mesh, axes, q.dtype)))
    return {"out": res["out"].numpy(), "counts": counts}


def _decode_job(mesh, job):
    """Prefill ``job['prompt']`` into a full ring of ``job['cache_len']``
    slots, keep this rank's block of it (``cache_shardings``), install
    ``make_decode_attn_hook`` and take ``job['steps']`` greedy decode
    steps on this rank's rows (all of them, or its data block where the
    batch splits over "data"): their logits and tokens, the collectives
    of the first step, the hook's writes, which rows and which block of
    the sequence the rank holds, and its k blocks after prefill and
    after the steps."""
    from repro_torch.launch import shardings as sh
    cfg = ModelConfig(**job["cfg"], dtype=torch.float32)
    model = build_model(cfg)
    params = params_from_numpy(job["params"], "cpu")
    prompt = torch.from_numpy(job["prompt"])
    B, M = prompt.shape[0], job["cache_len"]
    cache = model.init_cache(B, M, device="cpu")
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    pol = sh.Policy()
    local = tp.shard_tree(cache, sh.cache_shardings(
        cfg, cache, mesh, pol, batch_size=B, long_context=True), mesh)
    hook = sh.make_decode_attn_hook(cfg, mesh, pol, batch_size=B,
                                    cache_len=M)
    model.decode_attn_hook = hook
    rows = torch.arange(B)[:, None]
    if sh.seq_shard_axes(mesh, B, M, cfg.n_kv_heads)[1]:    # batch split
        take = sh.make_activation_constraint(mesh, batch_size=B)
        logits, rows = take(logits), take(rows)

    def k_blocks():
        return [b.clone() for _, b in _k_leaves(local)]

    before = k_blocks()
    pos = prompt.shape[1]
    out = {"logits": [], "tokens": []}
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for step in range(job["steps"]):
        res = {}
        counts = tp.collective_ops_in(lambda: res.setdefault(
            "l", model.decode_step(params, local, tok, pos)[0]))
        if step == 0:
            out["counts"] = counts
        out["logits"].append(res["l"][:, -1].numpy())
        tok = res["l"][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out["tokens"].append(tok[:, 0].tolist())
        pos += 1
    out["writes"] = hook.writes
    out["seq_axes"] = hook.seq_axes
    out["rows"] = rows[:, 0].tolist()
    out["seq_block"] = mesh.axis_index(hook.seq_axes)
    out["k_before"] = [b.numpy() for b in before]
    out["k_after"] = [b.numpy() for b in k_blocks()]
    return out


def _k_leaves(cache):
    from repro_torch.models.weights import tree_leaves_with_path
    return [(p, x) for p, x in tree_leaves_with_path(cache["layers"])
            if p[-1] == "k"]


# ----------------------------------------------------------------------
# the MoE hook (tests/test_torch_moe_hook.py)
# ----------------------------------------------------------------------

def moe_hook_ranks(rank, world, cfg_kw, params_np, x):
    """``make_moe_hook`` in both modes on a (2 data x world/2 model)
    mesh: this rank's rows of ``x`` through its blocks of the MoE
    leaves; returns y (its rows), aux and the collectives, by mode."""
    from repro_torch.launch import shardings as sh
    mesh = make_mesh((2, world // 2), ("data", "model"))
    cfg = ModelConfig(**cfg_kw, dtype=torch.float32)
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    xt = torch.from_numpy(x)
    rows = xt.shape[0] // 2
    x_loc = xt[mesh.axis_index("data") * rows:][:rows]
    out = {}
    for ep in (False, True):
        pol = sh.Policy(expert_parallel=ep)
        local = tp.shard_tree(params, sh.moe_hook_specs(cfg, mesh, pol),
                              mesh)
        hook = sh.make_moe_hook(cfg, mesh, pol, batch_size=xt.shape[0])
        res = {}
        counts = tp.collective_ops_in(lambda: res.setdefault(
            "r", hook(local, x_loc)))
        y, aux = res["r"]
        out[ep] = {"y": y.numpy(), "aux": float(aux), "counts": counts,
                   "w_up": tuple(local["w_up"].shape)}
    return out


# ----------------------------------------------------------------------
# step_cost's collective rules (tests/test_torch_dryrun.py)
# ----------------------------------------------------------------------

def rule_bytes(rank, world, cfg_kw, moe_kw, params_np, batch):
    """The bytes each collective of the port moves on this rank, by
    piece (``core.tp.collective_bytes_in``), for the rules of
    ``launch.step_cost`` to be held against; and the FSDP gather's
    result against the whole layer."""
    from repro_torch.launch import shardings as sh
    from repro_torch.models.attention import AttnPartial, combine_partials
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    tp_mesh = make_mesh((1, world), ("data", "model"))
    dp_mesh = make_mesh((world, 1), ("data", "model"))
    g = torch.Generator().manual_seed(rank)
    out = {}
    B, S, H, D = 2, 3, 4, 8
    merge = sh.make_paged_head_merge(H, world, tp_mesh)
    out["head_merge"] = tp.collective_bytes_in(
        merge, torch.randn(B, S, H // world, D, generator=g))
    T, d, f = 5, 16, 32
    w = {"w_gate": torch.randn(d, f // world, generator=g),
         "w_up": torch.randn(d, f // world, generator=g),
         "w_down": torch.randn(f // world, d, generator=g)}
    out["mlp_tp"] = tp.collective_bytes_in(
        tp.mlp_tp, w, torch.randn(T, d, generator=g), mesh=tp_mesh)
    part = AttnPartial(out=torch.randn(B, 1, H, D, generator=g),
                       m=torch.randn(B, 1, H, generator=g),
                       lsum=torch.rand(B, 1, H, generator=g) + 1)
    out["seq_combine"] = tp.collective_bytes_in(
        combine_partials, part, tp_mesh, ("model",), torch.float32)
    moe_cfg = ModelConfig(**moe_kw, dtype=torch.float32)
    mp = {k: torch.from_numpy(v) for k, v in params_np["moe"].items()}
    x = torch.from_numpy(params_np["moe_x"])
    for ep in (False, True):
        pol = sh.Policy(expert_parallel=ep)
        hook = sh.make_moe_hook(moe_cfg, tp_mesh, pol,
                                batch_size=x.shape[0])
        local = tp.shard_tree(mp, sh.moe_hook_specs(moe_cfg, tp_mesh, pol),
                              tp_mesh)
        out[f"moe_{'ep' if ep else 'tp'}"] = tp.collective_bytes_in(
            hook, local, x)
    # FSDP: the layer gather of a model whose every leaf FSDP may split
    cfg = ModelConfig(**cfg_kw, dtype=torch.float32)
    model = build_model(cfg)
    params = params_from_numpy(params_np["model"], "cpu")
    pol = sh.Policy(fsdp_threshold=0)
    layer = model._layer_params(params["layers"])[0]
    specs = sh.params_shardings(cfg, layer, dp_mesh, pol)
    constrain = sh.make_layer_constraint(cfg, dp_mesh, pol)
    res = {}
    out["fsdp"] = tp.collective_bytes_in(lambda: res.setdefault(
        "g", constrain(tp.shard_tree(layer, specs, dp_mesh))))
    out["fsdp_equal"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(res["g"]),
                                          tree_leaves(layer)))
    step = make_train_step(model, AdamWConfig(), mesh=dp_mesh)
    out["dp_grad"] = tp.collective_bytes_in(
        step, params, adamw_init(params), batch)
    return out
