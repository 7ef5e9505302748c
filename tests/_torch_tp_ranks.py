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
