"""The port's optimizer, train loop, checkpoints and training CLIs vs the
JAX reference, and the q4 + int8 divergence gate on a model the port
trained.

Against the reference, on the same numpy inputs: ``cosine_lr``, one
``adamw_update`` over float32 and bfloat16 leaves (clipping and the
decay mask included), 5 ``train`` steps of bench-tiny from the
reference's ``PRNGKey(0)`` weights, and ``quantize_params`` (bit-equal
Q4_0 codes and scales).  Checkpoints cross-load: the port reads a
reference file (float32 and bfloat16 leaves, parameters and AdamW
state), the reference reads a port float32 file, and the two key sets
and manifests are equal.  Then twins of ``tests/test_training_serving.py``
(optimizer, loop, checkpoint) and of ``tests/test_arch_smoke.py::
test_one_train_step`` for every registry arch, the train CLI's printed
lines, the serve CLIs at their default ``--warmup-steps 40`` on the
same weights, and a twin of ``tests/test_quant_serving.py::
TestDivergenceGate``.

Tolerances (float32): the schedule within 1e-6 relative; an AdamW
update of a float32 leaf within 1e-6 relative (only the rounding of the
same float32 operations differs), of a bfloat16 leaf within one bf16
ulp (the float32 results may round to either neighbour); 5 train steps:
losses and gradient norms within TRAIN_RTOL relative, each parameter
leaf within PARAM_RTOL of its own largest |p| (measured 2.7e-5 after 40
steps on reduced Qwen3: Adam divides by sqrt(v), so an element whose
gradient is near zero moves by up to lr in either direction on rounding
alone).
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import PackedLMDataset as JDataset
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.models import reduced_config as jreduced
from repro.quant import q4_0 as jq4
from repro.training import checkpoint as jckpt
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.configs import BENCH_TINY, get_config, list_archs
from repro_torch.data.pipeline import PackedLMDataset
from repro_torch.models import ModelConfig, build_model, reduced_config
from repro_torch.models.weights import (params_from_numpy,
                                        save_params_npz,
                                        tree_leaves_with_path)
from repro_torch.quant import q4_0 as tq4
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import loop as tloop
from repro_torch.training import optimizer as topt

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TRAIN_RTOL = 1e-5
PARAM_RTOL = 1e-3
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread for each test here, then as it was: a train
    step's parallel CPU ops spin against the other xdist workers'
    otherwise (40 steps that take 0.7 s alone took 78 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg, dtype=torch.float32):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = dtype
    return ModelConfig(**fields)


def _key(path):
    return tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)


def jax_leaves(tree):
    return {_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _bits(x):
    """A leaf as comparable numpy: bfloat16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _tiny_jcfg():
    return JModelConfig(name="bench-tiny", arch_type="dense", n_layers=4,
                        d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                        vocab_size=259, dtype=jnp.float32)


# ----------------------------------------------------------------------
# the optimizer against the reference
# ----------------------------------------------------------------------

def test_cosine_lr_matches_the_reference():
    cfg = dict(lr=2e-3, warmup_steps=5, total_steps=40, min_lr_ratio=0.1)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        want = float(jopt.cosine_lr(jopt.AdamWConfig(**cfg),
                                    jnp.asarray(step)))
        got = float(topt.cosine_lr(topt.AdamWConfig(**cfg),
                                   torch.tensor(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("gscale", [0.01, 3.0])
def test_adamw_update_matches_the_reference(gscale):
    """Two steps over float32 and bfloat16 matrices and vectors: decay on
    the matrices only, the gradient clipped (``gscale`` 3) or not."""
    rng = np.random.default_rng(1)
    shapes = {"w32": (8, 6), "g32": (6,), "w16": (8, 6), "g16": (6,)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (gscale * rng.normal(0, 1, s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    jdt = {k: jnp.bfloat16 if k.endswith("16") else jnp.float32
           for k in shapes}
    tdt = {k: torch.bfloat16 if k.endswith("16") else torch.float32
           for k in shapes}
    cfg = dict(lr=0.05, weight_decay=0.1, warmup_steps=1, total_steps=10,
               clip_norm=1.0)
    jp = {k: jnp.asarray(v, jdt[k]) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(tdt[k]) for k, v in params.items()}
    jst, tst = jopt.adamw_init(jp), topt.adamw_init(tp)
    for g in grads:
        jp, jst, jm = jopt.adamw_update(
            jopt.AdamWConfig(**cfg),
            {k: jnp.asarray(v, jdt[k]) for k, v in g.items()}, jst, jp)
        tp, tst, tm = topt.adamw_update(
            topt.AdamWConfig(**cfg),
            {k: torch.from_numpy(v).to(tdt[k]) for k, v in g.items()},
            tst, tp)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tst.step) == int(jst.step) == 2
    for k in shapes:
        want = np.asarray(jp[k], np.float32)
        got = tp[k].float().numpy()
        rtol = BF16_ULP if k.endswith("16") else 1e-6
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7,
                                   err_msg=k)
        assert tp[k].dtype == tdt[k]
        for name in ("m", "v"):
            np.testing.assert_allclose(
                getattr(tst, name)[k].numpy(),
                np.asarray(getattr(jst, name)[k]), rtol=1e-5, atol=1e-9,
                err_msg=f"{name}[{k}]")


def test_five_train_steps_match_the_reference():
    """bench-tiny from the reference's ``PRNGKey(0)`` weights, 5 steps of
    ``train`` on the same packed batches."""
    jcfg = _tiny_jcfg()
    jm = jbuild(jcfg)
    jp0 = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp0)
    ocfg = dict(lr=2e-3, warmup_steps=2, total_steps=5)
    jp, _, jh = jloop.train(
        jm, jp0, JDataset(seq_len=32, n_docs=200,
                          vocab_size=259).batches(4),
        jopt.AdamWConfig(**ocfg), steps=5, log_every=1)
    tm = build_model(port_cfg(jcfg))
    tp, tst, th = tloop.train(
        tm, params_from_numpy(tree, "cpu"),
        PackedLMDataset(seq_len=32, n_docs=200, vocab_size=259).batches(4),
        topt.AdamWConfig(**ocfg), steps=5, log_every=1)
    assert [h["step"] for h in th] == list(range(5))
    for a, b in zip(th, jh):
        for name in ("loss", "grad_norm", "lr", "ce"):
            assert a[name] == pytest.approx(b[name], rel=TRAIN_RTOL), name
    assert th[-1]["loss"] < th[0]["loss"]
    want = jax_leaves(jp)
    for path, t in tree_leaves_with_path(tp):
        assert not t.requires_grad, path
        w = want[path]
        err = np.abs(t.numpy() - w).max() / np.abs(w).max()
        assert err <= PARAM_RTOL, (path, err)
    assert int(tst.step) == 5


def test_microbatches_accumulate_the_full_batch_gradient():
    """``microbatches=2`` gives the loss and the clipped first moment of
    one full batch (f32 accumulation over the two halves)."""
    model = build_model(BENCH_TINY)
    batch = next(PackedLMDataset(seq_len=16, n_docs=50,
                                 vocab_size=259).batches(4))
    out = {}
    for mb in (1, 2):
        params = model.init(torch.Generator().manual_seed(0))
        step = tloop.make_train_step(
            model, topt.AdamWConfig(warmup_steps=1, total_steps=5),
            microbatches=mb)
        _, st, metrics = step(params, topt.adamw_init(params), batch)
        out[mb] = (st, metrics)
    (st1, m1), (st2, m2) = out[1], out[2]
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    for (path, a), (_, b) in zip(tree_leaves_with_path(st1.m),
                                 tree_leaves_with_path(st2.m)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=str(path))


def test_quantize_params_is_bit_equal_to_the_reference():
    """bench-tiny's first layer (2-D projections, quantized), its 259-row
    embedding (not a whole number of blocks: kept) and that embedding's
    first 256 rows (quantized), and the 1-D norms (kept)."""
    full = jax.tree.map(np.asarray,
                        jbuild(_tiny_jcfg()).init(jax.random.PRNGKey(2)))
    tree = {"layer0": jax.tree.map(lambda x: x[0], full["layers"]),
            "embed": full["embed"], "embed256": full["embed"][:256]}
    want = jq4.quantize_params(jax.tree.map(jnp.asarray, tree))
    got = tq4.quantize_params(params_from_numpy(tree, "cpu"))
    wl = jax_leaves(want)
    gl = dict(tree_leaves_with_path(got))
    assert set(wl) == set(gl)
    assert any(p[-1] == "q4_packed" for p in gl)
    for path, g in gl.items():
        assert np.array_equal(_bits(g), wl[path]), path


# ----------------------------------------------------------------------
# checkpoints across the two packages
# ----------------------------------------------------------------------

def test_port_reads_a_reference_checkpoint_of_bf16_and_f32_leaves(tmp_path):
    """A reduced RecurrentGemma in bfloat16 (block layout with a tail) and
    its AdamW state (float32 moments, an int32 step) written by the
    reference: the port reads every leaf bit for bit, and writes the
    same keys and manifest back."""
    jcfg = dataclasses.replace(jreduced(jget_config("recurrentgemma-2b")),
                               n_layers=7)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jst = jopt.adamw_init(jp)
    jst = jst._replace(step=jnp.asarray(3, jnp.int32),
                       m=jax.tree.map(lambda x: x + 0.5, jst.m))
    path = jckpt.save_checkpoint(str(tmp_path / "ref"), 9,
                                 {"params": jp, "opt": jst})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    step, out = tckpt.load_checkpoint(path, {"params": tp,
                                             "opt": topt.adamw_init(tp)})
    assert step == 9 and int(out["opt"].step) == 3
    assert out["params"]["embed"].dtype == torch.bfloat16
    want = jax_leaves(jp)
    for p, t in tree_leaves_with_path(out["params"]):
        assert np.array_equal(_bits(t), _bits(want[p])), p
    wm = jax_leaves(jst.m)
    for p, t in tree_leaves_with_path(out["opt"].m):
        assert np.array_equal(t.numpy(), wm[p]), p
    back = tckpt.save_checkpoint(str(tmp_path / "port"), 9, out)
    with np.load(path) as a, np.load(back) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt::.m::layers::tail::0::rglru::w_x" in a.files
        assert "params::layers::blocks::2::attn::w_q" in a.files
        assert bytes(a["_manifest"]) == bytes(b["_manifest"])
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_reference_reads_a_port_f32_checkpoint(tmp_path):
    jcfg = _tiny_jcfg()
    jp = jbuild(jcfg).init(jax.random.PRNGKey(1))
    model = build_model(port_cfg(jcfg))
    tp = model.init(torch.Generator().manual_seed(1))
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 4,
                                 {"params": tp, "opt": topt.adamw_init(tp)})
    step, out = jckpt.load_checkpoint(path, {"params": jp,
                                             "opt": jopt.adamw_init(jp)})
    assert step == 4
    got = jax_leaves(out["params"])
    for p, t in tree_leaves_with_path(tp):
        assert np.array_equal(got[p], t.numpy()), p


# ----------------------------------------------------------------------
# twins of tests/test_training_serving.py and test_arch_smoke.py
# ----------------------------------------------------------------------

def test_cosine_schedule_shape():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    lrs = [float(topt.cosine_lr(cfg, torch.tensor(s)))
           for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[2] > lrs[3] > lrs[4]
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("gscale", [0.1, 1.0, 7.5, 100.0])
def test_clipping_bounds_update(gscale):
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), gscale)}
    cfg = topt.AdamWConfig(lr=0.1, clip_norm=1.0, warmup_steps=0,
                           total_steps=10, weight_decay=0.0)
    new, _, metrics = topt.adamw_update(cfg, grads, topt.adamw_init(params),
                                        {"w": params["w"].clone()})
    assert float(metrics["grad_norm"]) == pytest.approx(4 * gscale, rel=1e-4)
    delta = (new["w"] - params["w"]).abs().max()
    assert float(delta) <= 0.11


def test_no_decay_on_vectors():
    params = {"w": torch.ones((4, 4)), "g": torch.ones((4,))}
    grads = {"w": torch.zeros((4, 4)), "g": torch.zeros((4,))}
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                           total_steps=10, clip_norm=1e9)
    new, _, _ = topt.adamw_update(cfg, grads, topt.adamw_init(params),
                                  params)
    assert float(new["w"].max()) < 1.0          # decayed
    assert torch.equal(new["g"], torch.ones(4))  # not


def test_loss_decreases():
    model = build_model(dataclasses.replace(BENCH_TINY, n_layers=2,
                                            d_model=64, d_ff=128))
    params = model.init(torch.Generator().manual_seed(0))
    ds = PackedLMDataset(seq_len=32, n_docs=300, vocab_size=259)
    _, _, hist = tloop.train(model, params, ds.batches(8),
                             topt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                              total_steps=40),
                             steps=40, log_every=10)
    assert [h["step"] for h in hist] == [0, 10, 20, 30, 39]
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.9
    ev = tloop.make_eval_step(model)(params, next(ds.batches(8, seed=1)))
    assert set(ev) == {"loss", "ce", "aux"} and np.isfinite(float(ev["loss"]))


def test_checkpoint_roundtrip(tmp_path):
    model = build_model(BENCH_TINY)
    params = model.init(torch.Generator().manual_seed(0))
    opt = topt.adamw_init(params)
    path = str(tmp_path / "ck")
    tckpt.save_checkpoint(path, 7, {"params": params, "opt": opt})
    step, out = tckpt.load_checkpoint(path, {"params": params, "opt": opt})
    assert step == 7
    for (_, a), (_, b) in zip(tree_leaves_with_path(params),
                              tree_leaves_with_path(out["params"])):
        assert torch.equal(a, b)


def _batch_for(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    batch["labels"] = batch["tokens"]
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            0, 1, (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.cross_attn_every:
        batch["image_embeds"] = rng.normal(
            0, 1, (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_one_train_step(arch):
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype=torch.float32, remat=False,
                              capacity_factor=4.0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    before = [t.clone() for _, t in tree_leaves_with_path(params)]
    step = tloop.make_train_step(
        model, topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    new, _, metrics = step(params, topt.adamw_init(params),
                           _batch_for(cfg, 2, 16, 2))
    assert np.isfinite(float(metrics["loss"])), arch
    assert np.isfinite(float(metrics["grad_norm"])), arch
    after = [t for _, t in tree_leaves_with_path(new)]
    assert any(not torch.allclose(a, b) for a, b in zip(before, after)), \
        f"{arch}: train step did not update parameters"


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------

def _run(args, timeout=300):
    # one thread: xdist's busy workers share the cores, and a train step's
    # parallel CPU ops spin against them (a 40 ms step took 7 s)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m"] + args, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_cli_prints_the_reference_lines(tmp_path):
    """Both train CLIs on reduced Qwen3 for 3 steps with a checkpoint: the
    same line shapes and the same ``arch=... params=...M`` count (their
    weights differ: torch cannot draw the reference's ``PRNGKey(0)``),
    and the port's checkpoint loads into the port's model."""
    lines = {}
    for mod, extra in (("repro.launch.train", []),
                       ("repro_torch.launch.train", ["--device", "cpu"])):
        ck = str(tmp_path / mod)
        out = _run([mod, "--arch", "qwen3-1.7b", "--steps", "3",
                    "--seq-len", "32", "--batch", "4", "--ckpt", ck] + extra)
        lines[mod] = out.strip().splitlines()
    for mod, ls in lines.items():
        assert re.match(r"arch=qwen3-1\.7b params=[\d.]+M "
                        r"\(reduced=True\) devices=1", ls[0]), ls[0]
        steps = [ln for ln in ls if ln.startswith("  step ")]
        assert len(steps) == 2, ls                      # steps 0 and 2
        for ln in steps:
            assert re.match(r"  step +\d+ loss [\d.]+ lr [\d.]+e[-+]\d+ "
                            r"gnorm [\d.]+ \([\d.]+s\)$", ln), ln
        assert re.match(r"loss [\d.]+ -> [\d.]+$", ls[-2]), ls
        assert ls[-1] == f"checkpoint: {tmp_path / mod}.npz", ls
    port, ref = lines["repro_torch.launch.train"], lines["repro.launch.train"]
    assert port[0].split(" devices=")[0] == ref[0].split(" devices=")[0]
    model = build_model(dataclasses.replace(
        reduced_config(get_config("qwen3-1.7b")), dtype=torch.float32,
        capacity_factor=4.0))
    params = model.init(torch.Generator().manual_seed(0))
    step, out = tckpt.load_checkpoint(
        str(tmp_path / "repro_torch.launch.train"), {"params": params})
    assert step == 3
    assert not torch.equal(out["params"]["embed"], params["embed"])


def test_train_cli_refuses_devices(capsys):
    """``--devices N`` trains data parallel (tests/test_torch_tp_serving.py);
    a rank count that does not split the batch's rows, or ``--microbatches``
    above 1 beside it, is refused before any rank starts."""
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit) as ei:
        main(["--arch", "qwen3-1.7b", "--device", "cpu", "--devices", "3"])
    assert ei.value.code == 2
    assert "--devices" in capsys.readouterr().err
    # and so is microbatching under data parallelism
    with pytest.raises(SystemExit) as ei:
        main(["--arch", "qwen3-1.7b", "--device", "cpu", "--devices", "2",
              "--microbatches", "2"])
    assert ei.value.code == 2
    assert "--microbatches" in capsys.readouterr().err


#: top-2 logit margin under which a differing greedy token is no fault
#: (the margin rule): after 40 warm-up steps the two packages' logits
#: differ by ~3e-6 on reduced Qwen3 (float32), so 1e-3 is generous
WARMUP_MARGIN_TOL = 1e-3


def test_serve_clis_agree_after_the_default_warm_up(tmp_path):
    """Both serve CLIs at the default ``--warmup-steps 40`` on the
    reference's ``PRNGKey(0)`` weights (through ``--params``) print the
    same completions; where a line differs, the first differing greedy
    token must sit within WARMUP_MARGIN_TOL of a tie in the port's
    warm-trained model."""
    arch = "qwen3-1.7b"
    cfg = jreduced(jget_config(arch))
    cfg = dataclasses.replace(cfg, dtype=jnp.float32, capacity_factor=4.0,
                              vocab_size=max(cfg.vocab_size, 259))
    tree = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(0)))
    npz = str(tmp_path / "w.npz")
    save_params_npz(tree, npz)
    outs = {}
    for mod, extra in (("repro.launch.serve", []),
                       ("repro_torch.launch.serve",
                        ["--device", "cpu", "--params", npz])):
        out = _run([mod, "--arch", arch, "--max-new", "8"] + extra)
        assert "warm-up training (40 steps) ..." in out
        outs[mod] = [ln for ln in out.splitlines() if ln.startswith("[")]
        assert len(outs[mod]) == 4, out
    got, want = outs["repro_torch.launch.serve"], outs["repro.launch.serve"]
    if got == want:
        return
    from repro.serving import Request as JRequest
    from repro.serving import SamplingParams as JSampling
    from repro.serving import ServingEngine as JEngine
    from repro.training.loop import train as jtrain
    from repro_torch.launch.serve import warm_up
    from repro_torch.serving.worker import build_served
    jm = jbuild(cfg)
    ds = JDataset(seq_len=64, n_docs=1000, vocab_size=cfg.vocab_size)
    jp, _, _ = jtrain(jm, jax.tree.map(jnp.asarray, tree), ds.batches(8),
                      jopt.AdamWConfig(lr=2e-3, warmup_steps=5,
                                       total_steps=40), steps=40,
                      log_every=20)
    model, params = build_served(arch, "cpu", params_path=npz,
                                 capacity_factor=4.0)
    params, _ = warm_up(model, params, 40)
    from repro.data.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    for g, w in zip(got, want):
        if g == w:
            continue
        prompt = tok.encode(eval(w.split("] ", 1)[1].split(" -> ")[0]))
        ref = JEngine(jm, jp, max_len=64).generate([JRequest(
            uid=0, prompt=prompt,
            sampling=JSampling(max_new_tokens=8))])[0].tokens
        for d in range(len(ref)):
            logits, _ = model.forward(params, {"tokens": torch.tensor(
                [prompt + ref[:d]])})
            top2 = torch.topk(logits[0, -1].detach(), 2)
            if int(top2.indices[0]) != ref[d]:
                margin = float(top2.values[0] - top2.values[1])
                assert margin < WARMUP_MARGIN_TOL, (g, w, d, margin)
                break


@pytest.mark.slow
def test_q4_int8_teacher_forced_match_on_a_port_trained_model():
    """Twin of the reference's divergence gate: the port's bench-tiny
    model warm-trained 80 steps by the port's ``train``; its float32
    greedy continuations replayed teacher-forced through the q4 + int8
    engine must agree on >= QUANT_MATCH_BOUND of positions."""
    from repro_torch.quant import QuantPolicy
    from repro_torch.serving import (ContinuousServingEngine, Request,
                                     SamplingParams)
    QUANT_MATCH_BOUND = 0.80    # documented bound, docs/quantization.md
    model = build_model(BENCH_TINY)
    params0 = model.init(torch.Generator().manual_seed(0))
    ds = PackedLMDataset(seq_len=64, n_docs=500, vocab_size=259)
    params, _, hist = tloop.train(model, params0, ds.batches(8),
                                  topt.AdamWConfig(lr=2e-3, warmup_steps=5,
                                                   total_steps=80),
                                  steps=80, log_every=1000)
    assert hist[-1]["loss"] < 3.0
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, 258, 4 + 4 * (i % 3))))
               for i in range(4)]
    gen = SamplingParams(temperature=0.0, max_new_tokens=12)
    one = SamplingParams(temperature=0.0, max_new_tokens=1)

    def engine(quant):
        return ContinuousServingEngine(model, params, max_len=64,
                                       max_running=8, page_size=8,
                                       quant=quant, device="cpu")

    ref = {c.uid: c.tokens for c in engine(None).generate(
        [Request(uid=i, prompt=p, sampling=gen)
         for i, p in enumerate(prompts)])}
    replay, want = [], []
    for i, p in enumerate(prompts):
        for j in range(len(ref[i])):
            replay.append(Request(uid=len(replay), prompt=p + ref[i][:j],
                                  sampling=one))
            want.append(ref[i][j])
    qeng = engine(QuantPolicy(weights="q4", kv_dtype="int8", impl="ref"))
    got = {c.uid: c.tokens for c in qeng.generate(replay)}
    match = sum(int(got[u][0] == want[u]) for u in range(len(want)))
    rate = match / len(want)
    assert rate >= QUANT_MATCH_BOUND, (
        f"teacher-forced greedy match {rate:.3f} under the documented "
        f"bound {QUANT_MATCH_BOUND}")
