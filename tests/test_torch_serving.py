"""The port's serving stack vs the JAX reference.

* The host modules the port copied (KV pool, scheduler, memory planner)
  pass the reference's own unit cases, run against both packages.
* ``repro_torch.serving.ContinuousServingEngine(device="cpu")`` emits
  the same greedy tokens as ``repro.serving.ContinuousServingEngine`` on
  shared weights (bridged from the reference ``Model.init``), under
  mixed prompts, preemption, a shared prefix with copy-on-write and
  chunked prefill.  Greedy tokens are compared exactly: both engines
  compute the same float32 logits up to summation order, and these
  workloads have no near-ties.
* ``repro_torch`` imports with ``jax`` blocked and loads no ``repro``
  module; its serve CLI runs on the CPU when asked.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro_torch.models import ModelConfig
from repro_torch.models import build_model as tbuild
from repro_torch.models.weights import params_from_numpy

PKGS = ["repro", "repro_torch"]
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.serving"),
            importlib.import_module(f"{pkg}.core.memory"))


def _pool(S, n_pages=17, page_size=4, n_nodes=1, prefix_cache=True):
    return S.KVCachePool(S.KVPoolConfig(
        n_pages=n_pages, page_size=page_size, n_layers=2, n_kv_heads=2,
        head_dim=8, dtype_bytes=4, n_nodes=n_nodes),
        prefix_cache=prefix_cache)


# ----------------------------------------------------------------------
# host modules: the reference's unit cases against both packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_pool_pages_scratch_reuse_and_node_accounting(pkg):
    S, M = _mods(pkg)
    pool = _pool(S, n_pages=5)
    for uid in range(4):
        assert pool.grow(uid, 4)
    assert pool.n_free() == 0
    assert all(0 not in pool.block_table(u) for u in range(4))
    pool = _pool(S, n_pages=9)
    assert pool.grow(0, 32)
    first = pool.block_table(0)
    pool.free(0)
    assert pool.grow(1, 32)
    assert sorted(pool.block_table(1)) == sorted(first)
    assert pool.block_table(1)[0] == first[-1]        # LIFO reuse
    cfg = S.KVPoolConfig(n_pages=12, page_size=4, n_layers=3, n_kv_heads=2,
                         head_dim=8, dtype_bytes=4, n_nodes=4, numa=True)
    pool = S.KVCachePool(cfg)
    cap = pool.capacity_bytes_per_node()
    assert all(b == 3 * M._align(cfg.page_bytes) for b in cap.values())
    pool.grow(0, 16, node_hint=0)
    live = pool.live_bytes_per_node()
    assert sum(live.values()) == 4 * cfg.page_bytes
    assert live[0] == 2 * cfg.page_bytes


@pytest.mark.parametrize("pkg", PKGS)
def test_pool_refcounts_cow_and_prefix_match(pkg):
    S, _ = _mods(pkg)
    pool = _pool(S, n_pages=9)
    assert pool.grow(0, 8)
    shared = pool.block_table(0)
    pool.share_pages(1, shared)
    assert all(pool.refcount(p) == 2 for p in shared)
    pool.release(0)
    assert all(pool.refcount(p) == 1 for p in shared)
    pool.release(1)
    assert pool.n_live() == 0
    pool = _pool(S, n_pages=9)
    pool.grow(0, 4)
    [src] = pool.block_table(0)
    pool.share_pages(1, [src])
    assert pool.ensure_writable(1, 2)
    [dst] = pool.block_table(1)
    assert dst != src and pool.drain_copies() == [(src, dst)]
    pool = _pool(S)
    pool.grow(0, 9)
    pool.register_prefix(0, [1, 2, 3, 4, 5, 6, 7, 8])
    m = pool.match_prefix([1, 2, 3, 4, 5, 6, 200, 201, 202])
    assert m.n_tokens == 6
    assert m.cow_src == pool.block_table(0)[1] and m.cow_len == 2
    s, d = pool.copy_row_plan([(2, 5)], pad_to_pages=2)
    assert s.tolist() == [8, 9, 10, 11, 0, 0, 0, 0]
    assert d.tolist() == [20, 21, 22, 23, 0, 0, 0, 0]


@pytest.mark.parametrize("pkg", PKGS)
def test_scheduler_admission_preemption_and_chunking(pkg):
    S, _ = _mods(pkg)
    s = S.ContinuousScheduler(_pool(S), max_running=2, max_len=64)
    for i in range(3):
        s.submit(S.Request(uid=i, prompt=[1, 2, 3]), arrival=float(i))
    plan = s.step(now=10.0)
    assert [q.uid for q in plan.prefills] == [0, 1]
    assert len(s.waiting) == 1 and s.waiting[0].uid == 2
    # preemption: two sequences crossing a page boundary cannot both fit
    s = S.ContinuousScheduler(_pool(S, n_pages=7), max_running=2,
                              max_len=64)
    a = s.submit(S.Request(uid=0, prompt=[1] * 8), arrival=0.0)
    b = s.submit(S.Request(uid=1, prompt=[1] * 8), arrival=1.0)
    s.step(now=2.0)
    for seq in (a, b):
        seq.n_prefilled = seq.prefill_target
        seq.generated.extend([7] * 4)
    plan = s.step(now=3.0)
    assert [q.uid for q in plan.preempted] == [1], "youngest loses"
    assert b.full_prompt == [1] * 8 + [7] * 4
    # chunked prefill never blocks decode
    sched = S.ContinuousScheduler(_pool(S), max_running=4, max_len=64,
                                  prefill_chunk=2)
    a = sched.submit(S.Request(uid=0, prompt=[1, 2, 3]))
    sched.step()
    a.n_prefilled = a.prefill_target
    a.generated.append(7)
    b = sched.submit(S.Request(uid=1, prompt=list(range(10, 20))))
    steps = 0
    while b.is_prefilling or b.slot == -1:
        plan = sched.step()
        assert [q.uid for q in plan.decodes] == [0]
        b.n_prefilled += sched.chunk_for(b)
        a.generated.append(7)
        steps += 1
    assert steps == 5


# ----------------------------------------------------------------------
# engine: greedy-token parity with the reference engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared_model():
    jcfg = JModelConfig(name="tiny", arch_type="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab_size=259, dtype=jnp.float32)
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = torch.float32
    tm = tbuild(ModelConfig(**fields))
    return (jm, jax.tree.map(jnp.asarray, tree),
            tm, params_from_numpy(tree, "cpu"))


MIXED = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16],
         [5, 4, 3], [9, 9, 2, 1]]
RNG_PROMPTS = [list(np.random.default_rng(11).integers(1, 258, n))
               for n in (17, 3, 9, 6)]

ENGINE_CASES = {
    # name: (prompts, max_new, arrivals, engine kwargs)
    "mixed": (MIXED, 5, None, dict(max_running=3)),
    "preemption": (MIXED, 6, None, dict(max_running=3, n_pages=8)),
    "prefix-cow": ([[1, 2, 3, 4, 5, 6, 7, 8],
                    [1, 2, 3, 4, 5, 6, 200, 201, 202]], 6, [0.0, 0.05],
                   dict(max_running=4)),
    "chunked": (RNG_PROMPTS, 5, None, dict(max_running=4,
                                           prefix_cache=False,
                                           prefill_chunk=4)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_greedy_tokens_match_the_reference(shared_model, case):
    jm, jparams, tm, tparams = shared_model
    prompts, max_new, arrivals, kw = ENGINE_CASES[case]
    out, engines = {}, {}
    for pkg, S, model, params, extra in (
            ("repro", jserving, jm, jparams, {}),
            ("repro_torch", tserving, tm, tparams, {"device": "cpu"})):
        reqs = [S.Request(uid=i, prompt=[int(t) for t in p],
                          sampling=S.SamplingParams(max_new_tokens=max_new))
                for i, p in enumerate(prompts)]
        eng = S.ContinuousServingEngine(model, params, max_len=48,
                                        page_size=4,
                                        clock=S.VirtualClock(), **kw,
                                        **extra)
        out[pkg] = [c.tokens for c in eng.generate(reqs, arrivals=arrivals)]
        engines[pkg] = eng
    assert out["repro_torch"] == out["repro"]
    assert all(len(t) == max_new for t in out["repro"])
    st_j, st_t = engines["repro"].pool.stats, engines["repro_torch"].pool.stats
    assert st_t == st_j
    if case == "preemption":
        assert engines["repro_torch"].scheduler.n_preemptions > 0
    if case == "prefix-cow":
        assert st_t["cow_copies"] >= 1 and st_t["shared_pages"] >= 1


def _moe_shared(arch, capacity_factor=None):
    """A reduced MoE arch in float32 (4 experts, top-2) in both packages,
    on the reference's ``PRNGKey(0)`` weights."""
    from repro.configs import get_config as jget_config
    from repro.models import reduced_config as jreduced
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               dtype=jnp.float32)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = torch.float32
    return (jm, jax.tree.map(jnp.asarray, tree),
            tbuild(ModelConfig(**fields)), params_from_numpy(tree, "cpu"))


MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "grok-1-314b"]


@pytest.mark.parametrize("arch,case", [(a, c) for a in MOE_ARCHS
                                       for c in sorted(ENGINE_CASES)])
def test_moe_engine_greedy_tokens_match_the_reference(arch, case):
    """The continuous engines of both packages on a reduced MoE arch at
    the config's capacity factor, 1.25: a decode step's capacity counts
    its idle lanes and a prefill chunk's its padded rows, so tokens drop,
    and the port must drop the same ones (the virtual clock fixes the
    schedule)."""
    jm, jparams, tm, tparams = _moe_shared(arch)
    prompts, max_new, arrivals, kw = ENGINE_CASES[case]
    out = {}
    for pkg, S, model, params, extra in (
            ("repro", jserving, jm, jparams, {}),
            ("repro_torch", tserving, tm, tparams, {"device": "cpu"})):
        reqs = [S.Request(uid=i, prompt=[int(t) for t in p],
                          sampling=S.SamplingParams(max_new_tokens=max_new))
                for i, p in enumerate(prompts)]
        eng = S.ContinuousServingEngine(model, params, max_len=48,
                                        page_size=4,
                                        clock=S.VirtualClock(), **kw,
                                        **extra)
        out[pkg] = ([c.tokens for c in eng.generate(reqs, arrivals=arrivals)],
                    eng.pool.stats)
    assert out["repro_torch"] == out["repro"]
    assert all(len(t) == max_new for t in out["repro"][0])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_async_and_bucket_engines_match_the_reference(arch):
    """At the serve CLI's capacity factor, 4.0, four experts never drop a
    token, so an MoE step's rows are independent and the async engine's
    live batching cannot change a token: the port's async, continuous
    and bucket engines and the reference's async engine give the same
    greedy tokens."""
    jm, jparams, tm, tparams = _moe_shared(arch, capacity_factor=4.0)

    def reqs(S):
        return [S.Request(uid=i, prompt=[int(t) for t in p],
                          sampling=S.SamplingParams(max_new_tokens=6))
                for i, p in enumerate(MIXED)]

    with tserving.AsyncEngine(tm, tparams, max_len=48, max_running=3,
                              page_size=4, device="cpu") as eng:
        handles = [eng.submit(r) for r in reqs(tserving)]
        got = [eng.result(h, timeout=120).tokens for h in handles]
    with jserving.AsyncEngine(jm, jparams, max_len=48, max_running=3,
                              page_size=4) as jeng:
        handles = [jeng.submit(r) for r in reqs(jserving)]
        want = [jeng.result(h, timeout=300).tokens for h in handles]
    cont = tserving.ContinuousServingEngine(
        tm, tparams, max_len=48, max_running=3, page_size=4,
        device="cpu").generate(reqs(tserving))
    bucket = tserving.ServingEngine(tm, tparams, max_len=48,
                                    device="cpu").generate(reqs(tserving))
    assert got == want
    assert [c.tokens for c in cont] == want
    assert [c.tokens for c in bucket] == want


def test_engine_refuses_missing_gpu_and_unported_features(shared_model):
    """No GPU raises; tensor-parallel serving (``mesh=``) is ported
    (``tests/test_torch_tp_serving.py``) and refuses a shard count the
    kv heads do not divide; speculative decoding is ported
    (``tests/test_torch_spec.py``), and a negative lookahead is refused
    as in the reference."""
    _, _, tm, tparams = shared_model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserving.ContinuousServingEngine(tm, tparams, max_len=32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserving.AsyncEngine(tm, tparams, max_len=32)
    from repro_torch.launch.mesh import Mesh
    with pytest.raises(ValueError, match="head"):
        tserving.ContinuousServingEngine(
            tm, tparams, max_len=32, mesh=Mesh(("model",), (4,), 0, {}),
            device="cpu")
    with pytest.raises(ValueError, match="spec_decode"):
        tserving.ContinuousServingEngine(tm, tparams, max_len=32,
                                         spec_decode=-1, device="cpu")
    eng = tserving.ContinuousServingEngine(tm, tparams, max_len=32,
                                           spec_decode=2, device="cpu")
    assert eng.core.spec_decode == 2
    assert eng.scheduler.spec_lookahead == 2


def test_sampler_greedy_ties_and_top_k():
    logits = torch.tensor([[[0.0, 3.0, 3.0, 1.0]], [[5.0, 5.0, 0.0, 0.0]]])
    sp = tserving.SamplingParams()
    assert tserving.sample(logits, sp, None).tolist() == [[1], [0]]
    gen = torch.Generator().manual_seed(0)
    hot = tserving.SamplingParams(temperature=1.0, top_k=2)
    draws = {int(t) for _ in range(50)
             for t in tserving.sample(logits[:1], hot, gen).flatten()}
    assert draws <= {1, 2}
    toks = tserving.sample_grouped(logits, [sp, hot], gen)
    assert toks.shape == (2, 1) and toks[0, 0] == 1


# ----------------------------------------------------------------------
# import isolation and the CLI
# ----------------------------------------------------------------------

def test_port_imports_without_jax_or_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.models.weights\n"
        "import repro_torch.quant, repro_torch.configs\n"
        "import repro_torch.kernels.rglru_scan\n"
        "import repro_torch.kernels.decode_attention\n"
        "import repro_torch.models.recurrent, repro_torch.models.ssm\n"
        "import repro_torch.models.moe, repro_torch.configs.phi35_moe\n"
        "import repro_torch.configs.grok1, repro_torch.configs.mamba2_370m\n"
        "import repro_torch.serving.async_engine, repro_torch.obs.validate\n"
        "import repro_torch.obs.spans\n"
        "import repro_torch.configs.granite_3_8b\n"
        "import repro_torch.configs.qwen2_72b, repro_torch.configs.shapes\n"
        "import repro_torch.data.pipeline\n"
        "import repro_torch.configs.llama32_vision_11b\n"
        "import repro_torch.configs.whisper_medium\n"
        "from repro_torch.serving import ServingEngine, BucketRunner\n"
        "from repro_torch.serving import AsyncEngine, AsyncEngineError\n"
        "from repro_torch.models.weights import load_params_npz\n"
        "import repro_torch.serving.http, repro_torch.serving.router\n"
        "import repro_torch.serving.supervisor, repro_torch.serving.worker\n"
        "from repro_torch.serving import HttpFrontend, Router, Supervisor\n"
        "import repro_torch.training, repro_torch.launch.train\n"
        "import repro_torch.training.loop, repro_torch.training.checkpoint\n"
        "import repro_torch.core.tp, repro_torch.core.engine\n"
        "import repro_torch.core.graph, repro_torch.core.threads\n"
        "import repro_torch.core.numa, repro_torch.launch.mesh\n"
        "import repro_torch.launch.shardings, repro_torch.launch.specs\n"
        "import repro_torch.launch.step_cost, repro_torch.launch.roofline\n"
        "import repro_torch.launch.dryrun, repro_torch.models.attention\n"
        "from repro_torch.core import Engine, make_tp_block, PartitionPlan\n"
        "bad = sorted(m for m, mod in sys.modules.items()\n"
        "             if mod is not None and (m == 'repro'\n"
        "             or m.startswith(('repro.', 'jax', 'ml_dtypes'))))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_serve_cli_on_cpu():
    # the CLI warm-trains first: one thread, as xdist's busy workers share
    # the cores (parallel CPU ops spin against them otherwise)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen3-1.7b", "--engine", "continuous", "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[")]
    assert len(lines) == 4 and all(" -> " in ln for ln in lines)
    assert "throughput:" in out.stdout
