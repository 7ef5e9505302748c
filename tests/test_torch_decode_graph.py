"""``ModelRunner.decode`` against an eager ``Model.decode_step``.

On a single CUDA rank the runner replays its decode step from a CUDA
graph (``serving.runner.DecodeGraph``); everywhere else it runs the step
eagerly.  Each case drives two runners built alike through the same run
of steps: lanes join (one-shot and chunked prefill), decode, get new
pages, finish and sit idle, and a finished lane's slot is reused, so
the block tables change between calls.  Runner A answers through
``runner.decode``; runner B through ``Model.decode_step`` on its own
cache.  Logits are held equal bit for bit at every step (the same
kernels on the same inputs), and so are the two caches at the end,
but for the scratch page that idle lanes write.

The CPU cases run the eager path.  The ``cuda`` cases skip without a
GPU; on the card (``python -m pytest -m cuda
tests/test_torch_decode_graph.py``) they run the replay against the
eager step for a Qwen3-shaped model with bf16 pages, int8 pages and
Q4_0 weights, and a Phi-3.5-MoE-shaped one, at four lanes and 256 wide,
and at the published widths (two layers) with the lanes the benchmark's
cells and the smoke run serve (64 and 8), where the kernels plan their
launches as they do there.  This file imports neither JAX nor the
reference package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.registry import reduced_config
from repro_torch.obs import MetricsRegistry
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serving.runner import ModelRunner

B, PAGE, MAX_LEN, N_PAGES = 4, 4, 64, 64
MAX_PAGES = MAX_LEN // PAGE
STEPS = 36
#: (step, slot, prompt length, chunks): a lane joins at the step's start;
#: slot 0 is reused after its first sequence finishes
JOINS = [(0, 0, 5, 1), (0, 1, 9, 2), (5, 2, 7, 2), (16, 0, 3, 1),
         (20, 3, 6, 1)]
#: (step, slot): a lane finishes at the step's start
FINISHES = [(12, 0), (30, 2)]

CPU_DENSE = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
                 dtype=torch.float32)
CPU_MOE = dict(CPU_DENSE, name="tiny-moe", arch_type="moe", n_experts=4,
               experts_per_token=2, capacity_factor=2.0)


def _card_config(arch: str) -> ModelConfig:
    """A two-layer bf16 model of the arch's family with head_dim 128, the
    paged kernel's main-path head size; MoE at capacity factor E / k."""
    cfg = dataclasses.replace(
        reduced_config(get_config(arch), n_layers=2, d_model=256,
                       vocab=512),
        n_heads=4, n_kv_heads=2, head_dim=128, remat=False,
        dtype=torch.bfloat16)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    return cfg


def _full_width_config(arch: str) -> ModelConfig:
    """The arch's published widths at two layers, in its own dtype."""
    return dataclasses.replace(get_config(arch), n_layers=2, remat=False)


def _runner(model, params, device, quant, registry=None, lanes=B):
    return ModelRunner(model, params, max_running=lanes, max_len=MAX_LEN,
                       page_size=PAGE, n_pages=N_PAGES, quant=quant,
                       registry=registry, device=device)


def _drive(cfg: ModelConfig, device: str, quant: QuantPolicy,
           lanes: int = B):
    """Run the scenario on slots 0 to 3 of ``lanes`` (the rest stay
    idle); returns (runner A, its registry, the decode calls made,
    whether each step's logits stayed intact until the next call).
    Asserts bit-equal logits at every step and bit-equal caches at the
    end."""
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    reg = MetricsRegistry()
    a = _runner(model, params, device, quant, reg, lanes)
    b = _runner(model, params, device, quant, lanes=lanes)
    rng = np.random.default_rng(0)
    free = list(rng.permutation(np.arange(1, N_PAGES)))
    tables = np.zeros((lanes, MAX_PAGES), np.int32)
    pages = {s: [] for s in range(lanes)}
    nxt = np.full(lanes, -1, np.int64)    # position of the token to feed
    last = np.zeros(lanes, np.int64)      # the token to feed
    joins = {}
    for step, slot, n, chunks in JOINS:
        joins.setdefault(step, []).append((slot, n, chunks))
    finishes = {}
    for step, slot in FINISHES:
        finishes.setdefault(step, []).append(slot)

    def grant(slot, upto):
        while len(pages[slot]) * PAGE <= upto:
            p = int(free.pop())
            tables[slot, len(pages[slot])] = p
            pages[slot].append(p)

    def upload():
        a.set_block_tables(tables)
        b.set_block_tables(tables)

    calls, intact = 0, []
    held = None                           # (last logits, their copy)
    for step in range(STEPS):
        for slot in finishes.get(step, []):
            free.extend(pages[slot])
            pages[slot] = []
            tables[slot] = 0
            nxt[slot] = -1
        for slot, n, chunks in joins.get(step, []):
            prompt = rng.integers(0, cfg.vocab_size, n).tolist()
            grant(slot, n - 1)
            upload()
            cut = -(-n // chunks)
            for start in range(0, n, cut):
                part = prompt[start:start + cut]
                fresh = chunks == 1
                la = a.prefill_chunk(part, slot=slot, start=start,
                                     fresh=fresh)
                lb = b.prefill_chunk(part, slot=slot, start=start,
                                     fresh=fresh)
                assert torch.equal(la, lb)
            last[slot] = int(la[0, -1].float().argmax())
            nxt[slot] = n
        if held is not None:              # prefill and uploads since
            intact.append(torch.equal(held[0], held[1]))
        for slot in range(lanes):
            if nxt[slot] >= 0:
                grant(slot, int(nxt[slot]))
        upload()
        fed = last.reshape(lanes, 1).astype(np.int32)
        pos = nxt.astype(np.int32)
        prev = held[0] if held is not None else None
        la = a.decode(fed, pos)
        lb, _ = b.local_model.decode_step(
            b.params, b.cache,
            torch.from_numpy(fed.astype(np.int64)).to(device),
            torch.from_numpy(pos.astype(np.int64)).to(device),
            page_size=PAGE)
        calls += 1
        assert la.shape == (lanes, 1, cfg.vocab_size)
        assert torch.equal(la, lb), f"step {step}: logits differ"
        if a.decode_graph is not None and prev is not None:
            assert la.data_ptr() == prev.data_ptr()   # overwritten in place
        toks_a = la[:, 0].float().argmax(-1).cpu().numpy()
        toks_b = lb[:, 0].float().argmax(-1).cpu().numpy()
        assert np.array_equal(toks_a, toks_b)
        held = (la, la.clone())
        for slot in range(lanes):
            if nxt[slot] >= 0:
                last[slot] = toks_a[slot]
                nxt[slot] += 1
    for la_, lb_ in zip(a.cache["layers"], b.cache["layers"]):
        for name, buf in la_["self"].items():
            # past the scratch page (page 0, rows 0 to PAGE - 1): every
            # idle lane writes the same scratch row, and which of those
            # writes lands is not fixed; the row is never read unmasked
            assert torch.equal(buf[PAGE:], lb_["self"][name][PAGE:]), name
    return a, reg, calls, intact


CPU_CASES = {
    "dense": (CPU_DENSE, QuantPolicy()),
    "moe": (CPU_MOE, QuantPolicy()),
    "int8-pages": (CPU_DENSE, QuantPolicy(kv_dtype="int8")),
    "q4": (CPU_DENSE, QuantPolicy(weights="q4")),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_runner_decode_equals_model_decode_step_on_the_cpu(case):
    cfg, quant = CPU_CASES[case]
    a, reg, calls, intact = _drive(ModelConfig(**cfg), "cpu", quant)
    assert a.decode_graph is None
    assert intact and all(intact)
    ctr = reg.get("runner.decode.calls")
    assert ctr.value(path="eager") == calls
    assert ctr.value(path="graph") == 0


def test_decode_contract_and_eager_counter_on_the_cpu():
    """The logits of a decode call survive the prefill chunks, verify
    steps and table uploads that an engine runs before the next decode
    call; each call counts once on the eager path."""
    model = build_model(ModelConfig(**CPU_DENSE))
    params = model.init(torch.Generator().manual_seed(1))
    reg = MetricsRegistry()
    r = _runner(model, params, "cpu", QuantPolicy(), reg)
    tables = np.zeros((B, MAX_PAGES), np.int32)
    tables[0, :2] = [3, 5]
    r.set_block_tables(tables)
    r.prefill_chunk([1, 2, 3, 4, 5], slot=0, start=0, fresh=True)
    fed = np.zeros((B, 1), np.int32)
    pos = np.array([5, -1, -1, -1], np.int32)
    logits = r.decode(fed, pos)
    copy = logits.clone()
    tables[1, :1] = [7]
    r.set_block_tables(tables)
    r.prefill_chunk([9, 8, 7], slot=1, start=0, fresh=True)
    r.verify(np.zeros((B, 2), np.int32), np.array([6, -1, -1, -1],
                                                  np.int32),
             np.array([2, 1, 1, 1], np.int32))
    assert torch.equal(logits, copy)
    r.decode(fed, pos)
    assert reg.get("runner.decode.calls").value(path="eager") == 2
    assert "valid until the next" in ModelRunner.decode.__doc__


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the decode graph is a CUDA "
                    "graph; the CPU cases run the eager path)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


Q4_INT8 = QuantPolicy(weights="q4", kv_dtype="int8")
#: case: (arch, quant, lanes, at the published widths)
CUDA_CASES = {
    "qwen3-bf16-pages": ("qwen3-1.7b", QuantPolicy(), B, False),
    "qwen3-int8-pages": ("qwen3-1.7b", QuantPolicy(kv_dtype="int8"), B,
                         False),
    "qwen3-q4": ("qwen3-1.7b", QuantPolicy(weights="q4"), B, False),
    "phi-moe-bf16-pages": ("phi3.5-moe-42b-a6.6b", QuantPolicy(), B,
                           False),
    "qwen3-full-width-bf16-64-lanes": ("qwen3-1.7b", QuantPolicy(), 64,
                                       True),
    "qwen3-full-width-q4-int8-64-lanes": ("qwen3-1.7b", Q4_INT8, 64, True),
    "qwen3-full-width-q4-int8-8-lanes": ("qwen3-1.7b", Q4_INT8, 8, True),
    "phi-moe-full-width-bf16-64-lanes": ("phi3.5-moe-42b-a6.6b",
                                         QuantPolicy(), 64, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_graph_replay_equals_eager_decode_step(case):
    dev = _cuda()
    arch, quant, lanes, full = CUDA_CASES[case]
    cfg = _full_width_config(arch) if full else _card_config(arch)
    a, reg, calls, intact = _drive(cfg, dev, quant, lanes)
    assert a.decode_graph is not None
    assert intact and all(intact)
    ctr = reg.get("runner.decode.calls")
    assert ctr.value(path="graph") == calls
    assert ctr.value(path="eager") == 0


@pytest.mark.cuda
def test_graph_replay_counts_the_captured_kernel_launches():
    """The device trace of three replays holds the paged kernel's split
    and merge launches once a layer a replay, as an eager step launches
    them, while the wrapper, which a replay does not run, counts none."""
    dev = _cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import paged_decode_attention
    cfg = _card_config("qwen3-1.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    r = _runner(model, params, dev, QuantPolicy())
    before = paged_decode_attention.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            r.decode(np.zeros((B, 1), np.int32), np.full(B, -1, np.int32))
        torch.cuda.synchronize()
    assert paged_decode_attention.launches == before
    counts = {"paged_split_kernel": 0, "paged_merge_kernel": 0}
    for e in prof.key_averages():
        for name in counts:
            if e.device_type == DeviceType.CUDA and name in e.key:
                counts[name] += e.count
    assert counts == dict.fromkeys(counts, 3 * cfg.n_layers)
