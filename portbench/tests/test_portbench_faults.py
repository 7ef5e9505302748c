"""A whole run of the harness on the CPU at a tiny size (the look for a
card skipped: ``run_cell`` is handed the CPU), once sound and once with
each fault a served cell can have planted underneath the timed path;
``correct`` has to come out false for every fault."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


def run(tmp_path, cell, seed=2**31 + 5):
    bench = tiny.setup(tmp_path)
    return harness.run_cell(bench, cell, seed, 2.0, False, "cpu",
                            time.perf_counter(),
                            config_dir=tmp_path / "configs",
                            traffic_dir=tmp_path / "traffic",
                            log=lambda *a: None)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny-moe.batch",
                                  "tiny.rag"])
def test_sound_run_is_correct(tmp_path, cell):
    res = run(tmp_path, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 10 and res["failed"] == 0
    assert set(res["metrics"]) == {"output_tok_s", "itl_p95_ms",
                                   "setup_s"}
    assert list(res)[-1] == "checks"
    kv = res["kv_pages"]            # read from the pool's gauges
    assert kv["samples"] > 0
    assert 0 < kv["live_peak"] <= kv["held_peak"] < kv["pages_total"]


def test_token_altered_where_produced(tmp_path, monkeypatch):
    from repro_torch.serving import core

    def worst(logits, sps, gen):        # the least likely token instead
        return logits[:, -1:].float().argmin(dim=-1).to(torch.int32)

    monkeypatch.setattr(core, "sample_grouped", worst)
    res = run(tmp_path, "tiny.chat")
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > \
        res["checks"]["logit_gap"]["max"]


def test_decode_step_leaves_its_state_unchanged(tmp_path, monkeypatch):
    from repro_torch.models import transformer

    orig = transformer._paged_attn

    def no_write(cfg, q, k, v, window, cache, paged):
        if q.shape[1] == 1:             # a decode step writes a copy
            cache = {n: t.clone() for n, t in cache.items()}
        return orig(cfg, q, k, v, window, cache, paged)

    monkeypatch.setattr(transformer, "_paged_attn", no_write)
    res = run(tmp_path, "tiny.chat")
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > \
        res["checks"]["logit_gap"]["max"]
