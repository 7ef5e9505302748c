"""The frozen arithmetic of ``portbench.counts`` against hand counts."""

import json
from pathlib import Path

import pytest

from portbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_qwen3_params_per_token_by_hand():
    # per layer: q 2048x2048, k and v 2048x1024, o 2048x2048, gated MLP
    # 3 x 2048 x 6144; 28 layers; the tied head 151936 x 2048
    layer = 2048 * 2048 * 2 + 2048 * 1024 * 2 + 3 * 2048 * 6144
    want = 28 * layer + 151936 * 2048
    assert counts.matmul_params_per_token(cfg("qwen3-1.7b")) == want
    # the published total (1.72 B) counts the embedding once and the
    # norms, which multiply nothing: 1.409 B in layers + 0.311 B embedding
    assert abs(want - 1.720e9) < 0.01e9


def test_phi_params_per_token_takes_k_of_e_experts():
    layer = (4096 * 4096 * 2 + 4096 * 1024 * 2      # q, o; k, v
             + 2 * 3 * 4096 * 6400 + 4096 * 16)     # 2 experts; router
    want = 16 * layer + 32064 * 4096                # untied head
    assert counts.matmul_params_per_token(cfg("phi3.5-moe-16l")) == want


def test_decode_token_flops_adds_attention_at_its_context():
    c = cfg("qwen3-1.7b")
    base = 2 * counts.matmul_params_per_token(c)
    # 4 FLOPs a key per query head and head dim, 28 layers
    assert counts.decode_token_flops(c, 1000) - base == 4 * 1000 * 16 * 128 * 28
    assert counts.attention_flops(c, 0) == 0


def test_paged_rows_count_a_shared_prefix_once():
    # three lanes of one document (1000 shared tokens) and one alone
    lanes = [(1010, "d", 1000), (1050, "d", 1000), (1200, "d", 1000),
             (300, None, 0)]
    assert counts.paged_attn_rows(lanes) == 1000 + 10 + 50 + 200 + 300
    # a lane still inside the shared prefix needs only what it reached
    assert counts.paged_attn_rows([(500, "d", 1000), (800, "d", 1000)]) == 800
    # two groups stay apart
    assert counts.paged_attn_rows([(100, 1, 90), (100, 2, 90)]) == 200


def test_paged_least_bytes_by_hand():
    c = cfg("qwen3-1.7b")
    lanes = [(129, None, 0), (513, None, 0), (0, None, 0)]
    nbytes, flops = counts.paged_attn_least(c, lanes)
    # K and V rows of 8 kv heads x 128 x 2 bytes, q and out of 16 heads,
    # idle lanes (kv_len 0) read nothing; every one of 28 layers
    kv = 2 * (129 + 513) * 8 * 128 * 2
    qo = 2 * 2 * 16 * 128 * 2
    assert nbytes == 28 * (kv + qo)
    assert flops == 28 * 4 * (129 + 513) * 16 * 128
    t = counts.least_seconds(nbytes, flops)
    assert t == pytest.approx(nbytes / 3.35e12)      # bytes bound it


def test_shared_prefix_lowers_the_bound_not_below_one_read():
    c = cfg("qwen3-1.7b")
    alone = counts.paged_attn_least(c, [(2000, None, 0)] * 4)[0]
    shared = counts.paged_attn_least(c, [(2000, 0, 1900)] * 4)[0]
    once = counts.paged_attn_least(c, [(2000, None, 0)])[0]
    assert once < shared < alone
