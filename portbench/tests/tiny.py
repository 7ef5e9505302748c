"""A tiny configuration, mixes and BENCHMARK entries for driving whole
runs of the harness on the CPU in the tests (float32, 2 layers, d_model
64), written into a temporary directory."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

TINY = {
    "name": "tiny", "source": "test", "model_type": "qwen3",
    "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "tie_word_embeddings": True,
    "torch_dtype": "float32", "reduced": [],
    "port": {"arch_type": "dense", "n_layers": 2, "d_model": 64,
             "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
             "vocab_size": 512, "qk_norm": True, "rope_theta": 10000.0,
             "tie_embeddings": True, "norm_eps": 1e-06},
    "reference": "qwen3",
    "engine": {"page_size": 4, "prefill_chunk": 16, "max_running": 8,
               "max_len": 128, "prefix_cache": True,
               "memory_fraction": 0.9, "activation_reserve_gib": 0},
    "check": {"statistic": "logit_gap", "limit": 1e-3},
}

TINY_MOE = dict(
    TINY, name="tiny-moe", model_type="phimoe", reference="phimoe",
    tie_word_embeddings=False, num_local_experts=4, num_experts_per_tok=2,
    port=dict(TINY["port"], arch_type="moe", qk_norm=False,
              tie_embeddings=False, n_experts=4, experts_per_token=2,
              capacity_factor=2.0))

MIXES = {
    "chat": {"loop": "open", "rate_per_s": 40.0, "arrival_seed": 1,
             "ramp_s": 0.5,
             "prompt": {"median": 12, "sigma": 0.5, "min": 4, "max": 40},
             "output": {"median": 6, "sigma": 0.5, "min": 3, "max": 12},
             "check_requests": 4},
    "batch": {"loop": "closed", "clients": 6, "ramp_s": 0.5,
              "prompt": {"min": 8, "max": 30},
              "output": {"median": 6, "sigma": 0.5, "min": 3, "max": 10},
              "check_requests": 4},
    # shared documents: no cell of BENCHMARK.json sends them yet, but the
    # generator keeps the path for a later cell that adds only data
    "rag": {"loop": "open", "rate_per_s": 40.0, "arrival_seed": 2,
            "burstiness": 0.5, "ramp_s": 0.5,
            "documents": {"count": 4, "min": 16, "max": 48, "zipf_s": 1.0},
            "question": {"min": 2, "max": 6},
            "output": {"median": 5, "sigma": 0.5, "min": 3, "max": 8},
            "check_requests": 4},
}


def setup(tmp: Path) -> Dict:
    """Write the tiny files under ``tmp``; return a BENCHMARK dict whose
    cells are ``tiny.<mix>`` and ``tiny-moe.<mix>``."""
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "traffic").mkdir(parents=True, exist_ok=True)
    for cfg in (TINY, TINY_MOE):
        (tmp / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, mix in MIXES.items():
        (tmp / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    root = Path(__file__).resolve().parents[2]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": f"{c}.{m}", "config": c, "traffic": m, "chips": 1}
        for c in ("tiny", "tiny-moe") for m in MIXES]
    for group in ("end_to_end", "per_layer"):   # every metric in every cell
        for m in bench[group]:
            m.pop("workloads", None)
    return bench
