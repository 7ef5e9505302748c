"""The plain references (``portbench/reference``) against the port's
model on the CPU at small widths: a prompt prefilled in chunks into the
paged cache, then decode steps through it, every logit within float32
rounding of the reference's single forward over the same tokens."""

import pytest
import torch

from portbench import check, serve
from portbench.tests import tiny

PAGE = 4


def port_logits(cfg, prompts, n_decode, chunk):
    """Logits the port gives each prompt's last token and ``n_decode``
    greedy decode steps after it (lanes decoding together), and the
    tokens fed."""
    from repro_torch.models import build_model

    mc = serve.model_config(cfg)
    model = build_model(mc)
    params = serve.draw_params(model, 5, "cpu")
    B, max_len = len(prompts), 64
    cache = model.init_cache(B, max_len, page_size=PAGE, device="cpu")
    mp = cache["block_tables"].shape[1]
    cache["block_tables"].copy_(
        1 + torch.arange(B * mp, dtype=torch.int32).flip(0).reshape(B, mp))
    out = [[] for _ in prompts]
    fed = []
    for b, p in enumerate(prompts):
        for start in range(0, len(p), chunk):
            part = p[start:start + chunk]
            Sp = max(8, 1 << (len(part) - 1).bit_length())
            toks = torch.zeros((1, Sp), dtype=torch.long)
            toks[0, :len(part)] = torch.tensor(part)
            kw = {} if start == 0 else {
                "start": start, "ctx_pages": mp}
            logits, _ = model.prefill_paged(params, {"tokens": toks}, cache,
                                            b, len(part), page_size=PAGE, **kw)
        out[b].append(logits[0, -1])
        fed.append(int(logits[0, -1].argmax()))
    seqs = [list(p) for p in prompts]
    for _ in range(n_decode):
        pos = torch.tensor([len(s) for s in seqs])
        tok = torch.tensor(fed)[:, None]
        logits, _ = model.decode_step(params, cache, tok, pos,
                                      page_size=PAGE)
        for b in range(B):
            seqs[b].append(fed[b])
            out[b].append(logits[b, 0])
        fed = [int(logits[b, 0].argmax()) for b in range(B)]
    return params, seqs, out


@pytest.mark.parametrize("cfg", [tiny.TINY, tiny.TINY_MOE],
                         ids=["qwen3", "phimoe"])
def test_reference_matches_port_prefill_then_paged_decode(cfg):
    prompts = [list(range(3, 40, 2)), list(range(100, 111))]
    params, seqs, got = port_logits(cfg, prompts, n_decode=6, chunk=8)
    ref = check.reference_module(cfg)
    for b, p in enumerate(prompts):
        toks = torch.tensor(seqs[b])
        rows = torch.arange(len(p) - 1, len(seqs[b]))
        want = ref.logits(params, cfg, toks, rows)
        have = torch.stack(got[b])
        assert want.shape == have.shape
        torch.testing.assert_close(have, want, atol=2e-5, rtol=2e-5)


def test_fp8_control_departs_from_float32():
    from repro_torch.models import build_model

    cfg = tiny.TINY
    model = build_model(serve.model_config(cfg))
    params = serve.draw_params(model, 9, "cpu")
    ref = check.reference_module(cfg)
    toks = torch.arange(5, 45)
    rows = torch.arange(10, 40)
    exact = ref.logits(params, cfg, toks, rows)
    low = ref.logits(params, cfg, toks, rows, precision="fp8")
    err = (exact - low).abs().max().item()
    # fp8 e4m3 keeps 3 mantissa bits: errors far above float32 rounding
    assert err > 1e-3
    assert check.gaps(exact, exact.argmax(-1)).max().item() == 0.0
