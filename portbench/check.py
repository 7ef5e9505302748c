"""The output check that decides ``correct``.

After the window closes, a sample of the requests the engine finished in
the window is drawn from the seed, the longest of them always in it.  The
plain reference of the configuration's family
(``portbench/reference/<family>.py``, float32, TF32 off) runs once over
each sampled prompt followed by its served tokens, on the same weights,
and reads, at each position where a token was served, how far that
token's logit lies below the reference's best there.  The widest such
gap over the sample (``logit_gap``) is compared with the configuration's
limit.  The requests are greedy, so a sound program serves the
reference's argmax or a token within rounding of it.

The control (:func:`control_gap`) puts the reference computed in fp8 in
the program's place: at the same positions of the same prompts and
tokens, the gap of the token the fp8 forward ranks first.  Benchmark runs
never compute it; ``portbench/calibrate.py`` does.
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

#: the sample never takes more than this many requests
MAX_SAMPLE = 64


def sample(records: Sequence, n: int, seed: int, t_w0: float,
           t_w1: float) -> List:
    """``n`` of the requests finished inside the window, drawn from the
    seed, the one with the most prompt and served tokens first."""
    done = [r for r in records
            if r.finished and r.stamps and t_w0 <= r.stamps[-1] < t_w1]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.req.prompt) + len(r.tokens))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 1])
    picks = rng.permutation(len(rest))[:max(0, min(n, MAX_SAMPLE) - 1)]
    return [longest] + [rest[i] for i in sorted(picks)]


def reference_module(cfg: Dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def _inputs(rec, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tokens, rows, served): the prompt and every served token but the
    last, the positions whose logits chose the served tokens, and the
    served tokens."""
    prompt, served = list(rec.req.prompt), list(rec.tokens)
    toks = torch.tensor(prompt + served[:-1], device=device)
    rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served),
                        device=device)
    return toks, rows, torch.tensor(served, device=device)


def gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per row: the best logit minus the chosen token's."""
    return logits.max(dim=-1).values - logits.gather(1, chosen[:, None])[:, 0]


@torch.no_grad()
def logit_gap(cfg: Dict, params, recs: Sequence, device) -> Dict[str, float]:
    """The gap of each served token below the reference's best, over
    ``recs``: the widest (``logit_gap``) and the mean over the served
    tokens (``logit_gap_mean``); with the tokens and seconds it took."""
    from .reference._plain import strict_f32

    strict_f32()
    ref = reference_module(cfg)
    t0 = time.perf_counter()
    per_token = []
    for rec in recs:
        toks, rows, served = _inputs(rec, device)
        per_token.append(gaps(ref.logits(params, cfg, toks, rows), served))
    g = torch.cat(per_token) if per_token else torch.zeros(1)
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "tokens": int(g.numel()), "seconds": time.perf_counter() - t0}


@torch.no_grad()
def control_gap(cfg: Dict, params, recs: Sequence, device,
                precision: str = "fp8") -> Dict[str, float]:
    """The gap below the float32 reference's best of the token the
    reference in ``precision`` ranks first, over the served positions of
    ``recs``: the widest and the mean, as :func:`logit_gap` reads the
    program's.  ``"fp8"`` is the control; ``"bf16"`` a witness of what
    the configuration's own precision alone reads."""
    from .reference._plain import strict_f32

    strict_f32()
    ref = reference_module(cfg)
    per_token = []
    for rec in recs:
        toks, rows, _ = _inputs(rec, device)
        exact = ref.logits(params, cfg, toks, rows)
        low = ref.logits(params, cfg, toks, rows, precision=precision)
        per_token.append(gaps(exact, low.argmax(dim=-1)))
    g = torch.cat(per_token)
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean())}


@torch.no_grad()
def routing_look(cfg: Dict, params, recs: Sequence, device,
                 ties=(0.001, 0.003, 0.01, 0.03)) -> Dict[str, list]:
    """For a mixture-of-experts family: each served token's gap beside
    the narrowest margin, over the layers, between its k-th and (k+1)-th
    router probabilities in the float32 reference.  For each threshold t:
    [t, served tokens whose margin stays at or above t, the widest and
    the mean gap among them]."""
    from .reference._plain import strict_f32

    strict_f32()
    ref = reference_module(cfg)
    gs, ms = [], []
    for rec in recs:
        toks, rows, served = _inputs(rec, device)
        margins: List[torch.Tensor] = []
        gs.append(gaps(ref.logits(params, cfg, toks, rows, margins=margins),
                       served))
        ms.append(torch.stack(margins).min(dim=0).values[rows])
    g, m = torch.cat(gs), torch.cat(ms)
    out = []
    for t in ties:
        clear = g[m >= t]
        out.append([t, int(clear.numel()),
                    float(clear.max()) if clear.numel() else 0.0,
                    float(clear.mean()) if clear.numel() else 0.0])
    return {"by_margin": out}
