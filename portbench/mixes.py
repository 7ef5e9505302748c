"""The one traffic generator: turns a mix's data file
(``portbench/traffic/<mix>.json``) and a seed into the requests of a run.

A mix states its loop and its distributions:

* ``"loop": "open"`` with ``rate_per_s``, ``arrival_seed`` and optionally
  ``burstiness`` (:func:`arrival_gaps`), or ``"closed"`` with ``clients``
  (each sends its next request when its last one completes);
* ``ramp_s``: seconds of traffic before the measured window opens;
* ``prompt`` and ``output``: lengths in tokens, ``{"median", "sigma",
  "min", "max"}`` for a lognormal clipped to [min, max], or ``{"min",
  "max"}`` for a uniform one;
* optionally ``documents`` (``count``, ``min``, ``max``, ``zipf_s``):
  each prompt is then a document, drawn with Zipf popularity, followed
  by a question of ``question`` length; every document is asked once in
  set-up (``warm``), so its prefix is cached before the window;
* ``check_requests``: how many finished requests the output check reads;
* ``source``: where the lengths and the arrival process come from.

Open-loop arrivals are one sample path, drawn from the mix's
``arrival_seed`` and replayed in every run, as a recorded trace's
timestamps would be: its bursts are those of real draws, the same under
every seed.  Every seed gets the same set of lengths and document choices
(stratified quantiles of each distribution), in an order and with tokens
that the seed draws: a seed changes which request comes when, not how
much work the run holds.  The order is blocked (:func:`blocked`): every
``BLOCK`` consecutive requests hold one value from each of ``BLOCK``
strata of each distribution, so any stretch of the stream, such as the
measured window, holds nearly the same work under every seed.  Tokens are
uniform over the vocabulary; documents are drawn from the seed alone, so
they do not depend on the rate or the window's length.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
#: requests a closed-loop client can take in a run, at most
CLOSED_POOL_PER_CLIENT = 64
#: open loop: arrivals generated past the window's end, as a share
OPEN_MARGIN = 0.5
#: strata a block of consecutive requests takes one value from each of
BLOCK = 16


@dataclasses.dataclass
class Req:
    """One request as the traffic states it."""

    idx: int
    prompt: List[int]
    out_len: int
    #: seconds after the traffic starts when it is due (open loop)
    due: Optional[float] = None
    #: prefix group (a document) and the length of the prefix the group
    #: shares, for the counts of least bytes
    group: Optional[int] = None
    shared_len: int = 0


@dataclasses.dataclass
class Traffic:
    loop: str
    requests: List[Req]
    ramp_s: float
    clients: int = 0
    rate_per_s: float = 0.0
    #: requests the set-up sends before the traffic starts
    warm: List[Req] = dataclasses.field(default_factory=list)
    check_requests: int = 8
    #: each distribution's stated parameters and the quantiles drawn
    described: Dict[str, str] = dataclasses.field(default_factory=dict)


def load_mix(name: str, directory: Path = TRAFFIC_DIR) -> Dict:
    with open(directory / f"{name}.json") as f:
        return json.load(f)


def _stratified(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths at stratified quantiles of the spec's distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    u = _stratified(n)
    if "median" in spec:
        nd = statistics.NormalDist()
        z = np.array([nd.inv_cdf(p) for p in u])
        vals = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    else:
        vals = lo + u * (hi - lo)
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def arrival_gaps(rate: float, n: int, seed: int,
                 burstiness: float = 1.0) -> np.ndarray:
    """The first ``n`` gaps of one arrival path: independent gamma draws
    from ``seed`` with shape ``burstiness`` and mean ``1 / rate``.  A
    shape of 1 gives exponential gaps, Poisson arrivals; a smaller one
    gives burstier arrivals (coefficient of variation 1 / sqrt(shape)).
    The path is drawn at unit rate and scaled, so every rate replays the
    same bursts, and its first gaps do not depend on ``n``."""
    rng = np.random.default_rng(seed)
    return rng.gamma(burstiness, 1.0 / burstiness, n) / rate


def zipf_picks(count: int, s: float, n: int) -> np.ndarray:
    """``n`` ranks in [0, count) at stratified quantiles of the Zipf law
    with exponent ``s``."""
    w = 1.0 / np.arange(1, count + 1) ** s
    cdf = np.cumsum(w / w.sum())
    return np.minimum(np.searchsorted(cdf, _stratified(n)), count - 1)


def blocked(values: np.ndarray, rng: np.random.Generator,
            block: int = BLOCK) -> np.ndarray:
    """``values`` (ascending) in an order drawn from ``rng`` in which each
    run of ``block`` consecutive entries holds one entry of each of
    ``block`` strata (consecutive slices of the sorted values), in random
    order within the run; a last, shorter run takes what is left."""
    n = len(values)
    strata = [rng.permutation(s) for s in
              np.array_split(np.arange(n), min(block, n))]
    order = []
    for j in range(max(len(s) for s in strata)):
        order.extend(rng.permutation([s[j] for s in strata if j < len(s)]))
    return values[np.array(order, dtype=np.int64)]


def describe(name: str, spec: Dict, vals: np.ndarray) -> str:
    q = np.percentile(vals, [0, 5, 50, 95, 100])
    return (f"{name} {spec}: n {len(vals)}, min/p5/p50/p95/max "
            + "/".join(f"{v:.0f}" for v in q) + f", mean {vals.mean():.1f}")


def build(mix: Dict, vocab: int, seed: int, seconds: float) -> Traffic:
    """The requests of one run of ``mix`` at ``seed``."""
    rng = np.random.default_rng(seed)
    loop = mix["loop"]
    ramp = float(mix["ramp_s"])
    if loop == "open":
        rate = float(mix["rate_per_s"])
        n = int(math.ceil(rate * (ramp + seconds) * (1 + OPEN_MARGIN))) + 8
    elif loop == "closed":
        rate = 0.0
        n = int(mix["clients"]) * CLOSED_POOL_PER_CLIENT
    else:
        raise ValueError(f"loop {loop!r}: choose 'open' or 'closed'")
    out = lengths(mix["output"], n)
    described = {"output": describe("output", mix["output"], out)}
    out = blocked(out, rng)
    reqs: List[Req] = []
    warm: List[Req] = []
    docs = mix.get("documents")
    if docs:
        count = int(docs["count"])
        # lengths over the documents in a fixed order, not one the seed
        # draws: popular documents are as long under every seed
        doc_len = lengths(docs, count)
        doc_len = doc_len[(np.arange(count) * 13) % count]
        doc_rng = np.random.default_rng([seed, 3])
        doc_tok = [doc_rng.integers(0, vocab, int(m)).tolist()
                   for m in doc_len]
        picks = blocked(zipf_picks(count, float(docs["zipf_s"]), n), rng)
        q_len = blocked(lengths(mix["question"], n), rng)
        described["documents"] = describe("documents", docs, doc_len)
        described["question"] = describe("question", mix["question"], q_len)
        for i in range(n):
            d = int(picks[i])
            q = rng.integers(0, vocab, int(q_len[i])).tolist()
            reqs.append(Req(i, doc_tok[d] + q, int(out[i]), group=d,
                            shared_len=len(doc_tok[d])))
        q_min = int(mix["question"]["min"])
        for d in range(count):
            q = doc_rng.integers(0, vocab, q_min).tolist()
            warm.append(Req(-1 - d, doc_tok[d] + q, 1, group=d,
                            shared_len=len(doc_tok[d])))
    else:
        p_len = lengths(mix["prompt"], n)
        described["prompt"] = describe("prompt", mix["prompt"], p_len)
        p_len = blocked(p_len, rng)
        flat = rng.integers(0, vocab, int(p_len.sum()))
        ends = np.cumsum(p_len)
        for i in range(n):
            reqs.append(Req(i, flat[ends[i] - p_len[i]:ends[i]].tolist(),
                            int(out[i])))
    if loop == "open":
        due = np.cumsum(arrival_gaps(rate, n, int(mix["arrival_seed"]),
                                     float(mix.get("burstiness", 1.0))))
        described["arrivals"] = (
            f"arrivals {mix.get('burstiness', 1.0)}-shape gamma gaps at "
            f"{rate} req/s from arrival_seed {mix['arrival_seed']}: "
            f"{int(np.sum(due < ramp))} in the ramp, "
            f"{int(np.sum((due >= ramp) & (due < ramp + seconds)))} in the "
            f"window")
        for r, t in zip(reqs, due):
            r.due = float(t)
    return Traffic(loop=loop, requests=reqs, ramp_s=ramp,
                   clients=int(mix.get("clients", 0)), rate_per_s=rate,
                   warm=warm, check_requests=int(mix["check_requests"]),
                   described=described)
