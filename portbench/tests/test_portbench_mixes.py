"""The traffic generator: reproducible from the seed, the same work under
every seed, and the stated distributions kept; for each mix of
``portbench/traffic`` and for the tests' shared-document mix."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import mixes
from portbench.tests import tiny

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
#: the documents mix of the tests, at lengths a served cell would send
RAG = dict(tiny.MIXES["rag"], rate_per_s=2.4, ramp_s=12,
           documents={"count": 32, "min": 1024, "max": 6144, "zipf_s": 1.0},
           question={"min": 32, "max": 128},
           output={"median": 48, "sigma": 0.6, "min": 16, "max": 128})
MIX_NAMES = sorted(p.stem for p in TRAFFIC.glob("*.json")) + ["rag"]


def load(name):
    if name == "rag":
        return RAG
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIX_NAMES)
def test_same_seed_same_requests(name):
    a = mixes.build(load(name), 32064, 2**31 + 77, 30)
    b = mixes.build(load(name), 32064, 2**31 + 77, 30)
    assert [(r.prompt, r.out_len, r.due) for r in a.requests] == \
        [(r.prompt, r.out_len, r.due) for r in b.requests]
    assert [r.prompt for r in a.warm] == [r.prompt for r in b.warm]


@pytest.mark.parametrize("name", MIX_NAMES)
def test_seeds_differ_in_order_not_in_work(name):
    a = mixes.build(load(name), 32064, 1, 30)
    b = mixes.build(load(name), 32064, 2, 30)
    assert [r.prompt for r in a.requests] != [r.prompt for r in b.requests]
    # a document and its question are drawn apart: compare each
    assert sorted(r.shared_len for r in a.requests) == \
        sorted(r.shared_len for r in b.requests)
    assert sorted(len(r.prompt) - r.shared_len for r in a.requests) == \
        sorted(len(r.prompt) - r.shared_len for r in b.requests)
    assert sorted(r.out_len for r in a.requests) == \
        sorted(r.out_len for r in b.requests)
    if a.loop == "open":               # one arrival path, every seed
        assert [r.due for r in a.requests] == [r.due for r in b.requests]


@pytest.mark.parametrize("name", MIX_NAMES)
def test_stated_distributions(name):
    mix = load(name)
    t = mixes.build(mix, 151936, 3, 30)
    out = np.array([r.out_len for r in t.requests])
    spec = mix["output"]
    assert out.min() >= spec["min"] and out.max() <= spec["max"]
    assert abs(np.median(out) - spec["median"]) <= 1
    assert all(0 <= tok < 151936 for r in t.requests[:20] for tok in r.prompt)
    if "prompt" in mix:
        p = np.array([len(r.prompt) for r in t.requests])
        ps = mix["prompt"]
        assert p.min() >= ps["min"] and p.max() <= ps["max"]
        mid = ps.get("median", (ps["min"] + ps["max"]) / 2)
        assert abs(np.median(p) - mid) <= 0.01 * mid + 1
    if mix["loop"] == "open":
        due = np.array([r.due for r in t.requests])
        np.testing.assert_allclose(np.diff(due, prepend=0.0),
                                      mixes.arrival_gaps(
                                          mix["rate_per_s"], len(due),
                                          mix["arrival_seed"],
                                          mix.get("burstiness", 1.0)))
        assert due[-1] > mix["ramp_s"] + 30
    else:
        assert t.clients == mix["clients"]


def test_documents_zipf_and_shared_prefix():
    mix = load("rag")
    t = mixes.build(mix, 151936, 4, 30)
    docs = mix["documents"]
    assert len(t.warm) == docs["count"]
    counts = np.bincount([r.group for r in t.requests],
                         minlength=docs["count"])
    # Zipf s = 1: the most popular document about twice the second
    assert counts[0] == counts.max()
    assert counts[0] / counts[1] == pytest.approx(2.0, rel=0.25)
    for r in t.requests[:50]:
        w = t.warm[r.group]
        assert r.prompt[:r.shared_len] == w.prompt[:w.shared_len]
        q = len(r.prompt) - r.shared_len
        assert mix["question"]["min"] <= q <= mix["question"]["max"]
        assert docs["min"] <= r.shared_len <= docs["max"]


@pytest.mark.parametrize("shape", [1.0, 0.5])
def test_arrival_gaps_are_gamma_draws_of_the_stated_rate(shape):
    g = mixes.arrival_gaps(2.5, 20000, 7, shape)
    assert g.mean() == pytest.approx(1 / 2.5, rel=0.03)
    # coefficient of variation 1 / sqrt(shape): 1 for Poisson arrivals
    assert g.std() / g.mean() == pytest.approx(shape ** -0.5, rel=0.05)
    # not smoothed: runs of short gaps (bursts) occur as in independent
    # draws, e.g. four gaps in a row under a quarter of the mean
    short = g < 0.25 * g.mean()
    runs = np.sum(short[:-3] & short[1:-2] & short[2:-1] & short[3:])
    p = np.mean(short)
    assert runs == pytest.approx(len(g) * p ** 4, rel=0.35)
    # the same path at every rate and length: a prefix, scaled
    np.testing.assert_allclose(mixes.arrival_gaps(5.0, 100, 7, shape),
                               g[:100] / 2)


def test_lengths_are_stratified_quantiles():
    spec = {"median": 100, "sigma": 0.5, "min": 10, "max": 1000}
    v = mixes.lengths(spec, 1001)
    assert v[500] == 100
    assert list(v) == sorted(v)


def test_blocked_order_keeps_every_stretch_alike():
    rng = np.random.default_rng(0)
    vals = mixes.lengths({"median": 128, "sigma": 0.7, "min": 32,
                          "max": 512}, 320)
    order = mixes.blocked(vals, rng)
    assert sorted(order) == sorted(vals)
    strata = np.array_split(np.sort(vals), mixes.BLOCK)
    edges = [s[-1] for s in strata]
    for b in range(0, 320, mixes.BLOCK):
        blk = order[b:b + mixes.BLOCK]
        # one value from each stratum: the j-th smallest of the block is
        # at most stratum j's largest
        assert all(v <= e for v, e in zip(sorted(blk), edges))
    # any 64 consecutive requests hold the mean work far closer than a
    # plain shuffle does
    def swing(seq):
        means = [seq[i:i + 64].mean() for i in range(0, 320 - 64, 3)]
        return max(means) / min(means)

    plain = max(swing(np.random.default_rng(s).permutation(vals))
                for s in range(5))
    assert swing(order) < 1.15 < plain


def test_documents_do_not_depend_on_rate_or_window():
    mix = load("rag")
    a = mixes.build(mix, 151936, 9, 30)
    b = mixes.build(dict(mix, rate_per_s=2 * mix["rate_per_s"]), 151936, 9,
                    50)
    assert [r.prompt for r in a.warm] == [r.prompt for r in b.warm]
