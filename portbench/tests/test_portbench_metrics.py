"""The metric readers and the trace reduction on records and events made
by hand."""

import math

import pytest
from torch.autograd import DeviceType

from portbench import harness, tracing
from portbench.loadgen import Record
from portbench.metrics import percentile
from portbench.mixes import Req
from portbench.tests import tiny


def test_percentile_is_linear_between_ranks():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile(list(range(101)), 95) == pytest.approx(95)
    assert percentile([1.0, 2.0], 95) == pytest.approx(1.95)
    assert percentile([1.0] * 39 + [math.inf], 95) == pytest.approx(1.0)
    assert percentile([1.0] * 19 + [math.inf], 95) == math.inf
    assert percentile([1.0] * 10 + [math.inf] * 10, 95) == math.inf


def rec(prompt_len, t_start, stamps, out_len=None, t_sched=None,
        group=None, shared=0):
    r = Record(req=Req(0, [1] * prompt_len, out_len or len(stamps),
                       group=group, shared_len=shared), t_start=t_start)
    r.t_submit = t_start
    r.stamps = list(stamps)
    r.tokens = [7] * len(stamps)
    r.t_sched = t_sched
    return r


def make_run(records, **kw):
    zero = {"decode_s": 0.0, "occupancy_sum": 0.0, "occupancy_count": 0,
            "decode_dispatch_ms_sum": 0.0, "decode_dispatch_count": 0}
    after = dict(zero, **kw.pop("after", {}))
    return harness.Run(cfg=tiny.TINY, t_w0=10.0, t_w1=20.0,
                       records=records, before=zero, after=after,
                       setup_s=5.0, **kw)


def test_end_to_end_readers():
    rs = [rec(10, 9.0, [9.5, 10.5, 11.0]),       # due before the window
          rec(10, 12.0, [12.2, 12.4, 12.8]),
          rec(10, 19.0, []),                     # no first token yet
          rec(10, 15.0, [15.5, 21.0])]           # last token after close
    run = make_run(rs)
    read = lambda m: harness.read_metric(m, run)
    assert read("output_tok_s") == pytest.approx(6 / 10)
    # TTFT over the three due in the window: 0.2, 1.0 (its wait so far),
    # 0.5 s
    assert read("ttft_p90_ms_chat") == pytest.approx(
        percentile([200.0, 1000.0, 500.0], 90))
    # gaps with both tokens inside: 0.5, 0.2, 0.4 s (not 9.5 -> 10.5)
    assert read("itl_p95_ms") == pytest.approx(
        percentile([500.0, 200.0, 400.0], 95))
    assert read("itl_p95_ms_chat") == read("itl_p95_ms")
    assert read("setup_s") == 5.0


def test_counter_readers():
    run = make_run([rec(100, 12.0, [12.5])], after={
        "decode_s": 2.0, "occupancy_sum": 400.0, "occupancy_count": 100,
        "decode_dispatch_ms_sum": 300.0, "decode_dispatch_count": 100})
    read = lambda m: harness.read_metric(m, run)
    assert read("decode_step_wall_ms") == pytest.approx(20.0)
    assert read("batch_occupancy_mean") == pytest.approx(4.0)
    assert read("decode_dispatch_ms") == pytest.approx(3.0)


def test_queue_wait_counts_the_still_queued_with_their_wait():
    rs = [rec(5, 11.0, [11.5], t_sched=11.1),
          rec(5, 18.0, [], t_sched=None)]
    run = make_run(rs)
    assert harness.read_metric("queue_wait_p90_ms", run) == pytest.approx(
        percentile([100.0, 2000.0], 90))


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, linked=0, tid=1):
        self._v = (name, dev, start, dur, corr, linked, tid)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return self._v[6]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def events():
    return [
        Ev("portbench.decode#0", CPU, 1000, 1000, corr=1),
        Ev("aten::mm", CPU, 1100, 100, corr=2),
        Ev("cudaLaunchKernel", CPU, 1150, 10, corr=900),
        Ev("cudaLaunchKernel", CPU, 1500, 10, corr=901),
        Ev("gemm", CUDA, 1200, 200, corr=900, linked=2),
        Ev("paged_split_kernel<bf16>", CUDA, 1600, 300, corr=901, linked=1),
        Ev("portbench.decode#0", CUDA, 1200, 700),        # GPU annotation
        Ev("aten::argmax", CPU, 2100, 400, corr=3),
        Ev("cudaLaunchKernel", CPU, 2150, 10, corr=902),
        Ev("argmax_kernel", CUDA, 2300, 100, corr=902, linked=3),
        Ev("portbench.prefill#1:100", CPU, 3000, 1000, corr=4),
        Ev("cuLaunchKernel", CPU, 3100, 10, corr=903),
        Ev("flash", CUDA, 3200, 500, corr=903, linked=4),
    ]


def test_reduce_attributes_each_launch_to_its_range():
    red = tracing.reduce_events(events())
    owners = {op.name: owner for op, owner in red.ops}
    assert owners == {"gemm": 0, "paged_split_kernel<bf16>": 0,
                      "argmax_kernel": None, "flash": 1}
    assert red.attributed == 3
    assert red.window_ns == (1000, 4000)
    assert [h.name for h in red.host] == ["aten::mm", "aten::argmax"]


def test_trace_readers_and_breakdown():
    red = tracing.reduce_events(events())
    r = rec(30, 0.5, [0.9, 1.2])            # one decode token after call 0
    calls = [tracing.Call("decode", 0, 1.0, 1.1, 0),
             tracing.Call("prefill", 1, 1.3, 1.4, 100)]
    run = make_run([r], trace=red, calls=calls)
    run.t_w0, run.t_w1 = 0.0, 2.0
    read = lambda m: harness.read_metric(m, run)
    assert read("decode_device_ms") == pytest.approx(500e-6)
    assert read("prefill_device_ms_per_ktok") == pytest.approx(500e-6 / 0.1)
    # the decode range [1000, 2000) is busy over [1200, 1400) and
    # [1600, 1900): 500 of 1000 ns
    assert read("decode_idle_share") == pytest.approx(50.0)
    from portbench import counts
    least = counts.least_seconds(*counts.paged_attn_least(
        tiny.TINY, [(31, None, 0)]))
    assert read("paged_attn_roofline") == pytest.approx(
        100 * least / 300e-9)
    b = harness.breakdown(red)
    assert b["device_ops"][0][0] == "flash"
    assert b["device_ops"][0][1] == pytest.approx(500e-9)
    idle = dict(b["idle_gaps"])
    # gaps are named by where each begins: 1000-1200, 1400-1600 and
    # 1900-2300 in the decode range, 2400-3200 in aten::argmax's host
    # span, 3700-4000 in the prefill range
    assert idle["decode range"] == pytest.approx(800e-9)
    assert idle["aten::argmax"] == pytest.approx(800e-9)
    assert idle["prefill range"] == pytest.approx(300e-9)


def test_union_clips_and_merges():
    assert tracing.union_ns([(0, 10), (5, 20), (30, 40)], 2, 35) == 23
    assert tracing.union_ns([], 0, 10) == 0
