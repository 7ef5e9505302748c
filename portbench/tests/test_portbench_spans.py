"""The readers of the program's spans (``step_schedule_ms``,
``prefill_idle_share``) and ``decode_launches`` on events made by hand,
the trace reduction with the program's ranges in it, and whole traced
runs on the CPU at a tiny size: with the program's spans, and with a
program that opens none (as a program older than its spans), whose run
leaves both span metrics out."""

import time

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, tracing
from portbench.tests import tiny
from portbench.tests.test_portbench_metrics import (Ev, events, make_run,
                                                    rec)

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
NEW = ("step_schedule_ms", "prefill_idle_share")


def program_events():
    """A step as the program traces it: the phase spans outermost on the
    stepper thread, the benchmark's ranges inside them, the runner's and
    the model's ranges inside those (host only: they are function-scope
    ranges, which leave no copy on the device's timeline)."""
    return [
        Ev("repro_torch.core.schedule", CPU, 500, 100, corr=40),
        Ev("repro_torch.core.schedule", CPU, 2900, 50, corr=41),
        Ev("repro_torch.core.decode", CPU, 990, 1500, corr=42),
        Ev("repro_torch.runner.decode", CPU, 1010, 980, corr=43),
        Ev("repro_torch.model.attn", CPU, 1050, 300, corr=44),
        Ev("repro_torch.core.sample", CPU, 2050, 400, corr=45),
        Ev("repro_torch.core.prefill", CPU, 2980, 1100, corr=46),
        Ev("repro_torch.runner.prefill", CPU, 3050, 900, corr=47),
        Ev("repro_torch.model.ffn", CPU, 3150, 100, corr=48),
    ] + events()


def test_reduction_keeps_its_numbers_with_program_ranges():
    old, new = (tracing.reduce_events(events()),
                tracing.reduce_events(program_events()))
    assert new.ops == old.ops
    assert new.ranges == old.ranges
    assert new.attributed == old.attributed
    # the outermost host operations are now the program's phase spans
    assert [h.name for h in new.host] == [
        "repro_torch.core.schedule", "repro_torch.core.decode",
        "repro_torch.core.schedule", "repro_torch.core.prefill"]


def test_span_readers():
    red = tracing.reduce_events(program_events())
    run = make_run([rec(30, 0.5, [0.9, 1.2])], trace=red)
    read = lambda m: harness.read_metric(m, run)
    # two schedule spans of 100 and 50 ns
    assert read("step_schedule_ms") == pytest.approx(75e-6)
    # the prefill span [2980, 4080) is busy over [3200, 3700): the
    # argmax kernel ends at 2400, before it
    assert read("prefill_idle_share") == pytest.approx(
        100 * (1 - 500 / 1100))
    # idle gaps outside the benchmark's ranges are named by the span
    # they begin in: 500-1200 in the first schedule, 2400-3200 in the
    # decode phase after its sampling
    idle = dict(harness.breakdown(red)["idle_gaps"])
    assert idle["repro_torch.core.schedule"] == pytest.approx(700e-9)
    assert idle["repro_torch.core.decode"] == pytest.approx(800e-9)


def test_span_readers_without_program_spans():
    run = make_run([rec(30, 0.5, [0.9])],
                   trace=tracing.reduce_events(events()))
    for m in NEW:
        assert harness.read_metric(m, run) is None
        assert harness.read_metric(m, make_run([])) is None   # untraced


def test_decode_launches_counts_each_decode_calls_operations():
    """Call 0 launches two kernels, call 2 one copy and call 3 nothing
    (it is left out); the prefill call's kernel and the argmax between
    calls are no decode call's."""
    evs = events() + [
        Ev("portbench.decode#2", CPU, 5000, 500, corr=5),
        Ev("cudaMemcpyAsync", CPU, 5100, 10, corr=904),
        Ev("Memcpy HtoD (Pageable -> Device)", CUDA, 5200, 50, corr=904),
        Ev("portbench.decode#3", CPU, 6000, 200, corr=6),
    ]
    red = tracing.reduce_events(evs)
    run = make_run([rec(30, 0.5, [0.9])], trace=red)
    assert harness.read_metric("decode_launches", run) == pytest.approx(1.5)
    run = make_run([rec(30, 0.5, [0.9])],
                   trace=tracing.reduce_events(events()[:1]))
    assert harness.read_metric("decode_launches", run) is None
    assert harness.read_metric("decode_launches", make_run([])) is None


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced_run(tmp_path, cell):
    bench = tiny.setup(tmp_path)
    return harness.run_cell(bench, cell, 2**31 + 29, 2.0, True, "cpu",
                            time.perf_counter(),
                            config_dir=tmp_path / "configs",
                            traffic_dir=tmp_path / "traffic",
                            log=lambda *a: None)


def test_tiny_traced_run_reports_the_span_metrics(tmp_path, few_threads):
    res = traced_run(tmp_path, "tiny-moe.chat")
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert 0 < got["step_schedule_ms"]["value"] < 1e3
    # no device operation on the CPU: every prefill span reads idle
    assert got["prefill_idle_share"]["value"] == pytest.approx(100.0)


def test_traced_run_of_a_program_without_spans_leaves_them_out(
        tmp_path, few_threads, monkeypatch):
    from repro_torch.obs import spans
    monkeypatch.setattr(spans, "_thread_profiling", lambda: False)
    res = traced_run(tmp_path, "tiny.chat")
    assert res["correct"], res["checks"]
    for m in NEW:
        assert m not in res["metrics"]
    assert "decode_step_wall_ms" in res["metrics"]
