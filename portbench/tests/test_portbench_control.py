"""The control of ``correct``: the reference computed in fp8, put in the
program's place, has to come out as not correct.  On the CPU at a tiny
size (the mechanism), and marked ``cuda`` at each cell's own size, load
and window, which skips without a card."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_control_fails_where_the_program_passes_tiny(tmp_path):
    bench = tiny.setup(tmp_path)
    res = harness.run_cell(bench, "tiny.chat", 2**31 + 17, 2.0, False,
                           "cpu", time.perf_counter(),
                           config_dir=tmp_path / "configs",
                           traffic_dir=tmp_path / "traffic", control=True,
                           log=lambda *a: None)
    (stat, c), = [(k, v) for k, v in res["checks"].items()
                  if k.startswith("logit_gap")]
    assert res["correct"]
    assert res["control"][stat] > c["max"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limit_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = harness.load_benchmark(ROOT)
    res = harness.run_cell(bench, cell, 2**31 + 101, 20.0, False, "cuda:0",
                           time.perf_counter(), control=True,
                           log=lambda *a: None)
    (stat, c), = [(k, v) for k, v in res["checks"].items()
                  if k.startswith("logit_gap")]
    assert res["correct"], res["checks"]
    assert res["control"][stat] > c["max"]
