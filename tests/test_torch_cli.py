"""The two serve CLIs on the same weights, and the port CLI's flags.

``python -m repro.launch.serve`` draws its reduced model's weights from
``PRNGKey(0)``; torch cannot draw those, so the module fixture writes
them once to an ``.npz`` (``repro_torch.models.weights.save_params_npz``)
and ``python -m repro_torch.launch.serve --params`` serves that file.
For each engine, with and without speculative decoding, both CLIs must
print the same ``[i] prompt -> completion`` lines: the North star's
first condition, equal greedy text.  (Printed text folds invalid UTF-8
into U+FFFD; ``tests/test_torch_spec.py`` compares token ids.)
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.models import reduced_config as jreduced
from repro_torch.launch.serve import main as port_main
from repro_torch.models.weights import save_params_npz

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module")
def params_npz(tmp_path_factory):
    """The reference CLI's weights for ``--arch qwen3-1.7b``, built as it
    builds them (``repro/launch/serve.py``), written to an ``.npz``."""
    cfg = jreduced(jget_config(ARCH))
    cfg = dataclasses.replace(cfg, dtype=jnp.float32, capacity_factor=4.0,
                              vocab_size=max(cfg.vocab_size, 259))
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("cli") / "qwen3-reduced.npz")
    save_params_npz(jax.tree.map(np.asarray, params), path)
    return path


def _completions(module, args):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, "--arch", ARCH,
                          "--max-new", "8"] + args, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[")]
    assert len(lines) == 4 and all(" -> " in ln for ln in lines), out.stdout
    return lines


@pytest.mark.parametrize("engine,flags", [
    ("bucket", []), ("continuous", []), ("async", []),
    ("continuous", ["--spec-decode", "2"]),
    ("async", ["--spec-decode", "2"])])
def test_port_cli_prints_the_reference_cli_text(params_npz, engine, flags):
    want = _completions("repro.launch.serve",
                        ["--engine", engine, "--warmup-steps", "0"] + flags)
    got = _completions("repro_torch.launch.serve",
                       ["--engine", engine, "--device", "cpu", "--params",
                        params_npz] + flags)
    assert got == want


@pytest.mark.parametrize("flags", [
    ["--spec-decode", "2"], ["--metrics-json", "m.json"],
    ["--trace", "t.jsonl"], ["--stats-every", "1"], ["--quant", "q4"],
    ["--kv-dtype", "int8"]])
def test_bucket_engine_refuses_paged_flags(flags, capsys):
    with pytest.raises(SystemExit) as ei:
        port_main(["--arch", ARCH, "--device", "cpu", "--engine", "bucket"]
                  + flags)
    assert ei.value.code == 2
    assert "paged" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--http"], ["--replicas", "2"], ["--tp-shards", "2"],
    ["--warmup-steps", "5"], ["--spec-decode", "-1"]])
def test_unported_and_bad_flags_are_refused(flags):
    with pytest.raises(SystemExit) as ei:
        port_main(["--arch", ARCH, "--device", "cpu", "--engine", "async"]
                  + flags)
    assert ei.value.code == 2


def test_params_of_another_arch_are_refused(params_npz, capsys):
    with pytest.raises(SystemExit) as ei:
        port_main(["--arch", "gemma3-1b", "--device", "cpu", "--engine",
                   "continuous", "--params", params_npz])
    assert ei.value.code == 2
    assert "does not fit" in capsys.readouterr().err


def test_async_cli_writes_valid_metrics_and_trace(params_npz, tmp_path):
    """``--engine async --spec-decode 2 --metrics-json --trace
    --stats-every`` on the CPU; both files pass
    ``python -m repro_torch.obs.validate``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    m, t = str(tmp_path / "m.json"), str(tmp_path / "t.jsonl")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--engine", "async", "--spec-decode", "2",
         "--params", params_npz, "--max-new", "8", "--metrics-json", m,
         "--trace", t, "--stats-every", "0.01"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ttft:" in out.stdout and "throughput:" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", "--metrics", m,
         "--trace", t, "--require-counter", "spec.drafted"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "obs-validate: OK" in out.stdout


def test_interactive_cli_streams_each_prompt(params_npz):
    """``--engine async --interactive`` reads one prompt per stdin line,
    streams each completion on its own line and stops at an empty line.
    (Its text is decoded token by token, so it is not compared with the
    batch CLI's, which decodes a completion whole.)"""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--engine", "async", "--params", params_npz,
         "--max-new", "8", "--interactive"],
        env=env, input="the kv cache streams\na numa node\n\n",
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "interactive async demo" in out.stdout
    replies = out.stdout.split("> ")[1:]
    assert len(replies) == 3                      # two prompts, then quit
    assert all(r.endswith("\n") and len(r) > 1 for r in replies[:2])
    assert "request failed" not in out.stdout
