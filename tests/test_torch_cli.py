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


def _reference_npz(arch, directory):
    """The reference CLI's weights for ``--arch arch``, built as it builds
    them (``repro/launch/serve.py``), written to an ``.npz``."""
    cfg = jreduced(jget_config(arch))
    cfg = dataclasses.replace(cfg, dtype=jnp.float32, capacity_factor=4.0,
                              vocab_size=max(cfg.vocab_size, 259))
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    path = str(directory / f"{arch}-reduced.npz")
    save_params_npz(jax.tree.map(np.asarray, params), path)
    return path


@pytest.fixture(scope="module")
def params_npz(tmp_path_factory):
    return _reference_npz(ARCH, tmp_path_factory.mktemp("cli"))


def _completions(module, args, arch=ARCH):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, "--arch", arch,
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
                        params_npz, "--warmup-steps", "0"] + flags)
    assert got == want


@pytest.mark.parametrize("arch,engine", [
    ("phi3.5-moe-42b-a6.6b", "continuous"), ("mamba2-370m", "bucket")])
def test_port_cli_prints_the_reference_cli_text_for_moe_and_ssd(
        arch, engine, tmp_path):
    """The MoE FFN at the CLI's capacity factor (4.0 in both CLIs, not the
    config's 1.25) through the paged engine, and the SSD stack through
    the bucket engine, on the reference CLI's weights."""
    path = _reference_npz(arch, tmp_path)
    want = _completions("repro.launch.serve",
                        ["--engine", engine, "--warmup-steps", "0"], arch)
    got = _completions("repro_torch.launch.serve",
                       ["--engine", engine, "--device", "cpu", "--params",
                        path, "--warmup-steps", "0"], arch)
    assert got == want


#: the reference CLI with every cross-attention gate of its ``Model.init``
#: weights drawn nonzero (``test_torch_xattn.live_gates``): at the init's
#: zero gates both CLIs would ignore the image or the audio
_REFERENCE_LIVE_GATES = """
import sys
import jax
import numpy as np
import repro.models.transformer as T
from repro.launch.serve import main
from test_torch_xattn import live_gates
_init = T.Model.init
T.Model.init = lambda self, key: jax.tree.map(
    jax.numpy.asarray, live_gates(jax.tree.map(np.asarray, _init(self, key))))
sys.exit(main())
"""


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium"])
def test_port_cli_prints_the_reference_cli_text_for_xattn_and_whisper(
        arch, tmp_path):
    """The cross-attention stack (each request's image stub) and the
    encoder-decoder stack (each request's frame stub) through the bucket
    engine, on the reference CLI's ``PRNGKey(0)`` weights with live
    gates, the same in both CLIs."""
    from test_torch_xattn import live_gates
    cfg = jreduced(jget_config(arch))
    cfg = dataclasses.replace(cfg, dtype=jnp.float32, capacity_factor=4.0,
                              vocab_size=max(cfg.vocab_size, 259))
    tree = live_gates(jax.tree.map(np.asarray, jbuild(cfg).init(
        jax.random.PRNGKey(0))))
    path = str(tmp_path / f"{arch}-live.npz")
    save_params_npz(tree, path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC, os.path.dirname(__file__)]))
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_LIVE_GATES, "--arch", arch,
         "--max-new", "8", "--warmup-steps", "0"], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = [ln for ln in out.stdout.splitlines() if ln.startswith("[")]
    assert len(want) == 4, out.stdout
    got = _completions("repro_torch.launch.serve",
                       ["--device", "cpu", "--params", path,
                        "--warmup-steps", "0"], arch)
    assert got == want


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium"])
def test_continuous_engine_on_xattn_and_whisper_raises_as_the_reference(
        arch, monkeypatch):
    """``--engine continuous``: the paged cache refuses a stack with
    cross-attention, with the reference's error."""
    from repro.launch.serve import main as ref_main
    flags = ["--arch", arch, "--engine", "continuous"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags +
                        ["--warmup-steps", "0"])
    with pytest.raises(NotImplementedError) as want:
        ref_main()
    with pytest.raises(NotImplementedError) as got:
        port_main(flags + ["--device", "cpu", "--warmup-steps", "0"])
    assert str(got.value) == str(want.value)
    assert "paged KV cache requires a uniform self-attention stack" in str(
        got.value)


@pytest.mark.parametrize("engine", ["continuous", "async"])
def test_paged_engines_on_an_ssd_arch_raise_as_the_reference(
        engine, monkeypatch):
    """``--engine continuous|async --arch mamba2-370m``: the paged cache
    refuses a stack that is not self-attention, with the reference's
    error."""
    from repro.launch.serve import main as ref_main
    flags = ["--arch", "mamba2-370m", "--engine", engine]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags +
                        ["--warmup-steps", "0"])
    with pytest.raises(NotImplementedError) as want:
        ref_main()
    with pytest.raises(NotImplementedError) as got:
        port_main(flags + ["--device", "cpu", "--warmup-steps", "0"])
    assert str(got.value) == str(want.value)
    assert "paged KV cache requires a uniform self-attention stack" in str(
        got.value)


def test_cli_and_worker_keep_the_reference_capacity_factors(monkeypatch):
    """The serve CLI builds registry archs at capacity factor 4.0 (the
    reference CLI's), the engine worker at the config's 1.25 (the
    reference worker's)."""
    import repro_torch.serving.worker as worker
    model, _ = worker.build_served("phi3.5-moe-42b-a6.6b", "cpu")
    assert model.cfg.capacity_factor == 1.25
    seen = {}

    def build(arch, device, **kw):
        seen.update(kw, arch=arch)
        raise SystemExit(7)

    monkeypatch.setattr(worker, "build_served", build)
    with pytest.raises(SystemExit) as ei:
        port_main(["--arch", "phi3.5-moe-42b-a6.6b", "--device", "cpu"])
    assert ei.value.code == 7 and seen["capacity_factor"] == 4.0


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
    ["--http", "--interactive"], ["--replicas", "2"], ["--tp-shards", "2"],
    ["--warmup-steps", "-1"], ["--spec-decode", "-1"]])
def test_unported_and_bad_flags_are_refused(flags):
    with pytest.raises(SystemExit) as ei:
        port_main(["--arch", ARCH, "--device", "cpu", "--engine", "async"]
                  + flags)
    assert ei.value.code == 2


@pytest.mark.parametrize("flags", [
    ["--engine", "async", "--replicas", "2"],
    ["--engine", "continuous", "--http"],
    ["--engine", "bucket", "--http", "--replicas", "2"],
    ["--engine", "async", "--http", "--interactive"],
    ["--engine", "async", "--http", "--replicas", "2", "--max-respawns",
     "-1"]])
def test_http_flag_errors_match_the_reference(flags, capsys, monkeypatch):
    """The HTTP flags' argument errors are the reference CLI's, word for
    word (both exit 2 before building anything)."""
    from repro.launch.serve import main as ref_main
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH] + flags)
    with pytest.raises(SystemExit) as ei:
        ref_main()
    assert ei.value.code == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as ei:
        port_main(["--arch", ARCH, "--device", "cpu"] + flags)
    assert ei.value.code == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want and "error: --" in got


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
         "--params", params_npz, "--warmup-steps", "0", "--max-new", "8",
         "--metrics-json", m,
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
         "--warmup-steps", "0", "--max-new", "8", "--interactive"],
        env=env, input="the kv cache streams\na numa node\n\n",
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "interactive async demo" in out.stdout
    replies = out.stdout.split("> ")[1:]
    assert len(replies) == 3                      # two prompts, then quit
    assert all(r.endswith("\n") and len(r) > 1 for r in replies[:2])
    assert "request failed" not in out.stdout


def test_http_cli_serves_through_replicas_and_stops_clean(params_npz,
                                                          tmp_path):
    """``--engine async --http --replicas 2 --device cpu --params X``: the
    front door forwards the weights and the device to both workers, a
    completion over HTTP carries the greedy tokens of an in-process
    engine on the same weights, and SIGTERM stops the front door with
    exit 0 and no worker left behind."""
    import http.client
    import json
    import signal
    import time

    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving import AsyncEngine, Request, SamplingParams
    from repro_torch.serving.worker import build_served

    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--engine", "async", "--http", "--replicas",
         "2", "--params", params_npz, "--port", "0", "--port-file",
         str(port_file)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 240
        while not (port_file.exists() and port_file.read_text()):
            assert proc.poll() is None, proc.stdout.read()
            assert time.time() < deadline, "front door never bound"
            time.sleep(0.1)
        conn = http.client.HTTPConnection("127.0.0.1",
                                          int(port_file.read_text()),
                                          timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "the scheduler binds",
                                 "max_tokens": 8}))
        r = conn.getresponse()
        assert r.status == 200
        choice = json.loads(r.read())["choices"][0]
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["backend"] == "Router" and health["live"] == 2
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "http serving stopped" in out
    pids = [int(ln.rsplit(" pid ", 1)[1]) for ln in out.splitlines()
            if ln.strip().startswith("worker ")]
    assert len(pids) == 2 and not any(
        os.path.exists(f"/proc/{p}") for p in pids), out

    model, params = build_served(ARCH, "cpu", params_path=params_npz)
    with AsyncEngine(model, params, max_len=64, device="cpu") as eng:
        want = eng.result(eng.submit(Request(
            uid=0, prompt=ByteTokenizer().encode("the scheduler binds"),
            sampling=SamplingParams(max_new_tokens=8))), timeout=120)
    assert choice["tokens"] == want.tokens
