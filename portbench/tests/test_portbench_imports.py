"""No module a run loads is JAX's or the JAX package's, and the plain
references load nothing of the program either.  Each check runs in a
fresh interpreter, so other tests' imports cannot hide or cause a hit."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"

MODULES = (["portbench.run", "portbench.harness", "portbench.sweep",
            "portbench.calibrate", "portbench.counts"]
           + [f"portbench.metrics.{p.stem}" for p in
              sorted((PB / "metrics").glob("*.py")) if p.stem != "__init__"]
           + [f"portbench.reference.{p.stem}" for p in
              sorted((PB / "reference").glob("*.py"))
              if p.stem != "__init__"])

PROBE = """
import importlib, sys
sys.path[:0] = [{src!r}, {root!r}]
for m in {mods!r}:
    importlib.import_module(m)
{extra}
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(tops))
"""


def loaded_tops(mods, extra=""):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), mods=mods,
                        extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_run_loads_no_jax_and_no_jax_package():
    # what a run itself imports: the harness, every reader and reference,
    # and the port's serving stack as set-up loads it
    tops = loaded_tops(MODULES, extra=(
        "import repro_torch.serving, repro_torch.models, "
        "repro_torch.models.common"))
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert name not in tops, f"{name} was loaded"
    assert "repro_torch" in tops        # whole names: the port is fine


def test_references_load_nothing_of_the_program():
    refs = [m for m in MODULES if m.startswith("portbench.reference.")]
    refs += ["portbench.counts"]
    tops = loaded_tops(refs)
    for name in ("repro_torch", "repro", "jax"):
        assert name not in tops, f"{name} was loaded"
