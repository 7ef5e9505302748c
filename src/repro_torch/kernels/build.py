"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, then loaded with ``ctypes``.  The
library lands in ``build/kernels/`` at the repository root, named by a
hash of the source and the flags, so a changed source rebuilds and an
unchanged one loads at once.  Nothing is built when this module is
imported: :func:`load` builds on first use, so the package imports on
machines without ``nvcc``.

``nvcc`` is found on ``PATH``, else under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``).  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
#: source name -> lock held while that source builds and loads, so two
#: sources build at once (one nvcc each) and one source builds once
_name_locks: Dict[str, threading.Lock] = {}
#: source name -> (loaded library, build record)
_loaded: Dict[str, Tuple[ctypes.CDLL, Dict[str, object]]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled on the machine with the GPU")


def build(name: str) -> Tuple[Path, Dict[str, object]]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the library path and a record ``{"seconds", "cached",
    "ptxas"}`` (``ptxas`` holds nvcc's register/shared-memory report)."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if lib.exists():
        return lib, {"seconds": 0.0, "cached": True, "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, {"seconds": seconds, "cached": False, "ptxas": proc.stderr}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    Threads loading different sources build them in parallel."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _loaded:
            path, record = build(name)
            _loaded[name] = (ctypes.CDLL(str(path)), record)
        return _loaded[name][0]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the kernel
    wrappers size their split-K grids from it."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def build_record(name: str) -> Dict[str, object]:
    """How ``name`` was built in this process (after :func:`load`)."""
    return _loaded[name][1]
