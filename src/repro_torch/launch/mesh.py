"""Meshes over a ``torch.distributed`` process group.

The reference's mesh (``repro.launch.mesh``) is a grid of JAX devices
inside one process.  The port's shard is a **rank** of a process group:
a :class:`Mesh` names the axes of that group (``"model"`` is the
NUMA-node analogue the paper's §3.2 weight partitions live on,
``"data"`` carries the batch), lays the ranks out on them row-major, and
holds one process group per axis whose size is above 1.  Collectives
take their group from the mesh, so the backend is whatever the caller's
``init_process_group`` chose: gloo on the CPU and for ranks that share
one GPU, NCCL for a group with a GPU per rank.

An :class:`AbstractMesh` has axis names and sizes and no process group
(the reference's ``jax.sharding.AbstractMesh``): the spec functions of
``launch.shardings`` and the dry run (``launch.specs``, ``launch.dryrun``)
read one, and :func:`make_production_mesh` returns the reference's two
production layouts as abstract meshes.

The hardware constants below are one NVIDIA H100 SXM's and its links'
(the reference's are TPU v5e numbers, and none of them is kept).  A
mesh's ranks are laid out row-major over its axes, the last axis
innermost, and rank ``r`` sits on node ``r // GPUS_PER_NODE``.  The
collective term of an axis uses the **slowest link the axis spans**
(:func:`axis_link_bw`): an axis whose every line of ranks lies inside
one node runs over NVLink, any other over InfiniBand.  So with the
model axis innermost, a 16-way ``model`` axis crosses two nodes of 8 and
runs at the InfiniBand rate, as does every axis outside it.

Building a mesh touches no device and starts no process;
:func:`init_group` joins a group, :func:`run_ranks` starts one whose
ranks are all fresh ``spawn`` interpreters (tests, ``chip_smoke.py``),
and :func:`lead_ranks` one whose rank 0 is the calling process (the
CLIs' ``--tp-shards`` / ``--devices``).
"""

from __future__ import annotations

import math
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps each axis name to its size (``mesh.shape.get("model",
    1)`` is the tensor-parallel degree, as on a JAX mesh); ``rank`` is
    this process's rank; :meth:`axis_index` its coordinate on an axis and
    :meth:`group` the process group of the ranks that differ from it
    only on that axis (None for an axis of size 1: nothing to reduce).
    """

    def __init__(self, axis_names: Tuple[str, ...], sizes: Tuple[int, ...],
                 rank: int, groups: Dict[str, Any]) -> None:
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, sizes))
        self.rank = rank
        self._groups = groups

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_index(self, axis: Any) -> int:
        """This rank's coordinate on ``axis`` (ranks are laid out
        row-major over ``axis_names``); for a tuple of axes, the
        row-major index over them (JAX's ``axis_index`` of a tuple)."""
        if not isinstance(axis, str):
            idx = 0
            for a in axis:
                idx = idx * self.shape[a] + self.axis_index(a)
            return idx
        i = self.axis_names.index(axis)
        stride = math.prod(self.shape[a] for a in self.axis_names[i + 1:])
        return (self.rank // stride) % self.shape[axis]

    def group(self, axis: Any) -> Any:
        """The process group of ``axis``; for a tuple of axes, the group
        of the one axis of size above 1 among them, or the whole world
        when they are every such axis of the mesh."""
        if isinstance(axis, str):
            return self._groups.get(axis)
        live = [a for a in axis if self.shape.get(a, 1) > 1]
        if len(live) <= 1:
            return self._groups.get(live[0]) if live else None
        if math.prod(self.shape[a] for a in live) == self.size:
            return dist.group.WORLD
        raise ValueError(f"no process group spans axes {tuple(axis)} of "
                         f"{self!r}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over the default process group, whose world
    size must be ``prod(shape)``; a one-rank mesh needs no group.  Every
    rank must call it, in the same order as its other group calls: an
    axis that spans part of the world gets its own ``new_group`` per
    line of ranks."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name axes {axes}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks; "
            f"the process group has {world}")
    groups: Dict[str, Any] = {}
    for i, (axis, size) in enumerate(zip(axes, shape)):
        if size == 1:
            continue
        if size == world:
            groups[axis] = dist.group.WORLD
            continue
        me = _coords(rank, shape)
        lines: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(world):
            c = _coords(r, shape)
            lines.setdefault(c[:i] + c[i + 1:], []).append(r)
        for key in sorted(lines):             # same order on every rank
            g = dist.new_group(lines[key])
            if key == me[:i] + me[i + 1:]:
                groups[axis] = g
    return Mesh(axes, tuple(shape), rank, groups)


def make_host_mesh(model: int = 1, data: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over however many ranks the process
    group has (the reference's ``make_host_mesh``: sizes clamped to the
    ranks there are)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = min(model, n)
    data = max(min(data, n // model), 1)
    return make_mesh((data, model), ("data", "model"))


def data_axes(mesh: Any) -> Tuple[str, ...]:
    """The batch-carrying axes of a mesh ('pod' included when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ----------------------------------------------------------------------
# abstract meshes and the hardware they stand for
# ----------------------------------------------------------------------

#: dense bf16 tensor-core peak of one H100 SXM at its 700 W limit (NVIDIA
#: H100 data sheet)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth of one H100 SXM, bytes/s (the same data sheet)
HBM_BW = 3.35e12
#: device memory of one H100 SXM: 80 GB (the same data sheet)
HBM_PER_CHIP = 80e9
#: GPUs a node: one DGX H100 (8 H100 SXM joined all to all by NVSwitch)
GPUS_PER_NODE = 8
#: one pod: a DGX SuperPOD scalable unit, 32 DGX H100 nodes x 8 GPUs
CHIPS_PER_POD = 256
#: NVLink 4 inside a node: 18 links x 25 GB/s each way = 450 GB/s a GPU
#: each way (900 GB/s both ways; DGX H100 data sheet)
NVLINK_BW = 450e9
#: across nodes: one ConnectX-7 NDR InfiniBand port a GPU, 400 Gb/s =
#: 50 GB/s each way (DGX H100 data sheet)
IB_BW = 50e9


class AbstractMesh:
    """Axis names and sizes, no process group and no rank: what the spec
    functions and the dry run read (``shape``, ``axis_names``, ``size``),
    as the reference's read a jax ``Mesh`` / ``AbstractMesh``."""

    def __init__(self, shape: Tuple[int, ...],
                 axes: Tuple[str, ...]) -> None:
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} does not name axes {axes}")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production layouts: (16, 16) ``("data", "model")``
    (one pod of :data:`CHIPS_PER_POD`) or (2, 16, 16) ``("pod", "data",
    "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def axis_link_bw(mesh: Any, axes: Any) -> float:
    """Bytes/s a device moves in a collective over ``axes`` (a name or a
    tuple of names): :data:`NVLINK_BW` when every line of ranks along
    them lies inside one node of :data:`GPUS_PER_NODE`, else
    :data:`IB_BW` (the slowest link spanned; module docstring)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = mesh.axis_names
    sizes = [mesh.shape[a] for a in names]
    lines: Dict[Tuple[int, ...], set] = {}
    for r in range(math.prod(sizes)):
        c = _coords(r, sizes)
        key = tuple(x for a, x in zip(names, c) if a not in axes)
        lines.setdefault(key, set()).add(r // GPUS_PER_NODE)
    return NVLINK_BW if all(len(n) == 1 for n in lines.values()) else IB_BW


# ----------------------------------------------------------------------
# process groups
# ----------------------------------------------------------------------

def init_group(rank: int, world_size: int, init_method: str, *,
               backend: str = "gloo") -> None:
    """Join the default process group.  ``init_method`` is a
    ``file://`` path every rank can reach (what tests and the CLIs use:
    no port to collide with) or a ``tcp://host:port`` address."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def _rank_entry(fn: Callable, rank: int, world_size: int, init_method: str,
                out_path: str, threads: Optional[int], backend: str,
                args: Tuple) -> None:
    try:
        if threads:
            # ranks that share a host's cores: parallel CPU ops of one
            # rank spin against the others' otherwise
            torch.set_num_threads(threads)
        init_group(rank, world_size, init_method, backend=backend)
        try:
            result = ("ok", fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # noqa: BLE001 — reported
        result = ("error", traceback.format_exc())   # to the parent
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    if result[0] != "ok":
        raise SystemExit(1)             # a nonzero exit code: see run_ranks


def run_ranks(fn: Callable, world_size: int, args: Tuple = (), *,
              timeout: float = 120.0, threads: Optional[int] = 1,
              backend: str = "gloo") -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` fresh
    ``spawn`` processes joined in one process group (a ``file://``
    store in a temporary directory) and return their results in rank
    order.  ``fn`` must be importable by name, and its results
    picklable (host values, not CUDA tensors).  A rank that raises, or
    a group that has not finished within ``timeout`` seconds (every
    rank is then killed), raises ``RuntimeError`` here."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks-")
    try:
        init = "file://" + os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, world_size, init, outs[r],
                                   threads, backend, tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        # a rank that failed leaves the others waiting in a collective:
        # stop waiting at the first failure, or at the deadline
        deadline = time.monotonic() + timeout
        while (any(p.is_alive() for p in procs)
               and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(
                    f"rank {r} of {world_size} "
                    + ("did not finish within "
                       f"{timeout:.0f} s" if r in hung else
                       f"exited with code {procs[r].exitcode} and no "
                       "result"))
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {world_size} raised:\n"
                                   f"{value}")
            results.append(value)
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _led_rank(target: Callable, argv: List[str], rank: int, world_size: int,
              init_method: str) -> None:
    sys.stdout = open(os.devnull, "w")          # rank 0 reports
    sys.exit(target(argv, rank, world_size, init_method))


def lead_ranks(target: Callable, argv: List[str], world_size: int) -> int:
    """One command, ``world_size`` ranks: run ``target(argv, rank,
    world_size, init_method)`` here as rank 0 and in ``world_size - 1``
    fresh ``spawn`` interpreters as the other ranks (their standard
    output dropped), all meeting at a ``file://`` store in a temporary
    directory.  ``target`` must be importable by name and return an
    exit code.  Returns rank 0's, or 1 if another rank failed (a rank
    left waiting after rank 0 ended is killed)."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks-")
    init = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_led_rank,
                         args=(target, list(argv), r, world_size, init))
             for r in range(1, world_size)]
    try:
        for p in procs:
            p.start()
        rc = target(list(argv), 0, world_size, init)
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():        # waiting in a collective that never
                p.kill()            # comes: rank 0 failed
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = {r: p.exitcode for r, p in enumerate(procs, 1) if p.exitcode}
    if bad:
        print(f"ranks failed (rank: exit code): {bad}", file=sys.stderr)
        return 1
    return rc
