"""Worker-process supervisor for multi-replica serving.

The port's counterpart of ``repro.serving.supervisor``.  Spawns N
``python -m repro_torch.serving.worker`` subprocesses (each a private
``AsyncEngine`` + KV page pool, and on the GPU its own CUDA context,
behind its own HTTP port), waits for each one's ``READY port=<N>``
handshake line, and hands back
:class:`~repro_torch.serving.router.HttpWorkerClient` objects keyed by
replica id for the :class:`~repro_torch.serving.router.Router`.

A monitor thread polls the children; a worker that exits while the
supervisor is live (crash, OOM-kill, a fault drill's SIGKILL) fires
``on_death(rid, returncode)`` exactly once — the launcher wires that
straight to ``Router.mark_dead`` so the dead replica drains from the
affinity ring while its in-flight connections surface their own errors.
With ``max_respawns > 0`` the monitor then **heals the fleet**: it
respawns the dead replica (bounded attempts, linear backoff), waits out
the fresh READY handshake, and fires ``on_respawn(rid, client)`` —
wired to :meth:`~repro_torch.serving.router.Router.readmit`, which puts
the replica back in the affinity ring.  A replica that keeps dying stays
dead once its attempts are spent.  ``shutdown()`` is SIGTERM -> bounded
wait -> SIGKILL, and every child is reaped, pre-respawn corpses
included, so no worker outlives it.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .router import HttpWorkerClient


class WorkerStartupError(RuntimeError):
    """A worker exited or went silent before its READY handshake."""


def _worker_env() -> Dict[str, str]:
    """Child env whose ``PYTHONPATH`` can resolve ``repro_torch`` exactly
    as this process does (repo src layout or installed — either way the
    package's parent directory is on the path)."""
    env = dict(os.environ)
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_parent, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


class Supervisor:
    """Owns N engine-worker subprocesses for one serving deployment.

    ``worker_args`` is the CLI tail forwarded to every worker (arch and
    engine knobs, e.g. ``["--arch", "tiny", "--max-running", "4"]``);
    each worker additionally gets ``--host``/``--port 0`` and its own
    ephemeral port is read back from the handshake.
    """

    def __init__(self, n_replicas: int,
                 worker_args: Optional[List[str]] = None, *,
                 host: str = "127.0.0.1", ready_timeout: float = 180.0,
                 on_death: Optional[Callable[[int, int], None]] = None,
                 max_respawns: int = 0, respawn_backoff: float = 0.5,
                 on_respawn: Optional[
                     Callable[[int, HttpWorkerClient], None]] = None,
                 ) -> None:
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        if max_respawns < 0:
            raise ValueError("max_respawns must be >= 0")
        self.n_replicas = n_replicas
        self.worker_args = list(worker_args or [])
        self.host = host
        self.ready_timeout = ready_timeout
        self.on_death = on_death
        #: restart budget *per replica*; 0 keeps the legacy
        #: notify-only behaviour (dead replicas stay dead)
        self.max_respawns = max_respawns
        self.respawn_backoff = respawn_backoff
        self.on_respawn = on_respawn
        self.procs: Dict[int, subprocess.Popen] = {}
        self.clients: Dict[int, HttpWorkerClient] = {}
        #: trailing stdout lines per worker, for death diagnostics
        self._tails: Dict[int, collections.deque] = {}
        self._lock = threading.Lock()
        self._notified: set = set()
        self._respawns: Dict[int, int] = {}     # attempts burned per rid
        self._retired: List[subprocess.Popen] = []  # pre-respawn corpses
        self._closing = False
        self._monitor: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> Dict[int, HttpWorkerClient]:
        """Spawn all replicas, block until every handshake lands (or
        raise, reaping whatever started)."""
        try:
            for rid in range(self.n_replicas):
                self._spawn(rid)
            for rid in range(self.n_replicas):
                port = self._await_ready(rid)
                self.clients[rid] = HttpWorkerClient(
                    self.host, port, proc=self.procs[rid])
        except BaseException:
            self.shutdown()
            raise
        self._monitor = threading.Thread(target=self._watch,
                                         name="worker-monitor",
                                         daemon=True)
        self._monitor.start()
        return dict(self.clients)

    def _spawn(self, rid: int) -> None:
        cmd = [sys.executable, "-m", "repro_torch.serving.worker",
               "--host", self.host, "--port", "0", *self.worker_args]
        self.procs[rid] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=_worker_env(), text=True)
        self._tails[rid] = collections.deque(maxlen=20)

    def _await_ready(self, rid: int) -> int:
        """Read the worker's stdout until ``READY port=N`` (the model
        build + first bind happen here), then hand the pipe to a drain
        thread so the child never blocks on a full pipe buffer."""
        proc = self.procs[rid]
        deadline = time.monotonic() + self.ready_timeout
        while True:
            if time.monotonic() > deadline:
                raise WorkerStartupError(
                    f"worker {rid} not READY within "
                    f"{self.ready_timeout} s; last output: "
                    f"{list(self._tails[rid])}")
            line = proc.stdout.readline()
            if not line:
                raise WorkerStartupError(
                    f"worker {rid} exited before READY "
                    f"(rc={proc.wait()}); output: "
                    f"{list(self._tails[rid])}")
            line = line.strip()
            self._tails[rid].append(line)
            if line.startswith("READY port="):
                port = int(line.split("=", 1)[1])
                threading.Thread(target=self._drain, args=(rid, proc),
                                 name=f"worker-{rid}-drain",
                                 daemon=True).start()
                return port

    def _drain(self, rid: int, proc: subprocess.Popen) -> None:
        for line in proc.stdout:
            self._tails[rid].append(line.strip())

    # ------------------------------------------------------------------
    def _watch(self) -> None:
        while not self._closing:
            for rid, proc in list(self.procs.items()):
                rc = proc.poll()
                if rc is None:
                    continue
                if self.on_death is None and self.max_respawns <= 0:
                    # no callback attached yet: stay un-notified so a
                    # late-bound callback still hears about this death
                    continue
                with self._lock:
                    if self._closing or rid in self._notified:
                        continue
                    self._notified.add(rid)
                if self.on_death is not None:
                    self.on_death(rid, rc)
                if self.max_respawns > 0:
                    self._respawn_one(rid)
            time.sleep(0.05)

    def _respawn_one(self, rid: int) -> None:
        """Heal one dead replica: bounded attempts with linear backoff,
        each a full spawn + READY handshake.  On success the fresh
        client replaces ``clients[rid]``, ``on_respawn`` re-admits the
        replica upstream, and the rid is un-notified so a *later* death
        fires ``on_death`` again.  Attempts spent -> the replica stays
        dead (rid stays notified, so the monitor stops retrying)."""
        while True:
            with self._lock:
                if self._closing:
                    return
                if self._respawns.get(rid, 0) >= self.max_respawns:
                    return          # budget spent: stays dead
                self._respawns[rid] = self._respawns.get(rid, 0) + 1
                attempt = self._respawns[rid]
            time.sleep(self.respawn_backoff * attempt)
            if self._closing:
                return
            # keep the corpse for shutdown() to close its pipe; it is
            # already reaped (poll() returned), so no zombie risk
            self._retired.append(self.procs[rid])
            try:
                self._spawn(rid)
                port = self._await_ready(rid)
            except WorkerStartupError:
                continue            # attempt burned; back off and retry
            client = HttpWorkerClient(self.host, port,
                                      proc=self.procs[rid])
            with self._lock:
                self.clients[rid] = client
                self._notified.discard(rid)
            if self.on_respawn is not None:
                self.on_respawn(rid, client)
            return

    def respawns(self) -> Dict[int, int]:
        """Respawn attempts burned per replica (diagnostics/tests)."""
        with self._lock:
            return dict(self._respawns)

    def alive(self) -> Dict[int, bool]:
        return {rid: p.poll() is None for rid, p in self.procs.items()}

    def kill(self, rid: int, sig: int = 9) -> None:
        """Hard-kill one replica (fault injection)."""
        self.procs[rid].send_signal(sig)

    def tail(self, rid: int) -> List[str]:
        return list(self._tails.get(rid, ()))

    def shutdown(self, *, timeout: float = 10.0) -> None:
        """SIGTERM every child, bounded wait, SIGKILL stragglers, reap
        everything — no orphans, whatever state the fleet is in."""
        with self._lock:
            self._closing = True
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + timeout
        for proc in self.procs.values():
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for proc in (*self.procs.values(), *self._retired):
            if proc.stdout is not None:
                proc.stdout.close()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None

    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()
