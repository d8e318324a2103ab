"""Shard the server data plane into per-process workers on one port.

The port of ``tpurpc/rpc/shard.py``. The scale-out unit is a worker
PROCESS: each owns its poller, rings, thread pool, batcher and, on a card,
its own CUDA context, so no lock is shared across shards; CPython's GIL
stops capping the framing path; and a shard that crashes takes exactly its
own connections (clients see UNAVAILABLE and redial onto a live shard).

Listener sharding comes in two flavors:

* ``listener="reuseport"`` (default) — every worker binds the serving port
  with ``SO_REUSEPORT``; the kernel spreads accepted connections across the
  listening workers with no supervisor in the accept path.
* ``listener="handoff"`` — the supervisor owns the listen socket and passes
  each accepted fd to a worker over its ``SOCK_SEQPACKET`` control channel
  (``SCM_RIGHTS``), round-robin or least-loaded on the workers' streamed
  load reports (transport in-flight + the server's load provider).

Workers are SPAWNED, not forked (the reference forks): CUDA state does not
survive a fork, and a process that has touched the card must start its
workers fresh. So ``build`` crosses into the worker by pickle — it must be
importable by its module and name (a module-level function, or a
``functools.partial`` of one); a closure is refused with a ``TypeError``.
A spawned worker inherits no singleton, lock or thread (no registry,
flight ring, watchdog, tsdb or SLO evaluator of the supervisor's), so of
the reference's post-fork reset only two steps remain, both run before the
worker first reads its config or builds: the per-shard ring size and the
shard's identity (:func:`shard_identity`, and
:func:`tpurpc_torch.obs.shard.set_identity`, which tags the worker's
flight events, watchdog and profiler snapshots); no ``postfork_reset`` is
needed.

Ring sizing is per shard: unless the operator pins
``TPURPC_SHARD_RING_BUFFER_SIZE_KB``, each worker scales the configured
ring size down by the shard count (floor 256 KiB) — N shards share the
cache the one big ring used to own.

Observability: after its build each worker starts a loopback scrape
listener (:func:`tpurpc_torch.obs.scrape.start_http_server`, 127.0.0.1 on
an ephemeral port) and reports its port in ``ready``; the supervisor
broadcasts the ``{shard_id: scrape_port}`` map, which each worker installs
with :func:`tpurpc_torch.obs.shard.set_peers`, so any worker answers
``GET /metrics`` (flight, stalls, healthz, ...) on the serving port with
the aggregated, shard-tagged view. Flight events: ``SHARD_START`` and
``SHARD_EXIT`` in the worker, ``SHARD_DEATH`` and ``CONN_HANDOFF`` under
the supervisor's ``shard-supervisor`` tag. The ``shard`` trace flag logs a
shard's death and a connection no live worker took.
"""

from __future__ import annotations

import atexit
import itertools
import json
import multiprocessing
import os
import pickle
import signal
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from tpurpc_torch.analysis.locks import make_lock
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import shard as _obs_shard
from tpurpc_torch.utils.trace import TraceFlag

trace_shard = TraceFlag("shard")

_SUP_TAG = _flight.tag_for("shard-supervisor")

#: control-channel message cap (SOCK_SEQPACKET: one recv = one message)
_CTRL_MSG_BYTES = 65536

#: this process's (shard id, shard count); a worker sets it before build
_identity: Tuple[int, int] = (0, 1)


def shard_identity() -> Tuple[int, int]:
    """``(shard_id, n_shards)`` of this process: ``(0, 1)`` outside a
    sharded worker."""
    return _identity


def shard_peers() -> Dict[int, int]:
    """The live shards' scrape ports, as the supervisor last broadcast them
    to this worker."""
    return _obs_shard.peers()


# ---------------------------------------------------------------------------
# worker side (runs in the spawned child, never returns)
# ---------------------------------------------------------------------------

def _worker_init(shard_id: int, n_shards: int) -> None:
    """What a freshly spawned worker sets before anything reads its config:
    the per-shard ring size, then the shard's identity."""
    global _identity
    from tpurpc_torch.utils import config as _cfg

    pinned = _cfg.env_lookup("TPURPC_SHARD_RING_BUFFER_SIZE_KB")[1]
    if pinned is not None:
        os.environ["TPURPC_RING_BUFFER_SIZE_KB"] = pinned
    elif n_shards > 1:
        base = _cfg.Config.from_env().ring_buffer_size_kb
        os.environ["TPURPC_RING_BUFFER_SIZE_KB"] = str(
            max(256, base // n_shards))
    _cfg.set_config(None)
    _identity = (shard_id, n_shards)
    _obs_shard.set_identity(shard_id, n_shards)


def _ctrl_send(ctrl: socket.socket, obj: dict) -> None:
    try:
        ctrl.send(json.dumps(obj).encode())
    except OSError:
        pass  # supervisor gone; the worker lives until told otherwise


def _worker_main(ctrl: socket.socket, shard_id: int, n_shards: int,
                 build: Callable[[int], object], mode: str,
                 host: str, port: int) -> None:
    _worker_init(shard_id, n_shards)
    try:
        srv = build(shard_id)
        srv.start()
        bound = None
        if mode == "reuseport":
            bound = srv.add_insecure_port(f"{host}:{port}", reuseport=True)
        from tpurpc_torch.obs import scrape as _scrape

        http, scrape_port = _scrape.start_http_server()
    except Exception as exc:
        _ctrl_send(ctrl, {"fatal": repr(exc)})
        os._exit(1)
    _flight.emit(_flight.SHARD_START, 0, shard_id, n_shards)
    _ctrl_send(ctrl, {"ready": shard_id, "scrape_port": scrape_port,
                      "port": bound, "pid": os.getpid()})

    def _exit() -> None:
        _flight.emit(_flight.SHARD_EXIT, 0, shard_id)
        http.server_close()   # the loopback scrape listener goes first
        os._exit(0)

    def _load() -> int:
        n = srv.inflight_requests()
        extra = getattr(srv, "_load_extra", None)
        if extra is not None:
            try:
                n += int(extra())
            except Exception:
                pass
        return n

    ctrl.settimeout(0.05)
    last_load = -1
    while True:
        try:
            data, fds, _flags, _addr = socket.recv_fds(
                ctrl, _CTRL_MSG_BYTES, 4)
        except (TimeoutError, socket.timeout):
            # idle tick: stream the load signal (the handoff picker's feed;
            # only deltas, so an idle worker costs one int compare)
            load = _load()
            if load != last_load:
                last_load = load
                _ctrl_send(ctrl, {"load": load})
            continue
        except OSError:
            data, fds = b"", []
        if not data:
            # supervisor died: a headless worker must not linger holding
            # the port — exit and let clients re-dial whatever replaces us
            _exit()
        try:
            msg = json.loads(data)
        except ValueError:
            msg = {}
        if msg.get("handoff") and fds:
            for fd in fds:
                try:
                    srv.adopt_socket(socket.socket(
                        socket.AF_INET, socket.SOCK_STREAM, fileno=fd))
                except OSError:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
        elif "peers" in msg:
            _obs_shard.set_peers(
                {int(k): int(v) for k, v in msg["peers"].items()})
        elif "drain" in msg:
            linger = float(msg["drain"])

            def _drain():
                ok = srv.drain(linger)
                _ctrl_send(ctrl, {"drained": shard_id, "clean": bool(ok)})

            threading.Thread(target=_drain, daemon=True,
                             name="tpurpc-shard-drain").start()
        elif "stop" in msg:
            grace = msg.get("stop")
            try:
                srv.stop(grace if isinstance(grace, (int, float)) else None)
            except Exception:
                pass
            _ctrl_send(ctrl, {"bye": shard_id})
            _exit()


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class _Worker:
    __slots__ = ("shard_id", "proc", "ctrl", "alive", "scrape_port",
                 "load", "stopping", "drained")

    def __init__(self, shard_id: int, proc, ctrl: socket.socket):
        self.shard_id = shard_id
        self.proc = proc
        self.ctrl = ctrl
        self.alive = True
        self.scrape_port: Optional[int] = None
        self.load = 0
        self.stopping = False
        self.drained = False


class ShardedServer:
    """Supervisor for N worker processes serving ONE port.

    ``build(shard_id) -> Server`` runs IN THE WORKER after the spawn: it
    constructs and registers (but does not start) the shard's server —
    handlers, batchers, admission gates, anything. It must be importable by
    name (see the module docstring). The supervisor itself stays thin:
    bind, spawn, broadcast the peer map, monitor, and (handoff mode) spread
    accepted fds.

    Lifecycle: :meth:`start` → traffic → optional :meth:`drain` →
    :meth:`stop`. :meth:`kill_worker` is the chaos face (SIGKILL one shard;
    survivors keep serving).
    """

    def __init__(self, build: Callable[[int], object], workers: int = 2,
                 address: str = "127.0.0.1:0", *,
                 listener: str = "reuseport",
                 handoff_policy: str = "round_robin"):
        if listener not in ("reuseport", "handoff"):
            raise ValueError(f"unknown listener mode {listener!r}")
        if handoff_policy not in ("round_robin", "least_loaded"):
            raise ValueError(f"unknown handoff policy {handoff_policy!r}")
        try:
            pickle.dumps(build)
        except (pickle.PicklingError, AttributeError, TypeError) as exc:
            raise TypeError(
                f"build {build!r} is not importable by name: workers start "
                f"by spawn, which pickles it by its module and name, so it "
                f"must be a module-level function (or a functools.partial "
                f"of one), not a closure or lambda ({exc})") from None
        self.build = build
        self.n_workers = max(1, int(workers))
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self._want_port = int(port)
        self.listener = listener
        self.handoff_policy = handoff_policy
        self.port: Optional[int] = None
        self._workers: List[_Worker] = []
        self._lock = make_lock("ShardedServer._lock")
        self._stopping = False
        self._started = False
        self._reserve: Optional[socket.socket] = None
        self._listen: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._rr = itertools.count()
        self._fatal: Optional[str] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self, ready_timeout: float = 120.0) -> "ShardedServer":
        """Bind, spawn the workers and wait (at most ``ready_timeout``
        seconds) until each has built and started its server. A worker
        whose build fails reports ``fatal``: every worker is stopped and
        this raises ``RuntimeError``."""
        if self._started:
            return self
        self._started = True
        if self.listener == "reuseport":
            # reserve the port number before spawning: a bound-not-listening
            # REUSEPORT socket pins the port (the kernel only routes among
            # LISTENING sockets, so it never receives a connection)
            self._reserve = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._reserve.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEPORT, 1)
            self._reserve.bind((self.host, self._want_port))
            self.port = self._reserve.getsockname()[1]
        else:
            self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listen.bind((self.host, self._want_port))
            self._listen.listen(128)
            self.port = self._listen.getsockname()[1]
        atexit.register(self._atexit_kill)
        try:
            for i in range(self.n_workers):
                self._spawn(i)
        except BaseException:
            self.stop()   # the workers already started must not linger
            raise
        self._await_ready(ready_timeout)
        self._broadcast_peers()
        if self.listener == "handoff":
            self._accept_thread = threading.Thread(
                target=self._accept_loop, daemon=True,
                name="tpurpc-shard-accept")
            self._accept_thread.start()
        return self

    def _spawn(self, shard_id: int) -> None:
        # SEQPACKET: every control message (and every SCM_RIGHTS handoff)
        # arrives whole — no framing layer, no fd/payload pairing races.
        # The child inherits only its own end (spawn passes the fds it
        # pickles and closes the rest): no listen socket, no sibling's.
        parent_end, child_end = socket.socketpair(socket.AF_UNIX,
                                                  socket.SOCK_SEQPACKET)
        proc = multiprocessing.get_context("spawn").Process(
            target=_worker_main,
            args=(child_end, shard_id, self.n_workers, self.build,
                  self.listener, self.host, self.port),
            name=f"tpurpc-shard-{shard_id}", daemon=True)
        try:
            proc.start()
        finally:
            child_end.close()
        w = _Worker(shard_id, proc, parent_end)
        with self._lock:
            self._workers.append(w)
        threading.Thread(target=self._monitor, args=(w,), daemon=True,
                         name=f"tpurpc-shard-mon-{shard_id}").start()

    def _await_ready(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._fatal is not None:
                self.stop()
                raise RuntimeError(f"shard worker failed: {self._fatal}")
            with self._lock:
                ready = [w for w in self._workers
                         if w.scrape_port is not None]
                dead = [w for w in self._workers if not w.alive]
                if len(ready) == self.n_workers:
                    return
            if dead:
                self.stop()
                raise RuntimeError(
                    f"shard worker {dead[0].shard_id} exited before ready "
                    f"(exit code {dead[0].proc.exitcode})")
            time.sleep(0.01)
        self.stop()
        raise TimeoutError("shard workers did not report ready")

    def _monitor(self, w: _Worker) -> None:
        """One blocking reader per worker control socket: loads, acks, and
        — on EOF — the death path."""
        while True:
            try:
                data = w.ctrl.recv(_CTRL_MSG_BYTES)
            except OSError:
                data = b""
            if not data:
                break
            try:
                msg = json.loads(data)
            except ValueError:
                continue
            if "ready" in msg:
                w.scrape_port = int(msg["scrape_port"])
            elif "load" in msg:
                w.load = int(msg["load"])
            elif "fatal" in msg:
                self._fatal = str(msg["fatal"])
            elif "drained" in msg:
                w.drained = True
            # "bye" needs no action: the stop() path reaps
        self._reap(w)

    def _reap(self, w: _Worker) -> None:
        w.proc.join(timeout=30)
        died = False
        with self._lock:
            if w.alive:
                w.alive = False
                died = not w.stopping and not self._stopping
        if died:
            # the shard's connections are gone (clients got UNAVAILABLE and
            # re-dial onto live shards — in reuseport mode the kernel
            # stopped routing to the closed socket the instant the process
            # died); its telemetry drops out: survivors get a peer map
            # without it
            status = w.proc.exitcode if w.proc.exitcode is not None else -1
            _flight.emit(_flight.SHARD_DEATH, _SUP_TAG, w.shard_id, status)
            trace_shard.log("shard %d died (status %d)", w.shard_id, status)
            self._broadcast_peers()

    # -- peer map -------------------------------------------------------------

    def scrape_ports(self) -> Dict[int, int]:
        """Live shards' loopback scrape ports."""
        with self._lock:
            return {w.shard_id: w.scrape_port for w in self._workers
                    if w.alive and w.scrape_port is not None}

    def _broadcast_peers(self) -> None:
        payload = {"peers": self.scrape_ports()}
        with self._lock:
            targets = [w for w in self._workers if w.alive]
        for w in targets:
            _ctrl_send(w.ctrl, payload)

    # -- handoff accept spread ------------------------------------------------

    def _pick_worker(self) -> Optional[_Worker]:
        with self._lock:
            alive = [w for w in self._workers if w.alive]
        if not alive:
            return None
        if self.handoff_policy == "least_loaded":
            # the load signals streamed over the control channel: place the
            # connection where the least work is queued (ties rotate)
            best = min(w.load for w in alive)
            alive = [w for w in alive if w.load == best]
        return alive[next(self._rr) % len(alive)]

    def _accept_loop(self) -> None:
        self._listen.settimeout(0.2)
        while not self._stopping:
            try:
                sock, _addr = self._listen.accept()
            except (TimeoutError, socket.timeout):
                continue
            except OSError:
                if self._stopping:
                    return
                time.sleep(0.05)
                continue
            handed = False
            for _attempt in range(self.n_workers):
                w = self._pick_worker()
                if w is None:
                    break
                try:
                    socket.send_fds(w.ctrl, [b'{"handoff": 1}'],
                                    [sock.fileno()])
                    _flight.emit(_flight.CONN_HANDOFF, _SUP_TAG, w.shard_id)
                    handed = True
                    break
                except OSError:
                    continue  # racing a worker death: try another
            if not handed:
                trace_shard.log("handoff: no live worker for connection")
            sock.close()  # worker holds its own duplicate (or nobody: RST)

    # -- operator face --------------------------------------------------------

    def alive_workers(self) -> List[int]:
        with self._lock:
            return [w.shard_id for w in self._workers if w.alive]

    def worker_pid(self, shard_id: int) -> Optional[int]:
        with self._lock:
            for w in self._workers:
                if w.shard_id == shard_id:
                    return w.proc.pid
        return None

    def drained_workers(self) -> List[int]:
        """Shards that have reported a finished drain."""
        with self._lock:
            return [w.shard_id for w in self._workers if w.drained]

    def kill_worker(self, shard_id: int, sig: int = signal.SIGKILL) -> bool:
        """Chaos face: kill one shard. Returns False if it wasn't running."""
        with self._lock:
            target = next((w for w in self._workers
                           if w.shard_id == shard_id and w.alive), None)
        if target is None:
            return False
        try:
            os.kill(target.proc.pid, sig)
        except ProcessLookupError:
            return False
        return True

    def drain(self, linger: float = 5.0) -> None:
        """Broadcast a graceful drain: each worker's ``Server.drain`` (its
        health service answers NOT_SERVING) and a ``drained`` report."""
        with self._lock:
            targets = [w for w in self._workers if w.alive]
        for w in targets:
            _ctrl_send(w.ctrl, {"drain": linger})

    def stop(self, grace: Optional[float] = None,
             timeout: float = 10.0) -> None:
        """Tell every worker to stop, wait at most ``timeout`` seconds for
        each to exit, SIGKILL the rest, and reap them all."""
        self._stopping = True
        with self._lock:
            targets = list(self._workers)
        for w in targets:
            w.stopping = True
            _ctrl_send(w.ctrl, {"stop": grace})
        deadline = time.monotonic() + timeout
        for w in targets:
            # each worker's monitor thread reaps it (the one joiner)
            while w.alive and time.monotonic() < deadline:
                time.sleep(0.01)
            if w.alive:
                try:
                    os.kill(w.proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                reap_by = time.monotonic() + 5.0
                while w.alive and time.monotonic() < reap_by:
                    time.sleep(0.01)
            try:
                w.ctrl.close()
            except OSError:
                pass
        for s in (self._reserve, self._listen):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._reserve = self._listen = None
        atexit.unregister(self._atexit_kill)

    def _atexit_kill(self) -> None:
        """Last-resort reaper: a crashed test or supervisor must not leak
        worker processes holding the port."""
        with self._lock:
            targets = [w for w in self._workers if w.alive]
        for w in targets:
            try:
                os.kill(w.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, OSError):
                pass
