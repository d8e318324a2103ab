"""The port's sharded serving (``tpurpc_torch.rpc.shard``,
``serve_torch_sharded``) on the CPU, mirroring the process cases of the
reference's ``tests/test_shard.py``, then the slice as a whole against the
reference.

Workers are real processes, started by spawn (the reference forks): a
killed shard's in-flight calls fail UNAVAILABLE (never hang) and its
connections re-accept onto the survivor. Every worker build lives in
``tests/torch_shard_builds.py`` so that spawn can import it by name; a
closure is refused (``test_closure_build_is_refused``, the divergence).
``ready`` carries ``scrape_port: 0`` (no scrape server yet,
``test_workers_report_identity_ring_size_and_zero_scrape_port``). The
reference's three aggregated-telemetry cases wait for the port's
observability.

Every fleet holds the cross-process launch lock of ``tests/torch_ranks.py``
while it runs (so fleets and multi-rank launches take turns across xdist
workers), its workers lower their priority, every wait is bounded, and
every fleet is stopped in ``finally`` (``stop`` kills what does not exit).
"""

import contextlib
import functools
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import torch_ranks
import torch_shard_builds as builds
from test_torch_health import probe_fresh
from test_torch_transformer import F32_TOL, SMALL, _cfgs, _jax_params, _ref_logits
from tpurpc.core import _native as ref_native
from tpurpc.jaxshim import serve_jax
from tpurpc.rpc.channel import Channel as JaxChannel
from tpurpc.utils import config as jax_config
from tpurpc_torch.core.poller import PairPool, Poller
from tpurpc_torch.rpc import health
from tpurpc_torch.rpc import shard as shard_mod
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.shard import ShardedServer
from tpurpc_torch.rpc.status import RpcError, StatusCode
from tpurpc_torch.torchshim import codec
from tpurpc_torch.torchshim.service import TensorClient, serve_torch_sharded
from tpurpc_torch.utils import config as torch_config

#: a fleet's start (spawned workers import torch) and each call, seconds
READY = 120.0
CALL = 30.0
#: the device-ring fleet: test_torch_slice's ring and requests (the 3rd and
#: 6th of a connection wrap a 64 KiB ring)
RING_KB = 64
RING_SHAPE = (2, 32, 32, 3)
RING_REQUESTS = 6

_held = {"depth": 0, "fd": None}


@contextlib.contextmanager
def _launch_lock():
    """``torch_ranks``' cross-process launch lock, re-entrant within this
    process (a module fleet and a test's own fleet may overlap)."""
    if _held["depth"] == 0:
        _held["fd"] = torch_ranks._lock()
    _held["depth"] += 1
    try:
        yield
    finally:
        _held["depth"] -= 1
        if _held["depth"] == 0:
            torch_ranks._unlock(_held["fd"])
            _held["fd"] = None


@contextlib.contextmanager
def _fleet(build, **kw):
    with _launch_lock():
        sup = ShardedServer(build, **kw)
        try:
            yield sup.start(ready_timeout=READY)
        finally:
            sup.stop()


def _call(port, method, req=b"x", timeout=CALL):
    with Channel(f"127.0.0.1:{port}") as ch:
        return bytes(ch.unary_unary(method)(req, timeout=timeout))


def _who(port, timeout=CALL):
    return _call(port, "/t.S/Who", timeout=timeout).decode()


def _stats(ch):
    return json.loads(bytes(ch.unary_unary(builds.STATS)(b"",
                                                         timeout=CALL)))


@pytest.fixture(scope="module")
def reuseport_fleet():
    with _fleet(builds.who, workers=2, listener="reuseport") as sup:
        yield sup


@pytest.fixture(scope="module")
def handoff_fleet():
    with _fleet(builds.who, workers=2, listener="handoff") as sup:
        yield sup


# ---------------------------------------------------------------------------
# listener sharding
# ---------------------------------------------------------------------------

def test_reuseport_accept_spread(reuseport_fleet):
    """SO_REUSEPORT: with enough distinct connections the kernel's spread
    lands work on EVERY shard (P[all-on-one] ≈ 2^-31 at 32 connections)."""
    seen = {}
    for _ in range(32):
        who = _who(reuseport_fleet.port)
        seen[who] = seen.get(who, 0) + 1
    assert set(seen) == {"0", "1"}, seen
    assert sum(seen.values()) == 32


def test_handoff_round_robin_distribution(handoff_fleet):
    """Supervisor fd handoff: round robin per connection — an even split,
    every fd delivered over SCM_RIGHTS and served."""
    seen = {}
    for _ in range(12):
        who = _who(handoff_fleet.port)
        seen[who] = seen.get(who, 0) + 1
    assert seen == {"0": 6, "1": 6}, seen


@pytest.mark.parametrize("listener", ["reuseport", "handoff"])
def test_workers_report_identity_ring_size_and_zero_scrape_port(
        listener, reuseport_fleet, handoff_fleet):
    """Each worker knows its shard id and count before its build runs,
    scaled its ring to the shard count (4096 KiB / 2), imported no JAX, and
    holds the supervisor's peer map. Divergence: ``ready`` carries
    ``scrape_port: 0`` until the scrape server is ported."""
    sup = reuseport_fleet if listener == "reuseport" else handoff_fleet
    assert sup.scrape_ports() == {0: 0, 1: 0}
    seen = {}
    for _ in range(32):
        with Channel(f"127.0.0.1:{sup.port}") as ch:
            st = _stats(ch)
        seen[st["shard"]] = st
        if len(seen) == 2:
            break
    assert sorted(seen) == [0, 1]
    for sid, st in seen.items():
        assert st["n_shards"] == 2 and st["jax"] is False
        assert st["ring_buffer_size_kb"] == "2048"
        assert st["peers"] == {"0": 0, "1": 0}
        assert st["pid"] == sup.worker_pid(sid)
    assert seen[0]["pid"] != seen[1]["pid"]


def test_worker_ring_size_rule(monkeypatch):
    """The per-shard ring size: the configured size over the shard count,
    floor 256 KiB, unless TPURPC_SHARD_RING_BUFFER_SIZE_KB pins it."""
    monkeypatch.setattr(shard_mod, "_identity", (0, 1))
    cases = [(None, "4096", 2, "2048"), (None, "4096", 64, "256"),
             (None, None, 4, "1024"), ("768", "4096", 2, "768")]
    try:
        for pinned, configured, n, want in cases:
            for key, val in (("TPURPC_SHARD_RING_BUFFER_SIZE_KB", pinned),
                             ("TPURPC_RING_BUFFER_SIZE_KB", configured)):
                if val is None:
                    monkeypatch.delenv(key, raising=False)
                else:
                    monkeypatch.setenv(key, val)
            shard_mod._worker_init(1, n)
            assert torch_config.get_config().ring_buffer_size_kb == int(want)
            assert shard_mod.shard_identity() == (1, n)
    finally:
        monkeypatch.undo()
        torch_config.set_config(None)


def test_handoff_least_loaded_avoids_busy_shard():
    """least_loaded: with one shard pinned by slow calls (streamed load
    reports > 0), new connections go to the idle shard."""
    with _fleet(builds.who, workers=2, listener="handoff",
                handoff_policy="least_loaded") as sup:
        ch = Channel(f"127.0.0.1:{sup.port}")
        try:
            busy = bytes(ch.unary_unary("/t.S/Who")(b"x",
                                                    timeout=CALL)).decode()
            hold = ch.unary_unary("/t.S/Hold")
            futs = [hold.future(b"25", timeout=CALL) for _ in range(4)]
            busy_w = sup._workers[int(busy)]
            deadline = time.monotonic() + 10
            while busy_w.load < 4 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert busy_w.load >= 4, busy_w.load
            other = {"0": "1", "1": "0"}[busy]
            placed = [_who(sup.port) for _ in range(6)]
            # the held calls park until released on their own connection
            ch.unary_unary("/t.S/Release")(b"", timeout=CALL)
            assert [bytes(f.result(timeout=CALL)) for f in futs] == [
                busy.encode()] * 4
            assert placed == [other] * 6, (busy, placed)
        finally:
            ch.close()


# ---------------------------------------------------------------------------
# crash semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("listener", ["reuseport", "handoff"])
def test_worker_crash_inflight_unavailable_and_reaccept(listener):
    """Kill the shard serving an in-flight call: the call fails UNAVAILABLE
    (not a hang), and a redial lands on the survivor."""
    with _fleet(builds.who, workers=2, listener=listener) as sup:
        ch = Channel(f"127.0.0.1:{sup.port}")
        victim = int(bytes(ch.unary_unary("/t.S/Who")(
            b"x", timeout=CALL)).decode())
        outcome = {}

        def call():
            try:
                ch.unary_unary("/t.S/Hold")(b"25", timeout=CALL)
                outcome["ok"] = True
            except RpcError as exc:
                outcome["code"] = exc.code()

        t = threading.Thread(target=call)
        t.start()
        # the victim's streamed load report shows the call in flight
        victim_w = sup._workers[victim]
        deadline = time.monotonic() + 10
        while victim_w.load < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert victim_w.load >= 1
        assert sup.kill_worker(victim)
        t.join(timeout=20)
        assert not t.is_alive(), "in-flight call hung after shard death"
        assert outcome.get("code") is StatusCode.UNAVAILABLE, outcome
        ch.close()
        deadline = time.monotonic() + 10
        served = None
        while time.monotonic() < deadline:
            try:
                served = _who(sup.port, timeout=5)
                break
            except (RpcError, OSError):
                time.sleep(0.1)
        assert served == str(1 - victim)
        deadline = time.monotonic() + 10
        while sup.alive_workers() != [1 - victim] and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert sup.alive_workers() == [1 - victim]
        assert not sup.kill_worker(victim)


def test_graceful_drain_broadcast():
    """drain() reaches every worker: each reports ``drained``, and the
    health service answers NOT_SERVING — to a Watch held open on each
    worker's connection across the drain, and to a probe dialed after."""
    with _fleet(builds.who, workers=2, listener="handoff") as sup:
        chans = [Channel(f"127.0.0.1:{sup.port}") for _ in range(2)]
        seen = {0: [], 1: []}
        threads = []
        try:
            shards = [int(bytes(c.unary_unary("/t.S/Who")(
                b"x", timeout=CALL)).decode()) for c in chans]
            assert sorted(shards) == [0, 1]   # round robin: one each

            def watch(ch, sid):
                try:
                    for msg in ch.unary_stream(f"/{health.SERVICE_NAME}/"
                                               "Watch")(
                            health.encode_request(""), timeout=CALL):
                        seen[sid].append(health.decode_response(msg))
                        if seen[sid][-1] is health.ServingStatus.NOT_SERVING:
                            return
                except RpcError:
                    pass

            threads = [threading.Thread(target=watch, args=(c, s))
                       for c, s in zip(chans, shards)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 10
            while not all(seen.values()) and time.monotonic() < deadline:
                time.sleep(0.02)
            assert all(v[:1] == [health.ServingStatus.SERVING]
                       for v in seen.values()), seen
            sup.drain(linger=1.0)
            for t in threads:
                t.join(timeout=CALL)
            assert not any(t.is_alive() for t in threads)
            assert all(v[-1] is health.ServingStatus.NOT_SERVING
                       for v in seen.values()), seen
            deadline = time.monotonic() + 10
            while sup.drained_workers() != [0, 1] and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            assert sup.drained_workers() == [0, 1]
            assert probe_fresh(sup.port) is health.ServingStatus.NOT_SERVING
        finally:
            for c in chans:
                c.close()


# ---------------------------------------------------------------------------
# the spawn contract
# ---------------------------------------------------------------------------

def _closure_build():
    def build(shard_id):
        return builds.who(shard_id)
    return build


@pytest.mark.parametrize("make", [
    _closure_build,
    lambda: (lambda shard_id: None),
    lambda: functools.partial(_closure_build(), 0),
], ids=["closure", "lambda", "partial-of-closure"])
def test_closure_build_is_refused(make):
    """Divergence: workers start by spawn, which pickles ``build`` by its
    module and name, so a closure (the reference forks, and takes one) is
    refused before any process starts."""
    with pytest.raises(TypeError, match="importable by name"):
        ShardedServer(make(), workers=2)
    with pytest.raises(TypeError, match="importable by name"):
        serve_torch_sharded(lambda: (lambda tree: tree), workers=2)


def test_stop_reaps_every_worker():
    with _launch_lock():
        sup = ShardedServer(builds.who, workers=2).start(ready_timeout=READY)
        pids = [sup.worker_pid(i) for i in range(2)]
        sup.stop()
    assert sup.alive_workers() == []
    assert [w.proc.exitcode for w in sup._workers] == [0, 0]
    assert all(p is not None for p in pids) and pids[0] != pids[1]
    with pytest.raises(RpcError) as ei:   # nobody listens on the port
        _who(sup.port, timeout=5)
    assert ei.value.code() is StatusCode.UNAVAILABLE


def test_bad_modes_rejected():
    with pytest.raises(ValueError):
        ShardedServer(builds.who, listener="carrier-pigeon")
    with pytest.raises(ValueError):
        ShardedServer(builds.who, handoff_policy="random")


def test_failing_build_reports_fatal_and_start_raises():
    """A worker whose build raises reports ``fatal``: start stops every
    worker and raises with the worker's error."""
    with _launch_lock():
        sup = ShardedServer(builds.broken, workers=2)
        try:
            with pytest.raises(RuntimeError, match="no card here"):
                sup.start(ready_timeout=READY)
        finally:
            sup.stop()
        assert sup.alive_workers() == []


# ---------------------------------------------------------------------------
# the slice as a whole, against the reference
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


def test_transformer_fleet_matches_reference(cpu_device, tmp_path):
    """serve_torch_sharded: 2 workers, each the port's transformer (2
    layers, d_model 32) from the reference's parameters; 16 seeded
    single-row requests over 4 connections, each reply within the float32
    forward test's tolerance of the reference Transformer's direct output.
    Then the fleet's drain shows as NOT_SERVING."""
    jcfg, _tcfg = _cfgs(SMALL)
    params = _jax_params(jcfg, seed=3)
    npz = tmp_path / "params.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in params.items()})
    rows = np.random.default_rng(9).integers(
        0, SMALL["vocab"], (16, 1, 16)).astype(np.int32)
    want = _ref_logits(jcfg, params, rows[:, 0])      # [16, 16, vocab]
    build_fn = functools.partial(builds.transformer_fn, str(npz),
                                 json.dumps(SMALL))
    with _launch_lock():
        sup = serve_torch_sharded(build_fn, workers=2, name="Generate",
                                  batching=True, max_batch=8,
                                  max_delay_s=0.005)
        try:
            chans = [Channel(f"127.0.0.1:{sup.port}") for _ in range(4)]
            try:
                pipes = [TensorClient(c).pipeline("Generate", depth=4)
                         for c in chans]
                futs = [pipes[i % 4].call_async(
                    {"tokens": torch.from_numpy(r)}, timeout=CALL)
                    for i, r in enumerate(rows)]
                got = [f.result(timeout=CALL)["logits"].numpy() for f in futs]
            finally:
                for c in chans:
                    c.close()
            assert sup.alive_workers() == [0, 1]
            for i, g in enumerate(got):
                assert g.shape == (1, 16, SMALL["vocab"]) and \
                    g.dtype == np.float32
                err = np.abs(g[0] - want[i]).max() / max(
                    1.0, np.abs(want[i]).max())
                assert err <= F32_TOL, (i, err)
            sup.drain(linger=1.0)
            deadline = time.monotonic() + 10
            while sup.drained_workers() != [0, 1] and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            assert sup.drained_workers() == [0, 1]
            assert probe_fresh(sup.port) is health.ServingStatus.NOT_SERVING
        finally:
            sup.stop()
    assert sup.alive_workers() == []


@pytest.fixture
def tpu_platform(monkeypatch):
    """Both packages on the device-ring platform, the port on the CPU (the
    workers inherit this environment at spawn)."""
    ref_native.load()   # the reference's first-use build, outside deadlines
    monkeypatch.setenv("GRPC_PLATFORM_TYPE", "TPU")
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TPURPC_HBM_RING_SIZE_KB", str(RING_KB))
    jax_config.set_config(None)
    torch_config.set_config(None)
    yield
    Poller.reset()
    PairPool.reset()
    torch_config.set_config(None)
    monkeypatch.undo()
    jax_config.set_config(None)


def test_device_ring_fleet_matches_reference(tpu_platform):
    """A handoff fleet of 2 device-ring workers (``device=True``): round
    robin puts one connection on each; each sends 6 requests of float32
    [2,32,32,3], so each worker's 3rd and 6th wrap its 64 KiB ring and take
    the kernels' plain versions (counted in the worker). Every reply is
    byte-equal to the reply of the reference's ``serve_jax`` to the same
    request bytes."""
    jsrv, jport, _ = serve_jax(jax.jit(builds.affine))
    rng = np.random.default_rng(21)
    reqs = [codec.encode_tree_bytes({"x": torch.from_numpy(
        rng.standard_normal(RING_SHAPE).astype(np.float32))})
        for _ in range(2 * RING_REQUESTS)]
    try:
        with _fleet(builds.ring, workers=2, listener="handoff",
                    handoff_policy="round_robin") as sup:
            chans = [Channel(f"127.0.0.1:{sup.port}") for _ in range(2)]
            try:
                stats, got = [], []
                for k, ch in enumerate(chans):
                    mc = ch.unary_unary("/tpurpc.Tensor/Call")
                    got += [bytes(mc(r, timeout=CALL)) for r in
                            reqs[k * RING_REQUESTS:(k + 1) * RING_REQUESTS]]
                    stats.append(_stats(ch))
            finally:
                for c in chans:
                    c.close()
        with JaxChannel(f"127.0.0.1:{jport}") as jch:
            jmc = jch.unary_unary("/tpurpc.Tensor/Call")
            want = [bytes(jmc(r, timeout=CALL)) for r in reqs]
    finally:
        jsrv.stop()
    assert got == want
    assert sorted(s["shard"] for s in stats) == [0, 1]
    assert stats[0]["pid"] != stats[1]["pid"]
    for s in stats:
        assert s["plain"] == {"ring_scatter": 2, "ring_window": 2}, s
        assert s["launches"] == {"ring_scatter": 0, "ring_window": 0}
