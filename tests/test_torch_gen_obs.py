"""The observability hooks of the generation plane on both packages: the
twins of the cases that ``tests/test_torch_serving.py``,
``tests/test_torch_kv.py`` and ``tests/test_torch_disagg.py`` left out for
want of this plane.

* ``tests/test_serving.py``: the watchdog's ``decode-step`` stage (a wedged
  step, a starved loop), the ``/healthz`` gen lines and the load provider
  (waiting plus swapped work);
* ``tests/test_kv.py``: swap's gauges and flight bracket, the KV fleet
  gauges, the ``/healthz`` kv lines and the watchdog's ``kv-swap`` and
  ``migration`` stages;
* ``tests/test_disagg.py``: the protocol checks of the handoff, a live
  migration and a migration whose target dies (``assert_ordered`` and
  ``check_events`` of the reference's ``tpurpc.analysis.protocol``, held on
  each package's flight stream; the port's copy of it is ROADMAP A12).

Each scenario runs on both packages with the same inputs and the
observations must be equal. Where the reference's case emits a flight edge
by hand to open a stage, the twin makes each package's own code open it:
a swap wedged inside ``swap_in`` and a migration whose peer never answers
its offer. Every scenario reads its own flight tags and its own objects'
gauge readings, and each case resets both packages' flight rings and
watchdogs before and after.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tpurpc.analysis import protocol
from tpurpc_torch.torchshim.generate import reference_decode

WAIT = 30.0
#: a migrated stream's length: at 3 ms a step it outlives the migration's
#: detach by far, even on a loaded host
MIG_TOKENS = 300


def _pkg(name, root):
    m = SimpleNamespace(name=name, root=root)
    for path in ("obs.flight", "obs.metrics", "obs.scrape", "obs.watchdog",
                 "obs.odyssey", "serving.scheduler", "serving.kv",
                 "serving.api", "serving.disagg", "rpc.channel",
                 "rpc.status"):
        setattr(m, path.split(".")[1],
                importlib.import_module(f"{root}.{path}"))
    shim = "jaxshim" if root == "tpurpc" else "torchshim"
    m.gen = importlib.import_module(f"{root}.{shim}.generate")
    m.dev = {} if root == "tpurpc" else {"device": "cpu"}
    return m


REF = _pkg("ref", "tpurpc")
PORT = _pkg("port", "tpurpc_torch")
BOTH = (REF, PORT)


def _model(m, cls=None, **kw):
    return (cls or m.gen.ToyDecodeModel)(**m.dev, **kw)


def _reset(m):
    m.flight.RECORDER.reset()
    m.watchdog.get().reset()
    m.odyssey.reset()


@pytest.fixture(autouse=True)
def _clean():
    saved = []
    for m in BOTH:
        _reset(m)
        saved.append(m.scheduler.TokenStream.MAX_IDLE_S)
        m.scheduler.TokenStream.MAX_IDLE_S = 10.0
    yield
    for m, old in zip(BOTH, saved):
        m.scheduler.TokenStream.MAX_IDLE_S = old
        m.disagg.TEST_HOOKS.clear()
        _reset(m)


def _same(run):
    got = {}
    for m in BOTH:
        _reset(m)
        got[m.name] = run(m)
    assert got["ref"] == got["port"], got
    return got["port"]


def _poll(pred, timeout=5.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(interval)
    return pred()


def _watchdog(m):
    """A private watchdog with the reference tests' knobs: a 0.2 s stall
    floor, sweeps driven by the test."""
    wd = m.watchdog.StallWatchdog(sweep_s=10, mult=8, min_stall_s=0.2)
    wd.enabled = True
    return wd


def _stop_watchdog(wd):
    stop = getattr(wd, "stop", None)  # the reference's sweeper never ends
    if stop is not None:
        stop()


def _gauge(m, name, obj):
    g = m.metrics.fleet(name)
    return float(g._fn(obj)) if obj in set(g._refs) else None


def _events(m, entity, since_ns=0):
    return [(e["event"], e["a2"]) for e in m.flight.snapshot(since_ns)
            if e["entity"] == entity]


# ---------------------------------------------------------------------------
# The decode scheduler (twins of tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_watchdog_names_decode_step_for_wedged_step():
    def run(m):
        wedge = threading.Event()

        class Wedged(m.gen.ToyDecodeModel):
            def step(self, states, tokens):
                wedge.wait(3)
                return super().step(states, tokens)

        wd = _watchdog(m)
        s = m.scheduler.DecodeScheduler(_model(m, Wedged), idle_wait_s=0.005,
                                        name="g-wedge")
        try:
            tok = wd.call_started("/tpurpc.Generate/Generate")
            h = s.submit([1], max_tokens=5)
            assert _poll(lambda: [e for e in m.flight.snapshot()
                                  if e["event"] == "gen-step-begin"])
            time.sleep(0.35)                 # past the stall bar, step open
            diags = wd.sweep_once()
            wedge.set()
            toks = list(h)
            wd.call_finished(tok)
        finally:
            wedge.set()
            s.close()
            _stop_watchdog(wd)
        return (toks, [d["stage"] for d in diags],
                "wedged" in diags[0]["detail"])

    toks, stages, wedged = _same(run)
    assert toks == reference_decode([1], 5)
    assert stages[:1] == ["decode-step"] and wedged


def test_watchdog_decode_step_when_loop_starved():
    """Sequences wait but the loop completes no step inside the stall
    window: its prefill is wedged."""
    def run(m):
        hold = threading.Event()

        class WedgedPrefill(m.gen.ToyDecodeModel):
            def prefill(self, prompts):
                hold.wait(3)
                return super().prefill(prompts)

        wd = _watchdog(m)
        s = m.scheduler.DecodeScheduler(_model(m, WedgedPrefill),
                                        max_batch=1, idle_wait_s=0.005,
                                        name="g-starve")
        try:
            tok = wd.call_started("/tpurpc.Generate/Generate")
            a = s.submit([1], max_tokens=3)     # the loop wedges in prefill
            b = s.submit([2], max_tokens=3)     # parked waiting
            time.sleep(0.35)
            diags = wd.sweep_once()
            hold.set()
            toks = (list(a), list(b))
            wd.call_finished(tok)
        finally:
            hold.set()
            s.close()
            _stop_watchdog(wd)
        return (toks, [d["stage"] for d in diags],
                "waiting" in diags[0]["detail"])

    toks, stages, waiting = _same(run)
    assert toks == (reference_decode([1], 3), reference_decode([2], 3))
    assert stages[:1] == ["decode-step"] and waiting


class _Gate:
    """Parks a model's opaque decode steps until opened."""

    def __init__(self, model):
        self.model = model
        self.open = threading.Event()
        self.steps = 0
        inner = model.step

        def step(states, tokens):
            self.steps += 1
            assert self.open.wait(WAIT), "gated step never opened"
            return inner(states, tokens)
        model.step = step


def _health_lines(m, prefix):
    status, _ctype, body = m.scrape.route_local("/healthz")
    return status, [ln for ln in body.decode().splitlines()
                    if ln.startswith(prefix)]


def test_healthz_shows_gen_state():
    """A serving scheduler's ``gen`` line on ``/healthz`` reads ``ok``, and
    ``shedding`` after a batch-class shed. Its decode step parks while the
    queue is filled, so the shed does not race the boundary."""
    def run(m):
        gate = _Gate(_model(m))
        srv, _port, sched = m.api.serve_generation(
            gate.model, max_batch=2, max_waiting=4, batch_shed_depth=1,
            name="g-hz")
        try:
            before = _health_lines(m, "gen g-hz:")
            h = sched.submit([1], max_tokens=100)
            assert _poll(lambda: gate.steps >= 1)
            sched.submit([2], max_tokens=2)
            with pytest.raises(m.scheduler.ShedError):
                sched.submit([3], max_tokens=2, slo="batch")
            during = _health_lines(m, "gen g-hz:")
            h.cancel()
            gate.open.set()
        finally:
            gate.open.set()
            srv.stop(grace=0)
            sched.close()
        after = _health_lines(m, "gen g-hz:")
        return before, during, after

    before, during, after = _same(run)
    assert before == (200, ["gen g-hz: state=ok running=0 waiting=0 "
                            "swapped=0 steps=0 shed=0 preempted=0"])
    status, lines = during
    assert status == 200 and len(lines) == 1
    assert "state=shedding" in lines[0] and "shed=1" in lines[0]
    assert after == (200, [])   # a closed scheduler leaves /healthz


def test_load_provider_reports_waiting_plus_swapped():
    """The load report carries waiting AND swapped work."""
    def run(m):
        srv, _port, sched = m.api.serve_generation(_model(m), max_batch=2,
                                                   name="g-load")
        try:
            bound = srv._load_extra == sched.load_depth
            sched._swapped.append(object())
            depth = (sched.load_depth(), sched.queue_depth())
            sched._swapped.clear()
        finally:
            srv.stop(grace=0)
            sched.close()
        return bound, depth

    assert _same(run) == (True, (1, 0))


def test_load_depth_counts_preempted_swapped_rows():
    """A batch-class row preempted to host on a paged scheduler: while its
    KV sits swapped, ``load_depth`` reports the debt ``queue_depth``
    omits, and the KV arena's swapped gauge reads its blocks."""
    def run(m):
        mgr = m.kv.KvBlockManager(n_blocks=64, block_bytes=256,
                                  kind="local", name="g-loadsig")
        s = m.scheduler.DecodeScheduler(_model(m, step_delay_s=0.002),
                                        kv=mgr, max_batch=1,
                                        idle_wait_s=0.01, name="g-loadsig")
        try:
            long = s.submit([9], max_tokens=4000, slo="batch")
            for _ in range(3):
                long.next(timeout=5)
            quick = s.submit([4], max_tokens=50, slo="interactive")
            assert _poll(lambda: s.swapped_depth() == 1), s.swapped_depth()
            got = (s.load_depth() >= 1, s.queue_depth(),
                   _gauge(m, "kv_blocks_swapped", mgr) >= 1,
                   _gauge(m, "decode_waiting", s))
            quick.cancel()
            long.cancel()
        finally:
            s.close()
            mgr.close()
        return got

    assert _same(run) == (True, 0, True, 0.0)


# ---------------------------------------------------------------------------
# The KV plane (twins of tests/test_kv.py)
# ---------------------------------------------------------------------------

def _mgr(m, **kw):
    kw.setdefault("n_blocks", 64)
    kw.setdefault("block_bytes", 64)   # 4 entries per block
    kw.setdefault("kind", "local")
    return m.kv.KvBlockManager(**kw)


def test_swap_roundtrip_byte_exact_and_gauged():
    def run(m):
        mgr = _mgr(m, name="g-swap")
        swaps0 = m.metrics.counter("kv_swaps").snapshot()
        try:
            kv, _ = mgr.alloc_for_prompt(7, np.asarray([1], np.int32))
            for i in range(11):
                kv.append(i * 31, i, 0)
            used0 = mgr.used_count()
            mgr.swap_out(kv)
            out = (kv.swapped, len(kv.blocks), used0 - mgr.used_count(),
                   mgr.swapped_count(),
                   _gauge(m, "kv_blocks_swapped", mgr),
                   _gauge(m, "kv_blocks_used", mgr), kv.entry(10))
            mgr.swap_in(kv)
            back = (kv.swapped, mgr.swapped_count(),
                    _gauge(m, "kv_blocks_swapped", mgr),
                    [kv.entry(i) for i in range(11)])
            mgr.free_blocks(kv)
        finally:
            mgr.close()
        return out, back, m.metrics.counter("kv_swaps").snapshot() - swaps0

    out, back, swaps = _same(run)
    assert out == (True, 0, 3, 3, 3.0, 0.0, (310, 10, 0))
    assert back == (False, 0, 0.0, [(i * 31, i, 0) for i in range(11)])
    assert swaps == 1


def test_swap_flight_edges_bracket():
    def run(m):
        mgr = _mgr(m, name="g-edges")
        try:
            kv, _ = mgr.alloc_for_prompt(5, np.asarray([1], np.int32))
            kv.append(1, 1)
            mgr.swap_out(kv)
            mgr.swap_in(kv)
            mgr.free_blocks(kv)
        finally:
            mgr.close()
        evs = m.flight.snapshot()
        assert protocol.check_events(evs, strict=True) == []
        return _events(m, "kv:g-edges")

    assert _same(run) == [("kv-alloc", 1), ("kv-swap-begin", 0),
                          ("kv-swap-end", 0), ("kv-swap-begin", 1),
                          ("kv-alloc", 1), ("kv-swap-end", 1),
                          ("kv-free", 1)]


def test_kv_gauges_registered_and_live():
    def run(m):
        mgr = _mgr(m, n_blocks=16, name="g-gauges")
        try:
            kv, _ = mgr.alloc_for_prompt(1, np.asarray([1], np.int32))
            kv.append(1, 1)
            reg = m.metrics.registry().metrics()
            names = [n for n in ("kv_blocks_used", "kv_blocks_free",
                                 "kv_blocks_swapped", "kv_blocks_quarantined")
                     if n in reg]
            live = [_gauge(m, n, mgr) for n in names]
            mgr.quarantine(mgr.alloc_blocks(2, 1))
            quar = _gauge(m, "kv_blocks_quarantined", mgr)
            mgr.free_blocks(kv)
        finally:
            mgr.close()
        return names, live, quar, reg["kv_blocks_used"].collect()[0] >= 0

    names, live, quar, summed = _same(run)
    assert names == ["kv_blocks_used", "kv_blocks_free", "kv_blocks_swapped",
                     "kv_blocks_quarantined"]
    assert live == [1.0, 15.0, 0.0, 0.0] and quar == 1.0 and summed


def test_healthz_shows_kv_lines():
    def run(m):
        mgr = _mgr(m, n_blocks=16, name="g-hzkv")
        try:
            kv, _ = mgr.alloc_for_prompt(1, np.asarray([1], np.int32))
            kv.append(1, 1)
            during = _health_lines(m, "kv g-hzkv:")
            mgr.free_blocks(kv)
        finally:
            mgr.close()
        return during, _health_lines(m, "kv g-hzkv:")

    during, after = _same(run)
    assert during == (200, ["kv g-hzkv: used=1/16 free=15 swapped=0 "
                            "quarantined=0 prefix_hits=0"])
    assert after == (200, [])   # a closed arena leaves /healthz


def test_watchdog_names_kv_swap_stage():
    """A swap-in wedged between its ``KV_SWAP_BEGIN`` and its block
    allocation (each package's own edge) is the ``kv-swap`` stage."""
    def run(m):
        mgr = _mgr(m, name="g-wdswap")
        wd = _watchdog(m)
        hold = threading.Event()
        kv, _ = mgr.alloc_for_prompt(42, np.asarray([1], np.int32))
        kv.append(1, 1)
        mgr.swap_out(kv)
        inner = mgr.alloc_blocks

        def wedged(owner, n):
            hold.wait(WAIT)
            return inner(owner, n)
        mgr.alloc_blocks = wedged
        t = threading.Thread(target=mgr.swap_in, args=(kv,), daemon=True)
        try:
            tok = wd.call_started("/tpurpc.Generate/Generate")
            t.start()
            assert _poll(lambda: ("kv-swap-begin", 1)
                         in _events(m, "kv:g-wdswap"))
            time.sleep(0.35)
            diags = wd.sweep_once()
            hold.set()
            t.join(WAIT)
            wd.call_finished(tok)
            restored = kv.entry(0)
            mgr.free_blocks(kv)
        finally:
            hold.set()
            mgr.close()
            _stop_watchdog(wd)
        return ([d["stage"] for d in diags], "swap" in diags[0]["detail"],
                restored)

    stages, swap, restored = _same(run)
    assert stages[:1] == ["kv-swap"] and swap and restored == (1, 1, 0)


class _DeafPeer:
    """A peer channel whose KV methods never answer until released, then
    fail: a migration's offer waits on it."""

    def __init__(self):
        self.asked = threading.Event()
        self.release = threading.Event()

    def unary_unary(self, path, *_a, **_k):
        def call(req, timeout=None, **_kw):
            self.asked.set()
            self.release.wait(WAIT)
            raise RuntimeError(f"peer gone ({path})")
        return call


def test_watchdog_names_migration_stage():
    """A migration whose peer never answers the offer sits in its
    ``MIG_BEGIN`` bracket (each package's own ``migrate``): the
    ``migration`` stage; released, it fails the sequence alone and closes
    the bracket with ``a2=0``."""
    def run(m):
        srv, _port, sched, state = m.disagg.serve_decode(
            _model(m, step_delay_s=0.005), kv_blocks=64, block_bytes=256,
            kv_kind="local", name="g-wdmig")
        wd = _watchdog(m)
        peer = _DeafPeer()
        out = {}
        try:
            st = sched.submit([5, 6], max_tokens=200)
            st.next(timeout=5)
            tok = wd.call_started("/tpurpc.Kv/ResumeSeq")
            mt = threading.Thread(target=lambda: out.setdefault(
                "r", m.disagg.migrate(state, peer, "127.0.0.1:1")),
                daemon=True)
            mt.start()
            assert peer.asked.wait(WAIT)
            time.sleep(0.35)
            diags = wd.sweep_once()
            peer.release.set()
            mt.join(WAIT)
            with pytest.raises(m.disagg.MigrationFailed):
                while st.next(timeout=5) is not None:
                    pass
            wd.call_finished(tok)
        finally:
            peer.release.set()
            srv.stop(grace=0)
            sched.close()
            state.close()
            state.mgr.close()
            _stop_watchdog(wd)
        evs = m.flight.snapshot()
        protocol.assert_ordered(evs, ["migration-begin",
                                      ("migration-end", {"a2": 0})])
        assert protocol.check_events(evs, strict=False) == []
        return (out.get("r"), [d["stage"] for d in diags],
                [e for e in _events(m, "disagg:g-wdmig")])

    r, stages, edges = _same(run)
    assert r == (0, 1) and stages[:1] == ["migration"]
    assert [e for e, _a2 in edges] == ["migration-begin", "migration-end"]
    assert edges[1] == ("migration-end", 0)


# ---------------------------------------------------------------------------
# Disagg (the protocol checks of tests/test_disagg.py)
# ---------------------------------------------------------------------------

class _Stack:
    """One prefill server and ``n`` decode servers of one package."""

    def __init__(self, m, n_decode=1, step_delay_s=0.0, **kw):
        self.m = m
        self.decodes = [m.disagg.serve_decode(
            _model(m, step_delay_s=step_delay_s), kv_blocks=128,
            block_bytes=256, name=f"g-dec{i}", **kw)
            for i in range(n_decode)]
        self.addr = [f"127.0.0.1:{d[1]}" for d in self.decodes]
        self.d_ch = m.channel.Channel(self.addr[0])
        self.p_srv, self.p_port, self.p_state = m.disagg.serve_prefill(
            _model(m), self.d_ch, self.addr[0])
        self.p_ch = m.channel.Channel(f"127.0.0.1:{self.p_port}")
        self.client = m.disagg.DisaggClient(self.p_ch, self.addr[0],
                                            account="g-acct")
        self.chans = []

    def channel(self, i):
        ch = self.m.channel.Channel(self.addr[i])
        self.chans.append(ch)
        return ch

    def stream(self, out, key, prompt, n):
        def go():
            try:
                out[key] = ("ok", list(self.client.generate_with_meta(
                    prompt, max_tokens=n, timeout=WAIT)))
            except self.m.status.RpcError as exc:
                out[key] = ("err", exc.code().name)
        t = threading.Thread(target=go, daemon=True)
        t.start()
        return t

    def close(self):
        self.client.close()
        self.p_srv.stop(grace=0)
        self.p_state.close()
        for srv, _port, sched, state in self.decodes:
            srv.stop(grace=0)
            sched.close()
            state.close()
            state.mgr.close()
        for ch in [self.p_ch, self.d_ch] + self.chans:
            ch.close()


def test_disagg_handoff_flight_protocol():
    prompt = list(range(20))

    def run(m):
        st = _Stack(m)
        try:
            pairs = list(st.client.generate_with_meta(prompt, max_tokens=12,
                                                      timeout=WAIT))
        finally:
            st.close()
        snap = m.flight.snapshot()
        protocol.assert_ordered(snap, ["kv-ship-offer", "kv-ship-complete"])
        assert protocol.check_events(snap, strict=False) == []
        acct = m.odyssey.accounts_snapshot()["g-acct"]
        return (pairs, _events(m, "disagg:g-dec0"),
                acct["shipped_bytes"], acct["tokens"])

    pairs, edges, shipped, tokens = _same(run)
    assert [t for _i, t in pairs] == reference_decode(prompt, 12)
    # the offer names the bytes to land, the complete the bytes landed
    assert edges == [("kv-ship-offer", 21 * 16), ("kv-ship-complete", 21 * 16)]
    assert (shipped, tokens) == (21 * 16, 11)


def test_disagg_migration_flight_protocol():
    def run(m):
        st = _Stack(m, n_decode=2, step_delay_s=0.003)
        try:
            a, b = st.decodes
            out = {}
            t = st.stream(out, "s", [5, 6], MIG_TOKENS)
            assert _poll(lambda: a[2].running_depth() > 0)
            r = m.disagg.migrate(a[3], st.channel(1), st.addr[1])
            t.join(WAIT)
            assert _poll(lambda: a[3].mgr.used_count() == 0)
        finally:
            st.close()
        snap = m.flight.snapshot()
        protocol.assert_ordered(snap, ["migration-begin",
                                       ("migration-end", {"a2": 1})])
        assert protocol.check_events(snap, strict=False) == []
        return (r, out.get("s"),
                [e for e, _a2 in _events(m, "disagg:g-dec0")
                 if e.startswith("migration")],
                [e for e, _a2 in _events(m, "disagg:g-dec1")])

    r, (kind, pairs), mig, target = _same(run)
    assert r == (1, 0) and kind == "ok"
    assert pairs == list(enumerate(reference_decode([5, 6], MIG_TOKENS)))
    assert mig == ["migration-begin", "migration-end"]
    assert target == ["kv-ship-offer", "kv-ship-complete"]


def test_disagg_death_mid_migration_flight_protocol():
    """The target dies between the one-sided writes and the COMPLETE: the
    failed migration closes its bracket with ``a2=0``, the sibling stream
    finishes, and the dead handoff's blocks are quarantined."""
    def run(m):
        st = _Stack(m, n_decode=2, step_delay_s=0.003)
        try:
            a, b = st.decodes
            out = {}
            t1 = st.stream(out, "victim", [5, 6], 1000)
            assert _poll(lambda: a[2].running_depth() > 0)
            t2 = st.stream(out, "sibling", [7], 30)
            assert _poll(lambda: a[2].running_depth() > 1)
            wedge = threading.Event()
            m.disagg.TEST_HOOKS["wedge_before_complete"] = wedge
            mig = {}
            b_ch = st.channel(1)
            mt = threading.Thread(target=lambda: mig.setdefault(
                "r", m.disagg.migrate(a[3], b_ch, st.addr[1], sids=[1],
                                      timeout_s=5.0)), daemon=True)
            mt.start()
            assert _poll(lambda: b[3].stats()["pending"] >= 1), \
                b[3].stats()
            b[0].stop(grace=0)
            wedge.set()
            mt.join(WAIT)
            t1.join(WAIT)
            t2.join(WAIT)
            nq, _nf = b[3].reap(now=time.monotonic() + 3600)
        finally:
            st.close()
        snap = m.flight.snapshot()
        protocol.assert_ordered(snap, ["migration-begin",
                                       ("migration-end", {"a2": 0})])
        protocol.assert_ordered(snap, ["kv-quarantine"])
        assert protocol.check_events(snap, strict=False) == []
        # (migration-begin's a2 counts the entries decoded so far: the
        # clock's, not the protocol's)
        return (mig.get("r"), out["victim"], out["sibling"], nq >= 1,
                [(e, a2 if e == "migration-end" else None)
                 for e, a2 in _events(m, "disagg:g-dec0")
                 if e.startswith("migration")])

    r, victim, (kind, pairs), quarantined, mig = _same(run)
    assert r == (0, 1) and victim == ("err", "UNAVAILABLE")
    assert kind == "ok" and [v for _i, v in pairs] == \
        reference_decode([7], 30)
    assert quarantined
    assert mig == [("migration-begin", None), ("migration-end", 0)]
