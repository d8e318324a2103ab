"""The generation plane's journeys, token latency and cost ledgers on both
packages: the twins of ``tests/test_odyssey.py``.

Every case runs one scenario on the reference and on the port (each with
its own ``ToyDecodeModel``, scheduler, KV plane, disagg servers, tsdb, SLO
evaluator, scrape routes and collector; the port's model on the CPU), with
the same seeded prompts, and the two observations must be equal: the
tokens (which equal ``reference_decode``), the ledger fields that the
traffic decides (tokens, steps joined, preempts, swaps, migrations,
shipped bytes, outcome), each sequence's flight edges and their order
(checked with the reference's protocol checker, ``tpurpc.analysis.
protocol``; the port's copy is ROADMAP A12), the ITL/TTFT histogram counts
(as deltas: the histograms are process-wide), the ``/debug/seq`` keys, the
account grammar's outputs and the SLO tracks' transitions. What depends on
the clock (microseconds, byte-seconds, percentiles) is held per package to
the reference test's own bounds: at least 95 % of the step time
attributed, the ledgers' ``step_us`` summing to ``step_us_attributed``
within 1 µs, byte-seconds monotone and bounded.

The two-process case starts each package's own prefill child
(``python -m tpurpc_torch.tools.odyssey_smoke --prefill`` for the port)
under the suite's launch lock.

Every plane here is process-wide: each case resets both packages'
ledgers, span buffers, flight rings and watchdogs before and after, and
forgets both SLO evaluators.
"""

import contextlib
import importlib
import json
import os
import selectors
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import torch_ranks
from tpurpc.analysis import protocol
from tpurpc_torch.torchshim.generate import reference_decode

S = int(1e9)
WAIT = 30.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name, root):
    m = SimpleNamespace(name=name, root=root)
    for path in ("obs.odyssey", "obs.flight", "obs.tracing", "obs.slo",
                 "obs.tsdb", "obs.metrics", "obs.scrape", "obs.collector",
                 "obs.watchdog", "serving.scheduler", "serving.kv",
                 "serving.api", "serving.disagg", "rpc.channel"):
        setattr(m, path.split(".")[1],
                importlib.import_module(f"{root}.{path}"))
    shim = "jaxshim" if root == "tpurpc" else "torchshim"
    gen = importlib.import_module(f"{root}.{shim}.generate")
    if root == "tpurpc":
        m.model = gen.ToyDecodeModel
    else:
        m.model = lambda **kw: gen.ToyDecodeModel(device="cpu", **kw)
    return m


REF = _pkg("ref", "tpurpc")
PORT = _pkg("port", "tpurpc_torch")
BOTH = (REF, PORT)


def _reset(m):
    m.flight.RECORDER.reset()
    m.odyssey.reset()
    m.tracing.force(None)
    m.tracing.reset()
    m.watchdog.get().reset()


@pytest.fixture(autouse=True)
def _clean_odyssey_state():
    saved = []
    for m in BOTH:
        _reset(m)
        saved.append(m.scheduler.TokenStream.MAX_IDLE_S)
        m.scheduler.TokenStream.MAX_IDLE_S = 10.0
    yield
    for m, old in zip(BOTH, saved):
        m.scheduler.TokenStream.MAX_IDLE_S = old
        m.slo.reset()
        m.tracing.configure()
        _reset(m)


def _same(run):
    """``run(pkg)`` on both packages, each after a clean slate; the
    observations must be equal."""
    got = {}
    for m in BOTH:
        _reset(m)
        got[m.name] = run(m)
    assert got["ref"] == got["port"], got
    return got["port"]


def _drain(stream):
    return list(stream)


def _wait_done(m, n=1, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = m.odyssey.seq_doc()
        if len(doc["recent"]) >= n and not doc["live"]:
            return doc
        time.sleep(0.01)
    return m.odyssey.seq_doc()


def _hist_count(m, name):
    return m.metrics.histogram(name, kind="latency").snapshot()["count"]


def _ledger(row):
    """The ledger fields that the traffic decides."""
    return {k: row.get(k) for k in ("account", "slo", "tokens", "steps",
                                    "preempts", "swaps", "migrations",
                                    "shipped_bytes", "outcome",
                                    "prompt_len", "state")}


def _attribution(doc):
    """The reference test's conservation bounds, held per package."""
    assert doc["attributed_pct"] is not None
    assert doc["attributed_pct"] >= 95.0, doc["attributed_pct"]
    total = sum(r["step_us"] for r in doc["recent"])
    assert abs(total - doc["step_us_attributed"]) < 1.0, \
        (total, doc["step_us_attributed"])
    assert doc["step_us_total"] > 0


def _events_of(m, entity, since_ns=0):
    return [e for e in m.flight.snapshot(since_ns=since_ns)
            if e["entity"] == entity]


# ---------------------------------------------------------------------------
# Token-latency plane
# ---------------------------------------------------------------------------

def test_itl_matches_reference_step_timing():
    """ITL at the stream edge is the step cadence of the deterministic
    model: one token per ``step_delay_s`` step."""
    step_s = 0.02

    def run(m):
        itl0 = _hist_count(m, "gen_itl_interactive_us")
        ttft0 = _hist_count(m, "gen_ttft_us")
        tpot0 = _hist_count(m, "gen_tpot_interactive_us")
        sched = m.scheduler.DecodeScheduler(
            m.model(step_delay_s=step_s), max_batch=4, name="t-itl")
        try:
            toks = _drain(sched.submit([1, 2, 3], max_tokens=10,
                                       account="t-itl"))
            doc = _wait_done(m)
        finally:
            sched.close()
        p99 = doc["itl_p99_rolling_us"]["interactive"]
        assert step_s * 1e6 * 0.5 < p99 < step_s * 1e6 * 3, p99
        led = doc["recent"][0]
        assert led["tpot_us"] > step_s * 1e6 * 0.5
        return (toks, _ledger(led), "ttft_us" in led,
                _hist_count(m, "gen_itl_interactive_us") - itl0,
                _hist_count(m, "gen_ttft_us") - ttft0,
                _hist_count(m, "gen_tpot_interactive_us") - tpot0,
                doc["itl_p99_rolling_us"]["batch"],
                doc["ttft_p99_rolling_us"]["batch"])

    toks, led, ttft, itl, ttft_n, tpot, b_itl, b_ttft = _same(run)
    assert toks == reference_decode(np.asarray([1, 2, 3], np.int32), 10)
    assert led["tokens"] == 10 and led["steps"] == 9 and ttft
    # 10 tokens: one first token (TTFT) and 9 gaps (ITL), one TPOT
    assert (itl, ttft_n, tpot) == (9, 1, 1)
    assert b_itl is None and b_ttft is None


def test_step_time_attribution_conserves():
    """Every device-step microsecond lands on exactly one set of
    sequences, in each package."""
    def run(m):
        sched = m.scheduler.DecodeScheduler(
            m.model(step_delay_s=0.002), max_batch=4, name="t-attr")
        try:
            streams = [sched.submit([i + 1], max_tokens=8, account="t-a")
                       for i in range(3)]
            toks = [_drain(st) for st in streams]
            doc = _wait_done(m, 3)
        finally:
            sched.close()
        _attribution(doc)
        return toks, sorted((r["sid"], r["tokens"], r["steps"], r["outcome"])
                            for r in doc["recent"])

    toks, rows = _same(run)
    assert toks == [reference_decode([i + 1], 8) for i in range(3)]
    assert rows == [(1, 8, 7, "retire"), (2, 8, 7, "retire"),
                    (3, 8, 7, "retire")]


def test_account_rollup_and_anon_default():
    def run(m):
        sched = m.scheduler.DecodeScheduler(m.model(), max_batch=4,
                                            name="t-acct")
        try:
            _drain(sched.submit([1], max_tokens=4, account="tenant-a"))
            _drain(sched.submit([2], max_tokens=4, account="tenant-a"))
            _drain(sched.submit([3], max_tokens=4))  # no account -> anon
            doc = _wait_done(m, 3)
        finally:
            sched.close()
        accts = doc["accounts"]
        assert accts["tenant-a"]["step_us"] > 0
        return {a: {k: v for k, v in b.items()
                    if k not in ("step_us", "prefill_us", "kv_byte_s",
                                 "swap_byte_s")}
                for a, b in accts.items()}

    accts = _same(run)
    assert accts["tenant-a"]["seqs"] == 2
    assert accts["tenant-a"]["tokens"] == 8
    assert accts["anon"]["seqs"] == 1


ACCOUNT_INPUTS = [None, "", "team-a.prod:v2", b"bytes-ok", bytearray(b"ba"),
                  memoryview(b"mv:1"), "has space/slash", "x" * 200,
                  "y" * 64, "tab\tand\nnewline", "ünïcode", "a/b\\c?d=e",
                  b"\xff\xfe"]


def test_account_key_grammar():
    got = {m.name: [m.odyssey.sanitize_account(v) for v in ACCOUNT_INPUTS]
           for m in BOTH}
    assert got["ref"] == got["port"], got
    out = got["port"]
    assert out[:8] == ["anon", "anon", "team-a.prod:v2", "bytes-ok", "ba",
                       "mv:1", "has_space_slash", "x" * 64]
    assert len(out[8]) == 64
    assert all(m.odyssey.ACCOUNT_KEY == "tpurpc-account" for m in BOTH)


# ---------------------------------------------------------------------------
# Ledger conservation across preempt / swap / migrate
# ---------------------------------------------------------------------------

def _paged_sched(m, name, **kw):
    mgr = m.kv.KvBlockManager(n_blocks=64, block_bytes=256, name=name)
    kw.setdefault("max_batch", 1)
    sched = m.scheduler.DecodeScheduler(m.model(step_delay_s=0.005),
                                        kv=mgr, name=name, **kw)
    return sched, mgr


def test_kv_byte_seconds_monotone_across_preempt_swap():
    """A preempted-and-swapped sequence's ledger: arena byte-seconds stop
    growing while swapped (swap byte-seconds grow instead), both are
    monotone and neither interval is double-counted."""
    def run(m):
        sched, mgr = _paged_sched(m, "t-swap")
        try:
            t_start = time.monotonic()
            batch_st = sched.submit([1] * 40, max_tokens=60,
                                    slo="batch", account="t-batch")
            for _ in range(5):
                batch_st.next(timeout=2.0)
            reads = []
            inter_st = sched.submit([2, 3], max_tokens=20, account="t-int")
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                doc = m.odyssey.seq_doc({"account": "t-batch", "n": "4"})
                rows = doc["live"] or doc["recent"]
                if rows:
                    reads.append((rows[0]["kv_byte_s"],
                                  rows[0]["swap_byte_s"]))
                    if rows[0].get("state") == "done":
                        break
                time.sleep(0.01)
            toks_i = _drain(inter_st)
            rest_b = _drain(batch_st)
            doc = _wait_done(m, 2)
            dur_s = time.monotonic() - t_start
            bound = mgr.n_blocks * mgr.block_bytes * dur_s
        finally:
            sched.close()
            mgr.close()
        led = [r for r in doc["recent"] if r["account"] == "t-batch"][0]
        assert led["swap_byte_s"] > 0 and led["kv_byte_s"] > 0, led
        for (a0, s0), (a1, s1) in zip(reads, reads[1:]):
            assert a1 >= a0 - 1e-6 and s1 >= s0 - 1e-6, reads
        assert led["kv_byte_s"] + led["swap_byte_s"] < bound
        return (toks_i, len(rest_b),
                sorted(_ledger(r).items() for r in doc["recent"]))

    toks_i, rest, ledgers = _same(run)
    assert toks_i == reference_decode([2, 3], 20) and rest == 55
    by = {dict(r)["account"]: dict(r) for r in ledgers}
    assert (by["t-batch"]["preempts"], by["t-batch"]["swaps"]) == (1, 2)
    assert by["t-int"]["preempts"] == 0


def test_shed_and_refused_settle_ledgers():
    def run(m):
        sched = m.scheduler.DecodeScheduler(
            m.model(step_delay_s=0.05), max_batch=1, max_waiting=1,
            name="t-shed")
        try:
            st = sched.submit([1] * 4, max_tokens=30, account="t-ok")
            st.next(timeout=2.0)  # running now, not waiting
            q = sched.submit([2], max_tokens=4, account="t-q")
            with pytest.raises(m.scheduler.ShedError):
                sched.submit([3], max_tokens=4, account="t-shed")
            q.cancel()
            st.cancel()
            accts = m.odyssey.accounts_snapshot()
            shed_ev = [(e["event"], e["a1"])
                       for e in _events_of(m, "decode:t-shed")
                       if e["event"] == "gen-shed"]
        finally:
            sched.close()
        return (accts["t-shed"]["sheds"], accts["t-shed"]["seqs"],
                accts["t-shed"]["tokens"], shed_ev)

    assert _same(run) == (1, 1, 0, [("gen-shed", 0)])


# ---------------------------------------------------------------------------
# Journey tracing
# ---------------------------------------------------------------------------

def test_journey_spans_single_trace_in_process():
    def run(m):
        m.tracing.force(True)
        ctx = m.tracing.TraceContext(0xABCD1234, 1)
        sched = m.scheduler.DecodeScheduler(
            m.model(step_delay_s=0.002), max_batch=4, name="t-jrny")
        try:
            _drain(sched.submit([5, 6], max_tokens=6, trace=ctx,
                                account="t-j"))
            _wait_done(m)
        finally:
            sched.close()
        spans = m.tracing.spans(ctx.trace_id)
        dec = [s for s in spans if s["name"] == "seq-decode"][0]
        return (sorted({s["name"] for s in spans}),
                {s["trace_id"] for s in spans},
                dec["attrs"]["account"], dec["attrs"]["tokens"])

    names, tids, account, tokens = _same(run)
    for needed in ("seq-admit", "seq-prefill", "seq-decode"):
        assert needed in names, names
    assert tids == {f"{0xABCD1234:016x}"}
    assert (account, tokens) == ("t-j", 6)


def test_tail_commit_rules_interesting_journeys():
    """Tail-only capture: a preempted sequence's provisional journey
    commits, a fast clean one ages out."""
    def run(m):
        m.tracing.force(None)
        m.tracing.configure(0.0)  # no head sampling; tail capture stays on
        assert m.tracing.LIVE and not m.tracing.ACTIVE
        sched, mgr = _paged_sched(m, "t-tail")
        try:
            ctx_b = m.tracing.maybe_sample()
            assert ctx_b is not None and ctx_b.provisional
            batch_st = sched.submit([1] * 8, max_tokens=40, slo="batch",
                                    trace=ctx_b, account="t-b")
            for _ in range(3):
                batch_st.next(timeout=2.0)
            ctx_i = m.tracing.TraceContext(0x77, 1, provisional=True)
            m.tracing._tail_register(ctx_i.trace_id)
            inter_st = sched.submit([2], max_tokens=3, trace=ctx_i,
                                    account="t-i")
            _drain(inter_st)
            _drain(batch_st)
            _wait_done(m, 2)
        finally:
            sched.close()
            mgr.close()
        committed = {s["name"] for s in m.tracing.spans(ctx_b.trace_id)}
        return ("seq-decode" in committed,
                m.tracing.spans(ctx_i.trace_id),
                m.tracing.tail_pending(ctx_i.trace_id) > 0)

    assert _same(run) == (True, [], True)


def test_flight_journey_order_and_strict_conformance():
    def run(m):
        t0 = time.monotonic_ns()
        sched = m.scheduler.DecodeScheduler(
            m.model(step_delay_s=0.002), max_batch=2, name="t-fl")
        try:
            _drain(sched.submit([1, 2], max_tokens=5, account="t-f"))
            _wait_done(m)
        finally:
            sched.close()
        events = m.flight.snapshot(since_ns=t0)
        assert protocol.check_events(events, strict=True) == []
        protocol.assert_ordered(events, [
            ("seq-submit", {"a2": 2}), "gen-join", "seq-first-token",
            "gen-retire",
        ], since_ns=t0)
        # a2 of seq-first-token is the TTFT in microseconds: the clock's
        return [(e["event"], e["a1"],
                 None if e["event"] == "seq-first-token" else e["a2"])
                for e in _events_of(m, "decode:t-fl", t0)]

    edges = _same(run)
    # one sequence, five tokens: a prefill join, then four decode steps
    assert [e for e, _a1, _a2 in edges] == (
        ["seq-submit", "gen-join", "seq-first-token"]
        + ["gen-step-begin", "gen-step-end"] * 3
        + ["gen-step-begin", "gen-retire", "gen-step-end"])


def test_seq_journey_mutants_killed():
    """Each package's real sequence stream passes the sequence machine;
    the reference's two seeded mutants, built from that stream (a token
    after the retire, a join without its submit), are caught."""
    def run(m):
        sched = m.scheduler.DecodeScheduler(m.model(), max_batch=2,
                                            name="t-mut")
        try:
            _drain(sched.submit([4, 5], max_tokens=3, account="t-m"))
            _wait_done(m)
        finally:
            sched.close()
        clean = [e for e in _events_of(m, "decode:t-mut")
                 if not e["event"].startswith("gen-step")]
        first = next(e for e in clean if e["event"] == "seq-first-token")
        late = dict(first, t_ns=clean[-1]["t_ns"] + 1)
        muts = {"seq_token_after_retire": clean + [late],
                "seq_join_without_submit": [e for e in clean
                                            if e["event"] != "seq-submit"]}
        return ([e["event"] for e in clean],
                protocol.check_events(clean, strict=True) == [],
                {k: bool(protocol.check_events(v, strict=True))
                 for k, v in muts.items()})

    events, clean_ok, killed = _same(run)
    assert events == ["seq-submit", "gen-join", "seq-first-token",
                      "gen-retire"]
    assert clean_ok
    assert killed == {"seq_token_after_retire": True,
                      "seq_join_without_submit": True}
    kills = protocol.mutant_kill_suite()
    assert kills["seq_token_after_retire"]
    assert kills["seq_join_without_submit"]


# ---------------------------------------------------------------------------
# Disagg: the journey crosses the split; migration settles the ledger
# ---------------------------------------------------------------------------

class _Held:
    """Parks a model's decode steps (paged contract) until released."""

    def __init__(self, model):
        self.model = model
        self._cv = threading.Condition()
        self._open = False
        self.steps = 0
        inner = model.step_paged

        def step_paged(kvs, tokens):
            with self._cv:
                self.steps += 1
                self._cv.notify_all()
                deadline = time.monotonic() + WAIT
                while not self._open:
                    left = deadline - time.monotonic()
                    assert left > 0, "held step never released"
                    self._cv.wait(left)
            return inner(kvs, tokens)
        model.step_paged = step_paged

    def wait_steps(self, n):
        with self._cv:
            deadline = time.monotonic() + WAIT
            while self.steps < n:
                left = deadline - time.monotonic()
                assert left > 0, f"step {n} never reached"
                self._cv.wait(left)

    def release(self):
        with self._cv:
            self._open = True
            self._cv.notify_all()


def _wait(pred, what):
    ev = threading.Event()
    for _ in range(int(WAIT / 0.005)):
        if pred():
            return
        ev.wait(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def test_journey_and_ledger_across_migration():
    """An in-process disagg pair: one trace id carries seq-ship (the
    handoff), seq-resume/seq-decode (decode A), seq-migrate (the hop) and
    the adopted sequence's decode spans on B; the source ledger settles
    ``migrated`` with its shipped bytes, and the account rollup sums both
    halves. Decode A's second step parks until the migration has asked
    for the sequence, so the hop lands at the same token in both
    packages."""
    prompt = np.arange(64, dtype=np.int32) % 31

    def run(m):
        m.tracing.force(True)
        held = _Held(m.model())
        a = m.disagg.serve_decode(held.model, kv_blocks=96, block_bytes=256,
                                  name="t-migA")
        b = m.disagg.serve_decode(m.model(), kv_blocks=96, block_bytes=256,
                                  name="t-migB")
        a_addr, b_addr = (f"127.0.0.1:{a[1]}", f"127.0.0.1:{b[1]}")
        d_ch = m.channel.Channel(a_addr)
        b_ch = m.channel.Channel(b_addr)
        p_srv, p_port, p_state = m.disagg.serve_prefill(m.model(), d_ch,
                                                        a_addr)
        p_ch = m.channel.Channel(f"127.0.0.1:{p_port}")
        cli = m.disagg.DisaggClient(p_ch, a_addr, account="t-mig")
        ctx = m.tracing.TraceContext(0xFEED0001, 1)
        out, box = {}, {}
        try:
            def go():
                with m.tracing.use(ctx):
                    out["pairs"] = list(cli.generate_with_meta(
                        prompt, max_tokens=32, timeout=WAIT))
            t = threading.Thread(target=go, daemon=True)
            t.start()
            held.wait_steps(1)
            mt = threading.Thread(target=lambda: box.setdefault(
                "r", m.disagg.migrate(a[3], b_ch, b_addr)), daemon=True)
            mt.start()
            _wait(lambda: a[2]._detach_req, "the migration's detach")
            held.release()
            mt.join(WAIT)
            t.join(WAIT)
            doc = _wait_done(m, 2, timeout=8.0)
        finally:
            held.release()
            cli.close()
            p_srv.stop(grace=0)
            p_state.close()
            for srv, _p, sched, state in (a, b):
                srv.stop(grace=0)
                sched.close()
                state.close()
                state.mgr.close()
            for ch in (p_ch, d_ch, b_ch):
                ch.close()
        names = sorted({s["name"] for s in m.tracing.spans(ctx.trace_id)})
        rows = {r["outcome"]: r for r in doc["recent"]
                if r["account"] == "t-mig"}
        acct = doc["accounts"]["t-mig"]
        return (box.get("r"), out.get("pairs"), names,
                {k: _ledger(r) for k, r in rows.items()},
                {k: r.get("trace_id") for k, r in rows.items()},
                {k: acct[k] for k in ("seqs", "tokens", "migrations",
                                      "shipped_bytes", "preempts")})

    r, pairs, names, ledgers, tids, acct = _same(run)
    assert r == (1, 0)
    assert pairs == list(enumerate(reference_decode(prompt, 32)))
    for needed in ("seq-ship", "seq-resume", "seq-decode", "seq-migrate"):
        assert needed in names, names
    src, dst = ledgers["migrated"], ledgers["retire"]
    assert src["migrations"] == 1
    # the handoff's 65 entries (prompt + first sample), then the hop's 66
    # (one decode step on A, the one parked while the migration asked)
    assert src["shipped_bytes"] == 65 * 16 + 66 * 16
    assert dst["shipped_bytes"] == 66 * 16
    assert tids == {"migrated": f"{0xFEED0001:016x}",
                    "retire": f"{0xFEED0001:016x}"}
    assert acct["migrations"] == 1 and acct["tokens"] == 31


def _spawn_prefill(m, decode_addr):
    """The package's prefill child (its own odyssey smoke's ``--prefill``),
    on the CPU at a lower priority; ``(process, port)``."""
    env = dict(os.environ, TPURPC_TORCH_DEVICE="cpu",
               TPURPC_TRACE_SAMPLE="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import os, runpy, sys; os.nice(10); "
            f"sys.argv = ['odyssey_smoke', '--prefill', {decode_addr!r}]; "
            f"runpy.run_module('{m.root}.tools.odyssey_smoke', "
            "run_name='__main__')")
    child = subprocess.Popen([sys.executable, "-c", code],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, env=env, text=True)
    sel = selectors.DefaultSelector()
    sel.register(child.stdout, selectors.EVENT_READ)
    if not sel.select(timeout=120):
        child.kill()
        raise AssertionError("prefill child never printed its port: "
                             + child.stderr.read()[:2000])
    line = child.stdout.readline().strip()
    assert line.startswith("PORT "), (line, child.stderr.read()[:2000])
    return child, int(line.split()[1])


@contextlib.contextmanager
def _launch_lock():
    fd = torch_ranks._lock()
    try:
        yield
    finally:
        torch_ranks._unlock(fd)


def test_journey_across_two_real_processes():
    """The disagg split with the prefill tier in a real child process: the
    child's /traces carries spans of the same trace id the parent's decode
    journey used, and the merged journey has two anchored lanes."""
    import urllib.request

    prompt = np.arange(48, dtype=np.int32) % 23

    def run(m):
        m.tracing.force(True)
        d_srv, d_port, d_sched, d_state = m.disagg.serve_decode(
            m.model(), kv_blocks=96, block_bytes=256, kv_kind="shm",
            name="t-twoproc")
        child = None
        try:
            with _launch_lock():
                child, p_port = _spawn_prefill(m, f"127.0.0.1:{d_port}")
                p_ch = m.channel.Channel(f"127.0.0.1:{p_port}")
                cli = m.disagg.DisaggClient(p_ch, f"127.0.0.1:{d_port}",
                                            account="t-2p")
                try:
                    ctx = m.tracing.TraceContext(0xFEED0002, 1)
                    with m.tracing.use(ctx):
                        pairs = list(cli.generate_with_meta(
                            prompt, max_tokens=8, timeout=WAIT))
                    local = {s["name"]
                             for s in m.tracing.spans(ctx.trace_id)}
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{p_port}/traces?trace_id="
                            f"{ctx.trace_id:016x}", timeout=5) as resp:
                        peer = json.loads(resp.read())
                    doc = m.odyssey.journey(
                        [f"127.0.0.1:{d_port}", f"127.0.0.1:{p_port}"],
                        ctx.trace_id)
                finally:
                    cli.close()
                    p_ch.close()
        finally:
            if child is not None:
                try:
                    child.stdin.close()
                    child.wait(timeout=10)
                except Exception:
                    child.kill()
                    child.wait(timeout=10)
                child.stdout.close()
                child.stderr.close()
            d_srv.stop(grace=0)
            d_sched.close()
            d_state.close()
            d_state.mgr.close()
        peer_spans = sorted({e["name"] for e in peer["traceEvents"]
                             if e.get("ph") == "X"})
        x_pids = {e["pid"] for e in doc["traceEvents"] if e.get("ph") == "X"}
        return (pairs, "seq-ship" in local, "seq-decode" in local,
                bool(peer_spans), bool(peer.get("clock_anchor")),
                doc["otherData"]["lanes"], doc["otherData"]["unanchored"],
                len(x_pids), doc["trace_id"])

    got = _same(run)
    assert got[0] == list(enumerate(reference_decode(prompt, 8)))
    assert got[1:] == (True, True, True, True, 2, [], 2,
                       f"{0xFEED0002:016x}")


# ---------------------------------------------------------------------------
# SLO track kinds: ITL / TTFT burn-rate objectives
# ---------------------------------------------------------------------------

def _private_db(m, **kw):
    reg = m.metrics.Registry()
    kw.setdefault("fine_s", 1.0)
    kw.setdefault("fine_window_s", 32.0)
    kw.setdefault("coarse_s", 8.0)
    kw.setdefault("coarse_window_s", 64.0)
    return m.tsdb.Tsdb(registry=reg, **kw)


def test_slo_itl_objective_pending_firing_resolved():
    def run(m):
        db = _private_db(m)
        g = db._registry.gauge("gen_itl_p99_us{interactive}")
        ev = m.slo.SloEvaluator(eval_s=1.0, tsdb=db)
        obj = ev.declare(m.slo.SloObjective(
            "tok-itl", itl_ms=5.0, token_target_pct=50.0,
            windows=[(4.0, 8.0, 2.0)]))
        st = obj.tracks["itl"]
        states = []
        # healthy 1 ms ITL for 10 s, degraded 40 ms for 20 s, healthy again
        for t in range(1, 61):
            g.set(40_000.0 if 10 < t <= 30 else 1000.0)
            db.sample_once(now_ns=t * S)
            ev.evaluate_once(now_ns=t * S)
            if not states or states[-1][1] != st.state:
                states.append((t, st.state))
        evs = [(e["event"], e["a1"]) for e in m.flight.snapshot()
               if e["entity"] == "slo:tok-itl"]
        assert protocol.check_events(m.flight.snapshot(),
                                     strict=False) == []
        return (obj._threshold_tracks["itl"], states,
                [(h["from"], h["to"]) for h in ev.doc()["history"]], evs)

    thr, states, hist, evs = _same(run)
    assert thr[0] == "gen_itl_p99_us{interactive}"
    assert [s for _t, s in states] == ["ok", "pending", "firing", "ok"]
    assert hist == [("ok", "pending"), ("pending", "firing"),
                    ("firing", "ok")]
    assert evs == [("slo-firing", 4), ("slo-resolved", 4)]


def test_slo_ttft_track_and_doc_shape():
    def run(m):
        db = _private_db(m)
        db._registry.gauge("gen_ttft_p99_us{batch}").set(100.0)
        ev = m.slo.SloEvaluator(eval_s=1.0, tsdb=db)
        obj = ev.declare(m.slo.SloObjective(
            "tok-ttft", ttft_ms=200.0, slo_class="batch",
            windows=[(4.0, 8.0, 2.0)]))
        doc = ev.doc()["objectives"][0]
        return (sorted(obj.tracks), obj._threshold_tracks["ttft"],
                m.slo.TRACK_CODES["ttft"], doc["ttft_ms"], doc["slo_class"],
                sorted(doc))

    tracks, thr, code, ttft_ms, klass, _keys = _same(run)
    assert tracks == ["ttft"]
    assert thr == ("gen_ttft_p99_us{batch}", 200_000.0)
    assert (code, ttft_ms, klass) == (3, 200.0, "batch")


def test_tsdb_samples_odyssey_rolling_series():
    """Each package's process-wide tsdb picks up its odyssey rolling p99s
    (the ``sys.modules``-gated hook) once tokens have flowed."""
    def run(m):
        sched = m.scheduler.DecodeScheduler(
            m.model(step_delay_s=0.002), max_batch=2, name="t-roll")
        try:
            _drain(sched.submit([1], max_tokens=6, account="t-r"))
            _wait_done(m)
        finally:
            sched.close()
        roll = m.odyssey.rolling_series()
        db = m.tsdb.get()
        db.sample_once()
        series = db.series()
        return (sorted(roll),
                "gen_itl_p99_us{interactive}" in series,
                "gen_ttft_p99_us{interactive}" in series)

    assert _same(run) == (["gen_itl_p99_us{interactive}",
                           "gen_ttft_p99_us{interactive}"], True, True)


# ---------------------------------------------------------------------------
# Routes, merges, off-switch
# ---------------------------------------------------------------------------

def test_debug_seq_route_filters_and_bounds():
    def run(m):
        sched = m.scheduler.DecodeScheduler(m.model(), max_batch=4,
                                            name="t-route")
        try:
            _drain(sched.submit([1], max_tokens=4, account="t-x"))
            _drain(sched.submit([2], max_tokens=4, account="t-y"))
            _wait_done(m, 2)
        finally:
            sched.close()
        status, ctype, body = m.scrape.route_local("/debug/seq")
        doc = json.loads(body)
        _s, _c, fbody = m.scrape.route_local("/debug/seq?account=t-x&n=1")
        filt = json.loads(fbody)
        _s, _c, miss = m.scrape.route_local("/nope")
        return (status, ctype, doc["enabled"], sorted(doc),
                sorted(doc["accounts"]), sorted(doc["recent"][0]),
                sorted(doc["accounts"]["t-x"]), sorted(doc["itl"]),
                [r["account"] for r in filt["recent"]], filt["live_total"],
                b"/debug/seq" in miss)

    got = _same(run)
    assert got[:3] == (200, "application/json", True)
    assert {"t-x", "t-y"} <= set(got[4])
    assert got[8] == ["t-x"] and got[10]


def test_off_switch_env_and_force(monkeypatch):
    def run(m):
        m.odyssey.force(False)
        assert not m.odyssey.ACTIVE
        sched = m.scheduler.DecodeScheduler(m.model(), max_batch=2,
                                            name="t-off")
        try:
            t0 = time.monotonic_ns()
            toks = _drain(sched.submit([1, 2], max_tokens=4,
                                       account="t-off"))
        finally:
            sched.close()
        doc = m.odyssey.seq_doc()
        names = [e["event"] for e in _events_of(m, "decode:t-off", t0)]
        m.odyssey.force(None)
        monkeypatch.setenv("TPURPC_ODYSSEY", "0")
        m.odyssey.configure()
        off = m.odyssey.ACTIVE
        monkeypatch.delenv("TPURPC_ODYSSEY")
        m.odyssey.configure()
        return (toks, doc, "seq-submit" in names,
                "seq-first-token" in names, off, m.odyssey.ACTIVE)

    toks, doc, sub, first, off, on = _same(run)
    assert toks == reference_decode([1, 2], 4)
    assert doc == {"enabled": False, "reason": "TPURPC_ODYSSEY=0"}
    assert (sub, first, off, on) == (True, True, False, True)


def test_merge_seq_docs_sums_accounts_and_tags_rows():
    d1 = {"enabled": True,
          "live": [{"sid": 1, "account": "a", "step_us": 50.0}],
          "recent": [{"sid": 2, "account": "a", "step_us": 10.0}],
          "accounts": {"a": {"seqs": 2, "tokens": 10, "step_us": 60.0,
                             "kv_byte_s": 1.0}},
          "step_us_total": 100.0, "step_us_attributed": 98.0}
    d2 = {"enabled": True, "live": [],
          "recent": [{"sid": 9, "account": "a", "step_us": 70.0}],
          "accounts": {"a": {"seqs": 1, "tokens": 5, "step_us": 70.0},
                       "b": {"seqs": 1, "tokens": 2, "step_us": 5.0}},
          "step_us_total": 80.0, "step_us_attributed": 80.0}

    def run(m):
        out = m.odyssey.merge_seq_docs({"0": d1, "1": d2}, label="shard")
        off = m.odyssey.merge_seq_docs({"0": {"enabled": False}})
        return out, off

    out, off = _same(run)
    assert out["enabled"]
    assert out["accounts"]["a"]["seqs"] == 3
    assert out["accounts"]["a"]["tokens"] == 15
    assert out["accounts"]["b"]["seqs"] == 1
    assert out["step_us_total"] == 180.0
    assert out["attributed_pct"] == round(178 / 180 * 100, 2)
    assert out["live"][0]["shard"] == "0"
    assert {r["shard"] for r in out["recent"]} == {"0", "1"}
    assert off["enabled"] is False


def test_collector_fleet_seq_member_merge():
    def run(m):
        srv, port, sched = m.api.serve_generation(m.model(), max_batch=4,
                                                  name="t-fleet")
        member = f"127.0.0.1:{port}"
        try:
            with m.channel.Channel(member) as ch:
                gen = m.api.GenerationClient(ch, name="t-fleet",
                                             account="t-fleet")
                toks = list(gen.generate([3, 4], max_tokens=5, timeout=20))
            _wait_done(m)
            col = m.collector.FleetCollector([member], poll_s=60)
            col.poll_once()
            status, ctype, body = col.route("/fleet/seq")
            _s, _c, miss = col.route("/nope")
        finally:
            srv.stop(grace=0)
            sched.close()
        doc = json.loads(body)
        return (toks, status, ctype, doc["enabled"],
                doc["accounts"]["t-fleet"]["tokens"],
                doc["members"] == {member: "up"},
                all(r["member"] == member for r in doc["recent"]),
                doc["sources"] == [member], b"/fleet/seq" in miss)

    got = _same(run)
    assert got[0] == reference_decode([3, 4], 5)
    assert got[1:] == (200, "application/json", True, 5, True, True, True,
                       True)


def test_generation_rpc_attaches_account_and_trace():
    """Over the RPC face: the ``tpurpc-account`` metadata key and the
    call's (tail-provisional) trace context reach the ledger."""
    def run(m):
        srv, port, sched = m.api.serve_generation(m.model(), max_batch=4,
                                                  name="t-rpc")
        try:
            with m.channel.Channel(f"127.0.0.1:{port}") as ch:
                gen = m.api.GenerationClient(ch, name="t-rpc")
                toks = list(gen.generate([1, 2], max_tokens=4,
                                         account="t-rpc", timeout=20))
            doc = _wait_done(m)
        finally:
            srv.stop(grace=0)
            sched.close()
        led = [r for r in doc["recent"] if r["account"] == "t-rpc"]
        return toks, [_ledger(r) for r in led], ["trace_id" in r
                                                 for r in led]

    toks, ledgers, traced = _same(run)
    assert toks == reference_decode([1, 2], 4)
    assert [r["tokens"] for r in ledgers] == [4] and traced == [True]


def test_overall_token_histograms_are_the_ports_own():
    """A divergence kept on purpose (ROADMAP C): the reference's docstring
    names the overall ``gen_itl_us``/``gen_tpot_us`` histograms but it
    registers only the per-class ones; the port registers both, and the
    overall ones move by the classes' sum."""
    names = ("gen_itl_us", "gen_tpot_us", "gen_itl_interactive_us",
             "gen_itl_batch_us", "gen_tpot_interactive_us",
             "gen_tpot_batch_us")
    before = {n: _hist_count(PORT, n) for n in names}
    sched = PORT.scheduler.DecodeScheduler(
        PORT.model(step_delay_s=0.002), max_batch=4, name="t-overall")
    try:
        toks = [_drain(sched.submit([7 + i], max_tokens=5, slo=slo,
                                    account="t-o"))
                for i, slo in enumerate(("interactive", "batch"))]
        _wait_done(PORT, 2)
    finally:
        sched.close()
    d = {n: _hist_count(PORT, n) - before[n] for n in names}
    assert toks == [reference_decode([7], 5), reference_decode([8], 5)]
    assert (d["gen_itl_interactive_us"], d["gen_itl_batch_us"]) == (4, 4)
    assert d["gen_itl_us"] == 8 and d["gen_tpot_us"] == 2
    assert (d["gen_tpot_interactive_us"], d["gen_tpot_batch_us"]) == (1, 1)
    reg = REF.metrics.registry().metrics()
    assert "gen_itl_interactive_us" in reg
    assert "gen_itl_us" not in reg and "gen_tpot_us" not in reg
