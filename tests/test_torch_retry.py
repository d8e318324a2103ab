"""The port's client call plane (``tpurpc_torch/rpc/channel.py``) against
the reference's: retries, hedging, pushback, the transparent replay of a
refused stream, wait-for-ready, ``StreamUnary`` and ``future`` under a
``ring_hash`` key.

Every scenario runs on both packages (and, where a server is involved,
against each package's server) with the same seeded inputs; the
observations must be equal: status codes and details, attempts seen by
the servers, throttle tokens, which server answered, reply bytes. The
cases are the reference's own (``tests/test_resolver_lb.py``'s retry
cases, ``tests/test_fleet.py``'s hedging and pushback cases), with slow
handlers held on ``threading.Event``s instead of sleeps wherever the
observation allows, and every wait bounded. Parity tests never compare
sleep times (``RetryPolicy.next_sleep`` draws a jitter).
"""

import threading
import time

import pytest

from torch_call_plane import (PKGS, PORT, REF, Counter, Flaky, both,
                              code_of, dead_port, free_dead_port, observe,
                              poll, serve, settles_at)

SERVERS = ["ref", "port"]
CALL = 10


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    """The port's entry points on the CPU."""
    from tpurpc_torch.utils import config as torch_config

    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


def _unary(pkg, srv_pkg, methods, call, **channel_kw):
    """Serve ``methods`` on a ``srv_pkg`` server; run ``call(channel)`` on a
    ``pkg`` channel to it."""
    srv, port = serve(srv_pkg, methods)
    try:
        with pkg.channel.Channel(f"127.0.0.1:{port}", **channel_kw) as ch:
            return call(ch)
    finally:
        srv.stop(grace=0)


# -- retry (tests/test_resolver_lb.py) ----------------------------------------

RETRY_CASES = {
    # name: (fail times, code, policy kwargs or None) ->
    "recovers": (2, "UNAVAILABLE", dict(max_attempts=4)),
    "exhaustion_surfaces_last_error": (10, "UNAVAILABLE",
                                       dict(max_attempts=3)),
    "skips_non_retryable_codes": (10, "INVALID_ARGUMENT",
                                  dict(max_attempts=4)),
    "off_by_default": (1, "UNAVAILABLE", None),
}


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_unary_alike(case, server):
    fail, code, pol = RETRY_CASES[case]

    def scenario(pkg):
        flaky = Flaky(PKGS[server], fail, code)
        kw = {}
        if pol is not None:
            kw["retry_policy"] = pkg.channel.RetryPolicy(
                initial_backoff=0.01, **pol)
        out = _unary(pkg, PKGS[server],
                     {"/t.S/Flaky": ("unary_unary", flaky)},
                     lambda ch: observe(lambda: bytes(
                         ch.unary_unary("/t.S/Flaky")(b"", timeout=CALL))),
                     **kw)
        return out, flaky.calls.n

    got = both(scenario)
    want = {"recovers": (("ok", b"ok:3"), 3),
            "exhaustion_surfaces_last_error": (
                ("error", "UNAVAILABLE", "flake"), 3),
            "skips_non_retryable_codes": (
                ("error", "INVALID_ARGUMENT", "flake"), 1),
            "off_by_default": (("error", "UNAVAILABLE", "flake"), 1)}[case]
    assert got == want


@pytest.mark.parametrize("server", SERVERS)
def test_retry_never_replays_committed_call(server):
    """A response message already delivered, then non-OK trailers: the
    handler must not run again."""
    def scenario(pkg):
        calls = Counter()
        srv_pkg = PKGS[server]

        def handler(req, ctx):
            calls.bump()
            ctx.set_code(code_of(srv_pkg, "UNAVAILABLE"))
            return b"payload"

        pol = pkg.channel.RetryPolicy(max_attempts=4, initial_backoff=0.01)
        out = _unary(pkg, srv_pkg, {"/t.S/Committed": ("unary_unary",
                                                       handler)},
                     lambda ch: observe(lambda: ch.unary_unary(
                         "/t.S/Committed")(b"", timeout=CALL)),
                     retry_policy=pol)
        return out[:2], calls.n

    assert both(scenario) == (("error", "UNAVAILABLE"), 1)


@pytest.mark.parametrize("server", SERVERS)
def test_retry_server_streaming_before_first_message(server):
    def scenario(pkg):
        srv_pkg = PKGS[server]
        early, mid = Counter(), Counter()

        def early_fail(req, ctx):
            if early.bump() <= 2:
                ctx.abort(code_of(srv_pkg, "UNAVAILABLE"), "not yet")
            for i in range(3):
                yield b"m%d" % i

        def mid_fail(req, ctx):
            mid.bump()
            yield b"first"
            ctx.abort(code_of(srv_pkg, "UNAVAILABLE"), "mid-stream")

        def run(ch):
            got = [bytes(m) for m in ch.unary_stream("/t.S/Early")(
                b"", timeout=CALL)]
            seen = []

            def consume():
                for m in ch.unary_stream("/t.S/Mid")(b"", timeout=CALL):
                    seen.append(bytes(m))
            return got, observe(consume), seen

        pol = pkg.channel.RetryPolicy(max_attempts=4, initial_backoff=0.01)
        out = _unary(pkg, srv_pkg,
                     {"/t.S/Early": ("unary_stream", early_fail),
                      "/t.S/Mid": ("unary_stream", mid_fail)},
                     run, retry_policy=pol)
        return out, early.n, mid.n

    got = both(scenario)
    assert got == (([b"m0", b"m1", b"m2"],
                    ("error", "UNAVAILABLE", "mid-stream"), [b"first"]),
                   3, 1)


def test_retry_policy_validation_alike():
    def scenario(pkg):
        out = []
        for kw in (dict(max_attempts=0), dict(max_attempts=1)):
            try:
                pkg.channel.RetryPolicy(**kw)
                out.append("ok")
            except ValueError:
                out.append("ValueError")
        pol = pkg.channel.RetryPolicy()
        out.append((pol.max_attempts, pol.initial_backoff, pol.max_backoff,
                    pol.backoff_multiplier,
                    [c.name for c in pol.retryable_codes]))
        return out

    assert both(scenario) == ["ValueError", "ok",
                              (3, 0.05, 1.0, 2.0, ["UNAVAILABLE"])]


@pytest.mark.parametrize("backoff, deadline_in, want_none", [
    (0.5, None, False), (5.0, None, False), (0.5, 0.1, True),
    (0.01, 30.0, False)])
def test_next_sleep_clamps_and_jitters_alike(backoff, deadline_in,
                                             want_none):
    """The same pinned jitter draw in each package's module gives the same
    sleep; a sleep outliving the deadline is None."""
    def scenario(pkg):
        out = []
        for draw in (-0.2, 0.0, 0.2):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pkg.channel.random, "uniform",
                           lambda a, b, d=draw: d)
                pol = pkg.channel.RetryPolicy(max_backoff=1.0)
                deadline = (None if deadline_in is None
                            else time.monotonic() + deadline_in)
                out.append(pol.next_sleep(backoff, deadline))
        return out

    got = both(scenario)
    if want_none:
        assert got == [None, None, None]
    else:
        base = min(backoff, 1.0)
        assert got == pytest.approx([base * 0.8, base, base * 1.2])


def test_retry_throttle_gates_policy_run_alike():
    """``RetryPolicy.run`` against a seeded failure pattern under a token
    bucket: the attempts made and the tokens left are equal."""
    import random

    def scenario(pkg):
        rng = random.Random(11)
        throttle = pkg.service_config.RetryThrottle(6, 0.5)
        pol = pkg.channel.RetryPolicy(max_attempts=4, initial_backoff=0.001,
                                      max_backoff=0.002)
        codes = [code_of(pkg, "UNAVAILABLE"), code_of(pkg, "ABORTED")]
        log = []
        for call in range(12):
            attempts = []

            def attempt():
                attempts.append(1)
                r = rng.random()
                if r < 0.55:
                    raise pkg.status.RpcError(codes[r < 0.1], "x")
                return call

            log.append((observe(lambda: pol.run(None, attempt,
                                                throttle=throttle))[:2],
                        len(attempts), throttle.tokens()))
        return log

    got = both(scenario)
    assert any(n > 1 for _, n, _ in got) and any(
        out[0] == "error" for out, _, _ in got)


# -- pushback (tests/test_fleet.py) -------------------------------------------

def test_metadata_keys_agree_across_packages():
    assert PORT.channel._PUSHBACK_KEY == PORT.server.PUSHBACK_KEY \
        == REF.channel._PUSHBACK_KEY == REF.server.PUSHBACK_KEY
    assert PORT.channel._LOAD_KEY == REF.channel._LOAD_KEY


@pytest.mark.parametrize("md", [
    [("tpurpc-pushback-ms", "200")], [("tpurpc-pushback-ms", "junk")],
    [("tpurpc-pushback-ms", "-5")], [("other", "1")], []])
def test_pushback_parse_alike(md):
    def scenario(pkg):
        exc = pkg.status.RpcError(code_of(pkg, "UNAVAILABLE"), "shed", md)
        return pkg.channel._pushback_s(exc)

    both(scenario)


def test_retry_policy_honors_pushback_floor():
    """RetryPolicy sleeps at least the server-named pushback before the
    next attempt (the shed is not immediately re-hammered)."""
    def scenario(pkg):
        attempts = []

        def attempt():
            attempts.append(time.monotonic())
            if len(attempts) == 1:
                raise pkg.status.RpcError(
                    code_of(pkg, "UNAVAILABLE"), "shed",
                    [(pkg.channel._PUSHBACK_KEY, "200")])
            return "ok"

        policy = pkg.channel.RetryPolicy(max_attempts=3,
                                         initial_backoff=0.001,
                                         max_backoff=0.002)
        out = policy.run(None, attempt)
        return out, len(attempts), attempts[1] - attempts[0] >= 0.2 * 0.95

    assert both(scenario) == ("ok", 2, True)


@pytest.mark.parametrize("server", SERVERS)
def test_admission_shed_carries_pushback_then_retry_waits_it_out(server):
    """A full admission gate sheds with ``tpurpc-pushback-ms``; a retrying
    call against it waits out the pushback and succeeds once the gate has
    room (tests/test_fleet.py's shed case, then its pushback floor on the
    wire). Both channels are connected, and the warm-up calls' gate slots
    released, before the gate fills: a server whose gate is at its soft
    limit refuses new connections too, and a slot is released only after
    the reply is on the wire."""
    def scenario(pkg):
        srv_pkg = PKGS[server]
        gate_open = threading.Event()
        entered = Counter()

        def slow(req, ctx):
            entered.bump()
            gate_open.wait(10)
            return b"ok"

        gate = srv_pkg.server.AdmissionGate(1, soft_limit=1)
        srv, port = serve(srv_pkg, {"/fleet.S/Slow": ("unary_unary", slow),
                                    "/fleet.S/Fast": ("unary_unary",
                                                      lambda r, c: b"f")},
                          admission=gate)
        pol = pkg.channel.RetryPolicy(max_attempts=5, initial_backoff=0.001,
                                      max_backoff=0.002)
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch, \
                    pkg.channel.Channel(f"127.0.0.1:{port}",
                                        retry_policy=pol) as ch2:
                warm = bytes(ch2.unary_unary("/fleet.S/Fast")(b"",
                                                             timeout=CALL))
                # ch dials only now: wait for the warm call's slot first,
                # or the gate at its soft limit refuses the connection
                assert poll(lambda: gate.inflight() == 0)
                ch.unary_unary("/fleet.S/Fast")(b"", timeout=CALL)
                assert poll(lambda: gate.inflight() == 0)
                mc = ch.unary_unary("/fleet.S/Slow")
                fut = mc.future(b"", timeout=CALL)
                assert poll(lambda: entered.n == 1)
                shed = observe(lambda: mc(b"", timeout=CALL))
                md = None
                try:
                    mc(b"", timeout=CALL)
                except (REF.status.RpcError, PORT.status.RpcError) as exc:
                    md = dict(exc.trailing_metadata() or ())
                pushback = int(md[pkg.channel._PUSHBACK_KEY])
                # open the gate once the retry's first attempt was shed
                shed_before = gate.rejected
                threading.Thread(target=lambda: (
                    poll(lambda: gate.rejected > shed_before, interval=0.001),
                    gate_open.set()), daemon=True).start()
                t0 = time.monotonic()
                out = observe(lambda: bytes(ch2.unary_unary(
                    "/fleet.S/Slow")(b"", timeout=CALL)))
                waited = time.monotonic() - t0
                first = bytes(fut.result(timeout=CALL))
        finally:
            gate_open.set()
            srv.stop(grace=0)
        return (warm, shed[:2], "overloaded" in shed[2], pushback > 0, out,
                first, waited >= pushback / 1000.0 * 0.95, entered.n)

    assert both(scenario) == (b"f", ("error", "UNAVAILABLE"), True, True,
                              ("ok", b"ok"), b"ok", True, 2)


# -- hedging (tests/test_fleet.py) --------------------------------------------

def test_hedging_policy_validation_alike():
    def scenario(pkg):
        out = []
        for kw in (dict(max_attempts=1), dict(hedging_delay=-0.1),
                   dict(max_attempts=2, hedging_delay=0.0)):
            try:
                hp = pkg.channel.HedgingPolicy(**kw)
                out.append((hp.max_attempts, hp.hedging_delay,
                            [c.name for c in hp.non_fatal_codes]))
            except ValueError:
                out.append("ValueError")
        return out

    assert both(scenario) == ["ValueError", "ValueError",
                              (2, 0.0, ["UNAVAILABLE"])]


def test_service_config_parses_hedging_policy():
    def scenario(pkg):
        sc = pkg.service_config.ServiceConfig.from_json({"methodConfig": [{
            "name": [{"service": "fleet.S"}],
            "hedgingPolicy": {"maxAttempts": 7, "hedgingDelay": "0.02s",
                              "nonFatalStatusCodes": ["UNAVAILABLE",
                                                      "ABORTED"]}}]})
        hp = sc.for_method("/fleet.S/Who").hedging_policy
        return (type(hp).__name__, hp.max_attempts, hp.hedging_delay,
                [c.name for c in hp.non_fatal_codes])

    assert both(scenario) == ("HedgingPolicy", 5, 0.02,
                              ["UNAVAILABLE", "ABORTED"])


def test_service_config_rejects_retry_plus_hedging():
    def scenario(pkg):
        with pytest.raises(ValueError):
            pkg.service_config.ServiceConfig.from_json({"methodConfig": [{
                "name": [{}],
                "retryPolicy": {"maxAttempts": 2,
                                "retryableStatusCodes": ["UNAVAILABLE"]},
                "hedgingPolicy": {"maxAttempts": 2}}]})
        return True

    both(scenario)


def _named_servers(srv_pkg, names, gates=None, seen=None):
    """One server per name answering it on ``/fleet.S/Who``. ``gates[i]``
    (an Event) holds server i's handler until set; ``seen[i]`` counts its
    calls and keeps its contexts."""
    rigs = []
    for i, name in enumerate(names):
        def who(req, ctx, i=i, name=name):
            if seen is not None:
                seen[i].append(ctx)
            if gates is not None and gates[i] is not None:
                gates[i].wait(20)
            return name.encode()

        rigs.append(serve(srv_pkg, {"/fleet.S/Who": ("unary_unary", who)}))
    return rigs


def _target(rigs):
    return "ipv4:" + ",".join(f"127.0.0.1:{p}" for _, p in rigs)


@pytest.mark.parametrize("server", SERVERS)
def test_hedge_beats_slow_replica_and_cancels_loser(server):
    """The first replica is held; the hedge fires after the delay and wins
    on the second, and the held attempt's stream is cancelled (its handler
    sees an inactive context)."""
    def scenario(pkg):
        hold = threading.Event()
        seen = [[], []]
        rigs = _named_servers(PKGS[server], ["slow", "fast"],
                              gates=[hold, None], seen=seen)
        try:
            hp = pkg.channel.HedgingPolicy(max_attempts=3,
                                           hedging_delay=0.02)
            with pkg.channel.Channel(_target(rigs), lb_policy="pick_first",
                                     hedging_policy=hp) as ch:
                for sc in ch._subchannels:  # as in the case below
                    sc.get()
                out = bytes(ch.unary_unary("/fleet.S/Who")(b"x",
                                                           timeout=CALL))
                cancelled = poll(lambda: seen[0]
                                 and not seen[0][0].is_active())
        finally:
            hold.set()
            for s, _ in rigs:
                s.stop(grace=0)
        return out, len(seen[0]), len(seen[1]), bool(cancelled)

    assert both(scenario) == (b"fast", 1, 1, True)


@pytest.mark.parametrize("server", SERVERS)
def test_hedge_attempts_prefer_distinct_subchannels(server):
    """With every replica held, max_attempts hedges land on DISTINCT
    backends (the used-subchannel exclusion), not the same one thrice. (The
    reference's version fails now and then under load: ROADMAP C.)"""
    def scenario(pkg):
        gates = [threading.Event() for _ in range(3)]
        seen = [[], [], []]
        rigs = _named_servers(PKGS[server], ["s0", "s1", "s2"], gates=gates,
                              seen=seen)
        out = []
        try:
            hp = pkg.channel.HedgingPolicy(max_attempts=3,
                                           hedging_delay=0.1)
            with pkg.channel.Channel(_target(rigs), lb_policy="pick_first",
                                     hedging_policy=hp) as ch:
                # a hedge registers its subchannel once its stream is open
                # (both packages): dial every backend first, so that a
                # slow dial cannot let the next hedge pick the same one
                for sc in ch._subchannels:
                    sc.get()
                t = threading.Thread(target=lambda: out.append(observe(
                    lambda: bytes(ch.unary_unary("/fleet.S/Who")(
                        b"x", timeout=CALL)))))
                t.start()
                spread = poll(lambda: all(seen))
                gates[1].set()  # the middle replica answers first
                t.join(CALL)
        finally:
            for g in gates:
                g.set()
            for s, _ in rigs:
                s.stop(grace=0)
        return bool(spread), [len(s) for s in seen], out

    assert both(scenario) == (True, [1, 1, 1], [("ok", b"s1")])


@pytest.mark.parametrize("server", SERVERS)
def test_hedging_no_delay_on_healthy_fleet(server):
    """A response before the hedging delay means NO hedge fires."""
    def scenario(pkg):
        seen = [[]]
        rigs = _named_servers(PKGS[server], ["a"], seen=seen)
        try:
            hp = pkg.channel.HedgingPolicy(max_attempts=3, hedging_delay=5.0)
            with pkg.channel.Channel(_target(rigs),
                                     hedging_policy=hp) as ch:
                mc = ch.unary_unary("/fleet.S/Who")
                outs = [bytes(mc(b"x", timeout=CALL)) for _ in range(5)]
        finally:
            rigs[0][0].stop(grace=0)
        return outs, len(seen[0])

    assert both(scenario) == ([b"a"] * 5, 5)


@pytest.mark.parametrize("server", SERVERS)
def test_hedging_gated_by_retry_throttle(server):
    """A drained retry-throttle bucket suppresses hedges."""
    def scenario(pkg):
        hold = threading.Event()
        seen = [[]]
        rigs = _named_servers(PKGS[server], ["only"], gates=[hold],
                              seen=seen)
        out = []
        try:
            hp = pkg.channel.HedgingPolicy(max_attempts=3,
                                           hedging_delay=0.01)
            with pkg.channel.Channel(_target(rigs),
                                     hedging_policy=hp) as ch:
                ch.update_service_config(
                    {"retryThrottling": {"maxTokens": 10, "tokenRatio": 0.1}})
                ch._service_config.retry_throttle._tokens = 0.0  # drained
                t = threading.Thread(target=lambda: out.append(bytes(
                    ch.unary_unary("/fleet.S/Who")(b"x", timeout=CALL))))
                t.start()
                poll(lambda: seen[0])
                alone = settles_at(lambda: len(seen[0]), 1)
                hold.set()
                t.join(CALL)
                tokens = ch._service_config.retry_throttle.tokens()
        finally:
            hold.set()
            rigs[0][0].stop(grace=0)
        return out, alone, len(seen[0]), tokens

    assert both(scenario) == ([b"only"], True, 1, 0.1)


@pytest.mark.parametrize("server", SERVERS)
def test_hedging_fatal_status_resolves_immediately(server):
    """A non-retryable failure surfaces at once instead of waiting out the
    hedging delay."""
    def scenario(pkg):
        srv_pkg = PKGS[server]
        calls = Counter()

        def bad(req, ctx):
            calls.bump()
            ctx.abort(code_of(srv_pkg, "INVALID_ARGUMENT"), "nope")

        hp = pkg.channel.HedgingPolicy(max_attempts=3, hedging_delay=30.0)
        t0 = time.monotonic()
        out = _unary(pkg, srv_pkg, {"/fleet.S/Who": ("unary_unary", bad)},
                     lambda ch: observe(lambda: ch.unary_unary(
                         "/fleet.S/Who")(b"x", timeout=60)),
                     hedging_policy=hp)
        return out, calls.n, time.monotonic() - t0 < 10.0

    assert both(scenario) == (("error", "INVALID_ARGUMENT", "nope"), 1, True)


@pytest.mark.parametrize("server", SERVERS)
def test_hedging_non_fatal_fires_next_hedge_at_once(server):
    """A non-fatal failure fires the next hedge without waiting out the
    delay; it lands on the other replica."""
    def scenario(pkg):
        srv_pkg = PKGS[server]
        calls = [Counter(), Counter()]

        def down(req, ctx):
            calls[0].bump()
            ctx.abort(code_of(srv_pkg, "UNAVAILABLE"), "down")

        def up(req, ctx):
            calls[1].bump()
            return b"up"

        rigs = [serve(srv_pkg, {"/fleet.S/Who": ("unary_unary", fn)})
                for fn in (down, up)]
        try:
            hp = pkg.channel.HedgingPolicy(max_attempts=2,
                                           hedging_delay=30.0)
            t0 = time.monotonic()
            with pkg.channel.Channel(_target(rigs), lb_policy="pick_first",
                                     hedging_policy=hp) as ch:
                out = observe(lambda: bytes(ch.unary_unary("/fleet.S/Who")(
                    b"x", timeout=60)))
            fast = time.monotonic() - t0 < 10.0
        finally:
            for s, _ in rigs:
                s.stop(grace=0)
        return out, calls[0].n, calls[1].n, fast

    assert both(scenario) == (("ok", b"up"), 1, 1, True)


@pytest.mark.parametrize("server", SERVERS)
def test_pushback_stops_hedging(server):
    """An admission-shedding fleet receives no further hedges: the
    pushback resolves the hedged call with the shed failure."""
    def scenario(pkg):
        srv_pkg = PKGS[server]
        calls = Counter()

        def shed(req, ctx):
            calls.bump()
            ctx.set_trailing_metadata([(srv_pkg.server.PUSHBACK_KEY, "100")])
            ctx.abort(code_of(srv_pkg, "UNAVAILABLE"), "synthetic shed")

        # a delay far beyond the shed's round trip: only a non-fatal
        # failure could fire the next hedge, and the pushback stops it
        hp = pkg.channel.HedgingPolicy(max_attempts=3, hedging_delay=30.0)
        out = _unary(pkg, srv_pkg, {"/fleet.S/Who": ("unary_unary", shed)},
                     lambda ch: observe(lambda: ch.unary_unary(
                         "/fleet.S/Who")(b"x", timeout=60)),
                     hedging_policy=hp)
        return out, settles_at(lambda: calls.n, 1)

    assert both(scenario) == (("error", "UNAVAILABLE", "synthetic shed"),
                              True)


# -- the transparent replay of a refused stream --------------------------------

PAIRS = [("ref", "ref"), ("ref", "port"), ("port", "ref"), ("port", "port")]


@pytest.mark.parametrize("client, server", PAIRS)
def test_refused_stream_replays_on_another_subchannel(client, server):
    """A server that turned draining refuses a stream on a connection it
    has not yet sent its GOAWAY on (``RST|FLAG_REFUSED``, no handler ran):
    the client replays it on the other subchannel, where it succeeds. The
    server's draining flag is set without the GOAWAY, which is the window
    a stream racing the GOAWAY falls into."""
    pkg, srv_pkg = PKGS[client], PKGS[server]
    seen = [[], []]
    rigs = _named_servers(srv_pkg, ["a", "b"], seen=seen)
    try:
        with pkg.channel.Channel(_target(rigs),
                                 lb_policy="pick_first") as ch:
            mc = ch.unary_unary("/fleet.S/Who")
            first = bytes(mc(b"x", timeout=CALL))
            rigs[0][0]._draining = True
            replayed = observe(lambda: bytes(mc(b"y", timeout=CALL)))
    finally:
        for s, _ in rigs:
            s._draining = False
            s.stop(grace=0)
    assert (first, replayed, [len(s) for s in seen]) == (
        b"a", ("ok", b"b"), [1, 1])


@pytest.mark.parametrize("client, server", PAIRS)
def test_drain_migrates_calls_without_failure(client, server):
    """``drain()`` of one of two round-robin servers between calls: every
    call succeeds, and the calls after the drain are all served by the
    other server (a GOAWAY read before the stream opens redials; a stream
    that raced it is refused and replayed)."""
    pkg, srv_pkg = PKGS[client], PKGS[server]
    seen = [[], []]
    rigs = _named_servers(srv_pkg, ["a", "b"], seen=seen)
    try:
        with pkg.channel.Channel(_target(rigs),
                                 lb_policy="round_robin") as ch:
            mc = ch.unary_unary("/fleet.S/Who")
            before = [bytes(mc(b"x", timeout=CALL)) for _ in range(4)]
            assert rigs[0][0].drain(linger=5.0) is True
            after = [observe(lambda: bytes(mc(b"y", timeout=CALL)))
                     for _ in range(8)]
    finally:
        for s, _ in rigs:
            s.stop(grace=0)
    assert sorted(before) == [b"a", b"a", b"b", b"b"]
    assert after == [("ok", b"b")] * 8
    assert [len(s) for s in seen] == [2, 10]


# -- wait-for-ready ------------------------------------------------------------

def test_wait_for_ready_deadline_detail_alike():
    """Fail-fast (the default) fails at once with UNAVAILABLE; a
    wait-for-ready call queues until its deadline and fails
    DEADLINE_EXCEEDED with the same detail in both packages."""
    port = dead_port()

    def scenario(pkg):
        with pkg.channel.Channel(f"127.0.0.1:{port}", connect_timeout=2) as ch:
            mc = ch.unary_unary("/t.S/X")
            fast = observe(lambda: mc(b"", timeout=5))
            t0 = time.monotonic()
            queued = observe(lambda: mc(b"", timeout=0.4,
                                        wait_for_ready=True))
            waited = time.monotonic() - t0
        return fast[:2], queued, 0.3 <= waited < 5.0

    assert both(scenario) == (
        ("error", "UNAVAILABLE"),
        ("error", "DEADLINE_EXCEEDED",
         "deadline exceeded waiting for channel readiness"), True)


@pytest.mark.parametrize("server", SERVERS)
def test_wait_for_ready_queues_until_the_server_appears(server):
    """A wait-for-ready call started before its server listens succeeds
    once the server comes up, within its one deadline."""
    def scenario(pkg):
        srv_pkg = PKGS[server]
        port = dead_port()
        out = []
        with pkg.channel.Channel(f"127.0.0.1:{port}", connect_timeout=2) as ch:
            mc = ch.unary_unary("/t.S/Echo")
            t = threading.Thread(target=lambda: out.append(observe(
                lambda: bytes(mc(b"hi", timeout=20, wait_for_ready=True)))))
            t.start()
            time.sleep(0.2)
            srv = srv_pkg.server.Server(max_workers=2)
            srv.add_method("/t.S/Echo", srv_pkg.server
                           .unary_unary_rpc_method_handler(lambda r, c: r))
            free_dead_port(port)
            srv.add_insecure_port(f"127.0.0.1:{port}")
            srv.start()
            try:
                t.join(20)
            finally:
                srv.stop(grace=0)
        return out

    assert both(scenario) == [("ok", b"hi")]


def test_per_call_credentials_rejected_alike():
    def scenario(pkg):
        with pkg.channel.Channel(f"127.0.0.1:{dead_port()}") as ch:
            out = []
            for mc in (ch.unary_unary("/t.S/X"), ch.unary_stream("/t.S/X")):
                try:
                    mc(b"", timeout=1, credentials=object())
                    out.append("ok")
                except NotImplementedError as exc:
                    out.append(str(exc))
            return out

    assert both(scenario) == [
        "per-call credentials are not supported; use channel credentials"] * 2


# -- StreamUnary ---------------------------------------------------------------

@pytest.mark.parametrize("server", SERVERS)
def test_stream_unary_alike(server):
    def scenario(pkg):
        srv_pkg = PKGS[server]

        def total(reqs, ctx):
            return b"|".join(bytes(r) for r in reqs)

        def none(reqs, ctx):
            for _ in reqs:
                pass
            ctx.abort(code_of(srv_pkg, "FAILED_PRECONDITION"), "empty")

        def run(ch):
            mc = ch.stream_unary("/t.S/Cat")
            return (observe(lambda: bytes(mc(iter([b"a", b"bc", b"d"]),
                                             timeout=CALL))),
                    observe(lambda: bytes(mc(iter([]), timeout=CALL))),
                    observe(lambda: ch.stream_unary("/t.S/None")(
                        iter([b"x"]), timeout=CALL)))

        return _unary(pkg, srv_pkg, {"/t.S/Cat": ("stream_unary", total),
                                     "/t.S/None": ("stream_unary", none)},
                      run)

    assert both(scenario) == (("ok", b"a|bc|d"), ("ok", b""),
                              ("error", "FAILED_PRECONDITION", "empty"))


# -- future under a ring_hash key ----------------------------------------------

@pytest.mark.parametrize("server", SERVERS)
def test_future_keeps_the_ring_hash_key(server):
    """``future`` runs the call on another thread; the caller's ring_hash
    key goes with it, so every future reaches the direct call's server."""
    def scenario(pkg):
        rigs = _named_servers(PKGS[server], ["0", "1", "2"])
        try:
            with pkg.channel.Channel(_target(rigs),
                                     lb_policy="ring_hash") as ch:
                mc = ch.unary_unary("/fleet.S/Who")
                with pkg.resolver.ring_hash_key("user-42"):
                    direct = int(bytes(mc(b"", timeout=CALL)))
                    futs = [mc.future(b"", timeout=CALL) for _ in range(6)]
                return direct, [int(bytes(f.result(CALL))) for f in futs]
        finally:
            for s, _ in rigs:
                s.stop(grace=0)

    direct, futs = both(scenario)
    assert futs == [direct] * 6


@pytest.fixture
def ring_platform(monkeypatch):
    """The port on the device-ring platform, on the CPU (a 1 MiB ring)."""
    from tpurpc_torch.core import _native as port_native
    from tpurpc_torch.core.poller import PairPool, Poller
    from tpurpc_torch.utils import config as torch_config

    port_native.load()  # the first-use build, outside deadlines
    monkeypatch.setenv("GRPC_PLATFORM_TYPE", "TPU")
    monkeypatch.setenv("TPURPC_HBM_RING_SIZE_KB", "1024")
    torch_config.set_config(None)
    yield
    Poller.reset()
    PairPool.reset()
    torch_config.set_config(None)


def test_refusal_during_a_large_request_write_replays(ring_platform):
    """A request larger than the pair's ring stalls for credits while it is
    written. A draining server refuses its stream at the HEADERS, and the
    client's drained connection closes behind the refusal while the body is
    still being written, so the send fails. The refusal stands: the port
    replays the call on the other server, and no call fails. (The
    reference fails such a call UNAVAILABLE "transport failed: endpoint
    closed": ROADMAP C.) Port client and servers only: the reference's
    server can deadlock on its shared-memory tracking lock in this traffic
    (the port's ``ShmDomain._track_mu`` is re-entrant)."""
    import torch

    from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method

    x = torch.ones(8, 64, 64, 3)            # 393,216 bytes
    outcomes, served = [], []
    for _ in range(3):
        rigs = []
        for k in range(2):
            s = PORT.server.Server(max_workers=4)
            add_tensor_method(s, "F", lambda t, k=k: {
                "y": t["x"] + 1, "k": torch.tensor([k])}, device=True)
            s.start()
            rigs.append((s, s.add_insecure_port("127.0.0.1:0")))
        try:
            with PORT.channel.Channel(_target(rigs),
                                      lb_policy="round_robin") as ch:
                client = TensorClient(ch)
                for i in range(8):
                    out = observe(lambda: client.call("F", {"x": x},
                                                      timeout=CALL))
                    outcomes.append(out[0])
                    if out[0] == "ok":
                        assert torch.equal(out[1]["y"], x + 1)
                        if i >= 4:
                            served.append(int(out[1]["k"]))
                    if i == 3:
                        assert rigs[0][0].drain(linger=5.0) is True
        finally:
            for s, _ in rigs:
                s.stop(grace=0)
    assert outcomes == ["ok"] * 24
    assert served == [1] * 12


def test_shm_tracking_block_is_reentrant():
    """``ShmDomain._untracked`` taken again on the same thread (a garbage
    collection inside the block closing a window) must not deadlock, and
    the tracker's hooks come back in order."""
    from multiprocessing import resource_tracker

    from tpurpc_torch.core.pair import ShmDomain

    # the hooks are process-wide: read them only inside the block, where
    # no other thread (a server's rendezvous window) can have them swapped
    with ShmDomain._track_mu:
        real = resource_tracker.register
    done = threading.Event()

    def nested():
        with ShmDomain._untracked():
            with ShmDomain._untracked():
                pass
            assert resource_tracker.register is not real
        done.set()

    t = threading.Thread(target=nested, daemon=True)
    t.start()
    assert done.wait(10)
    with ShmDomain._track_mu:
        assert resource_tracker.register is real
