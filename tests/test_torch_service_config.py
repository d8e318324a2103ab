"""The port's service config (``tpurpc_torch/rpc/service_config.py``) and
the channel's use of it, against the reference's.

The cases of ``tests/test_service_config.py``, each run on both packages
with the same inputs: parsed values and rejections alike, then a config
delivered by a registered resolver, by ``update_service_config`` or by
the ``grpc.service_config`` option, against each package's server. The
observations compared are status codes and details, the attempts each
handler saw, throttle tokens and the call plan's fields.
"""

import json
import time

import pytest

from torch_call_plane import PKGS, Flaky, both, code_of, observe, serve

SERVERS = ["ref", "port"]
CALL = 10

RETRY_CFG = {
    "methodConfig": [{
        "name": [{"service": "cfg.Svc", "method": "Flaky"}],
        "retryPolicy": {"maxAttempts": 4, "initialBackoff": "0.01s",
                        "maxBackoff": "0.05s", "backoffMultiplier": 2,
                        "retryableStatusCodes": ["UNAVAILABLE"]}}]}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    from tpurpc_torch.utils import config as torch_config

    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


def _raises(fn):
    try:
        fn()
    except ValueError:
        return "ValueError"
    except Exception as exc:  # anything else is a contract break
        return type(exc).__name__
    return "ok"


# -- parsing ------------------------------------------------------------------

def test_parse_durations_and_precedence():
    def scenario(pkg):
        cfg = pkg.service_config.ServiceConfig.from_json({
            "methodConfig": [
                {"name": [{"service": "pkg.Svc", "method": "Echo"}],
                 "timeout": "1.5s"},
                {"name": [{"service": "pkg.Svc"}], "timeout": "2s"},
                {"name": [{}], "timeout": "3s"},
            ]})
        parse = pkg.service_config._parse_duration
        return ([cfg.for_method(m).timeout for m in
                 ("/pkg.Svc/Echo", "/pkg.Svc/Other", "/other.Svc/X")],
                parse("0.25s"), parse(2), parse(" 4s "),
                [_raises(lambda v=v: parse(v))
                 for v in ("1500ms", True, None, "s", "-1s")])

    assert both(scenario) == ([1.5, 2.0, 3.0], 0.25, 2.0, 4.0,
                              ["ValueError"] * 5)


def test_parse_retry_policy_fields():
    def scenario(pkg):
        cfg = pkg.service_config.ServiceConfig.from_json({
            "methodConfig": [{
                "name": [{"service": "s", "method": "m"}],
                "retryPolicy": {"maxAttempts": 4, "initialBackoff": "0.01s",
                                "maxBackoff": "0.1s", "backoffMultiplier": 3,
                                "retryableStatusCodes": ["UNAVAILABLE",
                                                         "aborted"]}}]})
        rp = cfg.for_method("/s/m").retry_policy
        return (type(rp).__name__, rp.max_attempts, rp.initial_backoff,
                rp.max_backoff, rp.backoff_multiplier,
                [c.name for c in rp.retryable_codes],
                cfg.for_method("/s/other").retry_policy)

    assert both(scenario) == ("RetryPolicy", 4, 0.01, 0.1, 3.0,
                              ["UNAVAILABLE", "ABORTED"], None)


MALFORMED = [
    {"methodConfig": [{"name": [{"service": "s"}],
                       "retryPolicy": {"maxAttempts": 1,
                                       "retryableStatusCodes":
                                       ["UNAVAILABLE"]}}]},
    {"methodConfig": [{"name": [{"method": "m"}]}]},
    {"methodConfig": [{"name": [{"service": "s"}],
                       "retryPolicy": {"maxAttempts": 2,
                                       "retryableStatusCodes":
                                       ["NO_SUCH_CODE"]}}]},
    {"methodConfig": [{"name": [{"service": "s"}],
                       "retryPolicy": {"maxAttempts": 2}}]},
    {"methodConfig": [{"name": []}]},
    {"methodConfig": [{"name": [{"service": "s"}],
                       "hedgingPolicy": {"maxAttempts": 2,
                                         "nonFatalStatusCodes": ["NOPE"]}}]},
    {"methodConfig": [{"name": [{"service": "s"}],
                       "hedgingPolicy": {"maxAttempts": 1}}]},
    {"retryThrottling": {"maxTokens": 0, "tokenRatio": 0.1}},
]


def test_parse_rejects_malformed_whole():
    def scenario(pkg):
        return [_raises(lambda c=c: pkg.service_config.ServiceConfig
                        .from_json(c)) for c in MALFORMED]

    assert both(scenario) == ["ValueError"] * len(MALFORMED)


def test_parse_rejects_nonpositive_backoff_and_caps_attempts():
    def scenario(pkg):
        sc = pkg.service_config.ServiceConfig
        rejected = [_raises(lambda k=k: sc.from_json({"methodConfig": [
            {"name": [{"service": "s"}],
             "retryPolicy": {"maxAttempts": 3, k: "0s",
                             "retryableStatusCodes": ["UNAVAILABLE"]}}]}))
            for k in ("initialBackoff", "maxBackoff")]
        cfg = sc.from_json({"methodConfig": [
            {"name": [{"service": "s"}],
             "retryPolicy": {"maxAttempts": 100000,
                             "retryableStatusCodes": ["UNAVAILABLE"]}}]})
        return (rejected, cfg.for_method("/s/m").retry_policy.max_attempts,
                pkg.service_config.MAX_ATTEMPTS_CAP)

    assert both(scenario) == (["ValueError", "ValueError"], 5, 5)


TYPE_ERRORS = [{"retryThrottling": None}, {"methodConfig": ["x"]},
               {"methodConfig": [{"name": "x"}]},
               {"methodConfig": [{"name": [["s"]]}]},
               {"methodConfig": [{"name": [{"service": "s"}],
                                  "retryPolicy": "on"}]},
               {"methodConfig": "x"}, [], "[1]"]


def test_parse_type_errors_are_value_errors():
    """Keep-last-good callers catch exactly ValueError."""
    def scenario(pkg):
        return [_raises(lambda c=c: pkg.service_config.ServiceConfig
                        .from_json(c)) for c in TYPE_ERRORS]

    assert both(scenario) == ["ValueError"] * len(TYPE_ERRORS)


def test_retry_throttle_bucket():
    def scenario(pkg):
        t = pkg.service_config.RetryThrottle(max_tokens=4, token_ratio=0.5)
        seen = [t.allow_retry()]
        for op in ("f", "f", "s", "f", "f", "f", "s", "s", "s", "s", "s",
                   "s", "s", "s"):
            (t.record_failure if op == "f" else t.record_success)()
            seen.append((t.tokens(), t.allow_retry()))
        new = pkg.service_config.RetryThrottle(8, 0.5).carry_from(t)
        return seen, new.tokens(), _raises(
            lambda: pkg.service_config.RetryThrottle(0, 1))

    got = both(scenario)
    assert got[0][:4] == [True, (3.0, True), (2.0, False), (2.5, True)]


# -- end to end: a delivered config --------------------------------------------

def _resolver(pkg, scheme, port, cfg):
    pkg.resolver.register_resolver(
        scheme, lambda rest: pkg.resolver.Resolution([("127.0.0.1", port)],
                                                     cfg))


def _unregister(pkg, scheme):
    pkg.resolver._RESOLVERS.pop(scheme, None)


@pytest.mark.parametrize("server", SERVERS)
def test_resolver_delivered_retry_policy_applies_per_method(server):
    def scenario(pkg):
        srv_pkg = PKGS[server]
        flaky, flaky2 = Flaky(srv_pkg, 2), Flaky(srv_pkg, 1)
        srv, port = serve(srv_pkg, {"/cfg.Svc/Flaky": ("unary_unary", flaky),
                                    "/cfg.Svc/NoRetry": ("unary_unary",
                                                         flaky2)})
        scheme = f"svctest{pkg.name}"
        _resolver(pkg, scheme, port, RETRY_CFG)
        try:
            with pkg.channel.Channel(f"{scheme}:///x") as ch:
                ok = observe(lambda: bytes(ch.unary_unary("/cfg.Svc/Flaky")(
                    b"p", timeout=CALL)))
                no = observe(lambda: ch.unary_unary("/cfg.Svc/NoRetry")(
                    b"p", timeout=CALL))
        finally:
            _unregister(pkg, scheme)
            srv.stop(grace=0)
        return ok, flaky.calls.n, no, flaky2.calls.n

    assert both(scenario) == (("ok", b"ok:3"), 3,
                              ("error", "UNAVAILABLE", "flake"), 1)


@pytest.mark.parametrize("server", SERVERS)
def test_constructor_policy_wins_over_config(server):
    def scenario(pkg):
        srv_pkg = PKGS[server]
        flaky = Flaky(srv_pkg, 10)
        srv, port = serve(srv_pkg, {"/cfg.Svc/Flaky": ("unary_unary",
                                                       flaky)})
        scheme = f"svctest2{pkg.name}"
        _resolver(pkg, scheme, port, RETRY_CFG)
        try:
            explicit = pkg.channel.RetryPolicy(
                max_attempts=2, initial_backoff=0.01,
                retryable_codes=(code_of(pkg, "UNAVAILABLE"),))
            with pkg.channel.Channel(f"{scheme}:///x",
                                     retry_policy=explicit) as ch:
                out = observe(lambda: ch.unary_unary("/cfg.Svc/Flaky")(
                    b"p", timeout=CALL))
        finally:
            _unregister(pkg, scheme)
            srv.stop(grace=0)
        return out, flaky.calls.n

    assert both(scenario) == (("error", "UNAVAILABLE", "flake"), 2)


@pytest.mark.parametrize("server", SERVERS)
def test_method_timeout_from_config_and_min_rule(server):
    """The config's 0.2 s applies without a call-site timeout, and a longer
    call-site timeout cannot widen it. The handler is held far longer."""
    import threading

    def scenario(pkg):
        srv_pkg = PKGS[server]
        hold = threading.Event()

        def slow(req, ctx):
            hold.wait(20)
            return bytes(req)

        srv, port = serve(srv_pkg, {"/cfg.Svc/Slow": ("unary_unary", slow)})
        cfg = {"methodConfig": [{"name": [{"service": "cfg.Svc",
                                           "method": "Slow"}],
                                 "timeout": "0.2s"}]}
        scheme = f"svctest3{pkg.name}"
        _resolver(pkg, scheme, port, cfg)
        out = []
        try:
            with pkg.channel.Channel(f"{scheme}:///x") as ch:
                mc = ch.unary_unary("/cfg.Svc/Slow")
                for kw in ({}, {"timeout": 30}):
                    t0 = time.monotonic()
                    res = observe(lambda: mc(b"p", **kw))
                    out.append((res[:2], time.monotonic() - t0 < 5.0))
                plan = ch._call_plan("/cfg.Svc/Slow", 0.1)[1], \
                    ch._call_plan("/cfg.Svc/Other", 7.0)[1]
        finally:
            hold.set()
            _unregister(pkg, scheme)
            srv.stop(grace=0)
        return out, plan

    assert both(scenario) == ([(("error", "DEADLINE_EXCEEDED"), True)] * 2,
                              (0.1, 7.0))


@pytest.mark.parametrize("server", SERVERS)
def test_retry_throttling_suppresses_retry_storm(server):
    def scenario(pkg):
        srv_pkg = PKGS[server]
        flaky = Flaky(srv_pkg, 10 ** 6)
        srv, port = serve(srv_pkg, {"/cfg.Svc/Flaky": ("unary_unary",
                                                       flaky)})
        cfg = dict(RETRY_CFG)
        cfg["retryThrottling"] = {"maxTokens": 2, "tokenRatio": 0.1}
        scheme = f"svctest4{pkg.name}"
        _resolver(pkg, scheme, port, cfg)
        out = []
        try:
            with pkg.channel.Channel(f"{scheme}:///x") as ch:
                mc = ch.unary_unary("/cfg.Svc/Flaky")
                for _ in range(2):
                    res = observe(lambda: mc(b"p", timeout=CALL))
                    out.append((res, flaky.calls.n,
                                ch._service_config.retry_throttle.tokens()))
        finally:
            _unregister(pkg, scheme)
            srv.stop(grace=0)
        return out

    assert both(scenario) == [(("error", "UNAVAILABLE", "flake"), 1, 1.0),
                              (("error", "UNAVAILABLE", "flake"), 2, 0.0)]


@pytest.mark.parametrize("server", SERVERS)
def test_update_carries_throttle_drain_state(server):
    def scenario(pkg):
        srv_pkg = PKGS[server]
        flaky = Flaky(srv_pkg, 10 ** 6)
        srv, port = serve(srv_pkg, {"/cfg.Svc/Flaky": ("unary_unary",
                                                       flaky)})
        cfg = dict(RETRY_CFG)
        cfg["retryThrottling"] = {"maxTokens": 2, "tokenRatio": 0.1}
        seen = []
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                ch.update_service_config(cfg)
                mc = ch.unary_unary("/cfg.Svc/Flaky")
                observe(lambda: mc(b"p", timeout=CALL))
                seen.append(ch._service_config.retry_throttle.tokens())
                ch.update_service_config(cfg)  # a refresh, same config
                seen.append(ch._service_config.retry_throttle.tokens())
                observe(lambda: mc(b"p", timeout=CALL))
                seen.append((flaky.calls.n,
                             ch._service_config.retry_throttle.tokens()))
                now = ch._service_config.retry_throttle.tokens()
                cfg2 = dict(cfg)
                cfg2["retryThrottling"] = {"maxTokens": 4, "tokenRatio": 0.1}
                ch.update_service_config(json.dumps(cfg2))  # JSON text too
                seen.append(ch._service_config.retry_throttle.tokens()
                            == pytest.approx(now * 2))
        finally:
            srv.stop(grace=0)
        return seen

    assert both(scenario) == [1.0, 1.0, (2, 0.0), True]


def test_wait_for_ready_from_config():
    def scenario(pkg):
        cfg = {"methodConfig": [{"name": [{"service": "cfg.Svc",
                                           "method": "W"}],
                                 "waitForReady": True}]}
        srv, port = serve(pkg, {})
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                ch.update_service_config(cfg)
                return [ch._call_plan(m, None, *flag)[3]
                        for m, flag in (("/cfg.Svc/W", ()),
                                        ("/cfg.Svc/Other", ()),
                                        ("/cfg.Svc/Other", (True,)),
                                        ("/cfg.Svc/W", (False,)))]
        finally:
            srv.stop(grace=0)

    assert both(scenario) == [True, False, True, True]


@pytest.mark.parametrize("server", SERVERS)
def test_update_service_config_reconfigures_live_channel(server):
    def scenario(pkg):
        srv_pkg = PKGS[server]
        flaky = Flaky(srv_pkg, 2)
        srv, port = serve(srv_pkg, {"/cfg.Svc/Flaky": ("unary_unary",
                                                       flaky)})
        out = []
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}") as ch:
                mc = ch.unary_unary("/cfg.Svc/Flaky")
                out.append((observe(lambda: mc(b"p", timeout=CALL)),
                            flaky.calls.n))
                ch.update_service_config(RETRY_CFG)
                out.append((observe(lambda: bytes(mc(b"p", timeout=CALL))),
                            flaky.calls.n))
                out.append(_raises(lambda: ch.update_service_config(
                    {"methodConfig": [{"name": []}]})))
                out.append(ch._service_config.for_method(
                    "/cfg.Svc/Flaky").retry_policy is not None)
        finally:
            srv.stop(grace=0)
        return out

    assert both(scenario) == [(("error", "UNAVAILABLE", "flake"), 1),
                              (("ok", b"ok:3"), 3), "ValueError", True]


@pytest.mark.parametrize("server", SERVERS)
def test_grpc_service_config_channel_option(server):
    """The option is the FALLBACK: applied when the resolver delivers no
    config, ignored when it does."""
    def scenario(pkg):
        srv_pkg = PKGS[server]
        flaky = Flaky(srv_pkg, 2)
        srv, port = serve(srv_pkg, {"/cfg.Svc/Flaky": ("unary_unary",
                                                       flaky)})
        opts = [("grpc.service_config", json.dumps(RETRY_CFG))]
        scheme = f"svcopt{pkg.name}"
        out = []
        try:
            with pkg.channel.Channel(f"127.0.0.1:{port}", options=opts) as ch:
                out.append((observe(lambda: bytes(ch.unary_unary(
                    "/cfg.Svc/Flaky")(b"p", timeout=CALL))), flaky.calls.n))
            _resolver(pkg, scheme, port, {"methodConfig": [{
                "name": [{"service": "cfg.Svc"}], "timeout": "5s"}]})
            flaky2 = Flaky(srv_pkg, 10 ** 6)
            srv.add_method("/cfg.Svc/Flaky", srv_pkg.server
                           .unary_unary_rpc_method_handler(flaky2))
            with pkg.channel.Channel(f"{scheme}:///x", options=opts) as ch:
                out.append((observe(lambda: ch.unary_unary(
                    "/cfg.Svc/Flaky")(b"p", timeout=CALL)), flaky2.calls.n))
        finally:
            _unregister(pkg, scheme)
            srv.stop(grace=0)
        return out

    assert both(scenario) == [(("ok", b"ok:3"), 3),
                              (("error", "UNAVAILABLE", "flake"), 1)]


def test_call_plan_retry_beats_hedging_alike():
    """A method configured for hedging and a channel-wide retry policy: the
    call runs ONE strategy, retry; with neither explicit, the config's
    hedging applies; an explicit hedging policy wins over the config's."""
    def scenario(pkg):
        cfg = {"methodConfig": [{"name": [{"service": "h.S"}],
                                 "hedgingPolicy": {"maxAttempts": 3,
                                                   "hedgingDelay": "0.5s"}}]}
        out = []
        for kw in ({}, {"retry_policy": pkg.channel.RetryPolicy()},
                   {"hedging_policy": pkg.channel.HedgingPolicy(4, 0.1)}):
            with pkg.channel.Channel("127.0.0.1:1", **kw) as ch:
                ch.update_service_config(cfg)
                policy, _, throttle, wfr, hedging = ch._call_plan("/h.S/M",
                                                                  None)
                out.append((type(policy).__name__,
                            None if hedging is None else
                            (hedging.max_attempts, hedging.hedging_delay),
                            throttle, wfr))
        return out

    assert both(scenario) == [("NoneType", (3, 0.5), None, False),
                              ("RetryPolicy", None, None, False),
                              ("NoneType", (4, 0.1), None, False)]
