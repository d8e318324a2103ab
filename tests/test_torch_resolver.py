"""The port's resolver and LB policies (``tpurpc_torch.rpc.resolver``) and
its multi-address channel, against the reference's.

Each policy of both packages is fed the same seeded sequence of ``order``,
``connected``, ``failed`` and ``load_report`` calls (and, for
``ring_hash``, the same call keys under each package's ``ring_hash_key``);
the index sequences must be equal, pick for pick. Targets resolve to the
same addresses, and bad targets and specs raise the same exception type.
Then the reference's ``tests/test_resolver_lb.py`` cases run on the port's
channel and servers (its retry cases wait for retries in the port).
"""

import random
import socket
import threading
import time

import numpy as np
import pytest

from tpurpc.rpc import resolver as jres
from tpurpc_torch.rpc import resolver as tres
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.server import Server, unary_unary_rpc_method_handler
from tpurpc_torch.rpc.status import RpcError

#: leaf and composite specs over ``n`` subchannels
LEAVES = ["pick_first", "round_robin", "ring_hash", "least_loaded"]
COMPOSITES = {
    "priority": ({"priority": {
        "children": [{"policy": "round_robin", "indices": [0, 1]},
                     {"policy": "pick_first", "indices": [2]},
                     {"policy": "least_loaded", "indices": [3, 4]}],
        "failover_timeout_s": 30}}, 5),
    "priority_list": ({"priority": [
        {"policy": "pick_first", "indices": [0]},
        {"policy": "pick_first", "indices": [1]}]}, 2),
    "weighted_target": ({"weighted_target": {"targets": [
        {"weight": 3, "policy": "pick_first", "indices": [0]},
        {"weight": 1, "policy": "round_robin", "indices": [1, 2]},
        {"weight": 2, "policy": "ring_hash", "indices": [3]}]}}, 4),
    "nested": ({"weighted_target": [
        {"weight": 1, "indices": [0, 1],
         "policy": {"priority": [{"policy": "pick_first", "indices": [0]},
                                 {"policy": "pick_first", "indices": [1]}]}},
        {"weight": 1, "indices": [2]}]}, 3),
}
#: load reports, well-formed and junk
REPORTS = [b"3,5,12.5", b"0,0,0.0", b"9,4,0.0", b"1,0,500.0", "2,2,1.5",
           b"7", b"junk", b"not,numbers", b"", b"40,1,3.0"]
KEYS = [None, "alpha", "user-42", "session-9", "k7"]


def _ops(seed: int, n: int, count: int = 120):
    """A seeded call sequence: (op, index, value); indices may fall out of
    range (the policies must ignore those alike)."""
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        r = rng.random()
        if r < 0.45:
            out.append(("order", None, rng.choice(KEYS)))
        elif r < 0.6:
            out.append(("connected", rng.randrange(n), None))
        elif r < 0.75:
            out.append(("failed", rng.randrange(n), None))
        else:
            out.append(("load", rng.randrange(-1, n + 1),
                        rng.choice(REPORTS)))
    return out


def _drive(mod, spec, n, ops):
    pol = mod.make_policy(spec, n)
    seen = []
    for op, idx, val in ops:
        if op == "order":
            if val is None:
                seen.append(list(pol.order()))
            else:
                with mod.ring_hash_key(val):
                    seen.append(list(pol.order()))
        elif op == "connected":
            pol.connected(idx)
        elif op == "failed":
            pol.failed(idx)
        elif hasattr(pol, "load_report"):
            pol.load_report(idx, val)
    return seen, (pol.snapshot() if hasattr(pol, "snapshot") else None)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("spec", LEAVES)
def test_leaf_policy_picks_equal_reference(spec, n, seed):
    ops = _ops(seed * 101 + n, n)
    want, want_snap = _drive(jres, spec, n, ops)
    got, got_snap = _drive(tres, spec, n, ops)
    assert got == want
    assert got_snap == want_snap
    assert all(sorted(o) == list(range(n)) for o in got)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_composite_policy_picks_equal_reference(name, seed):
    spec, n = COMPOSITES[name]
    ops = _ops(seed + 7, n)
    want, _ = _drive(jres, spec, n, ops)
    got, _ = _drive(tres, spec, n, ops)
    assert got == want
    assert all(sorted(o) == list(range(n)) for o in got)


BAD_SPECS = [
    ("magic", 2),
    ({"priority": {"children": []}}, 2),
    ({"priority": "nope"}, 2),
    ({"weighted_target": [{"weight": 0, "policy": "pick_first",
                           "indices": [0]}]}, 1),
    ({"weighted_target": {"no_targets": 1}}, 1),
    ({"priority": [{"policy": "pick_first", "indices": [5]}]}, 2),
    ({"priority": [{"policy": "pick_first", "indices": []}]}, 2),
    ({"priority": [{"policy": "magic", "indices": [0]}]}, 1),
    ({"mystery": []}, 1),
    ({"a": 1, "b": 2}, 1),
    (["pick_first"], 1),
]


@pytest.mark.parametrize("spec,n", BAD_SPECS, ids=[str(i) for i in
                                                   range(len(BAD_SPECS))])
def test_bad_specs_rejected_alike(spec, n):
    with pytest.raises(Exception) as want:
        jres.make_policy(spec, n)
    with pytest.raises(Exception) as got:
        tres.make_policy(spec, n)
    assert type(got.value) is type(want.value) is ValueError


TARGETS = ["ipv4:10.0.0.1:5,10.0.0.2:7", "static:1.2.3.4:80,5.6.7.8:81",
           "dns:///localhost:1234", "localhost:4321", "127.0.0.1:99",
           "ipv6:[::1]:8080"]


@pytest.mark.parametrize("target", TARGETS)
def test_targets_resolve_alike(target):
    assert tres.resolve_target(target) == jres.resolve_target(target)


@pytest.mark.parametrize("target", ["ipv4:nonsense", "ipv4:1.2.3.4:x",
                                    "no-port", ":80"])
def test_bad_target_raises_alike(target):
    with pytest.raises(ValueError):
        jres.resolve_target(target)
    with pytest.raises(ValueError):
        tres.resolve_target(target)


def test_custom_resolver_scheme_alike():
    for mod in (jres, tres):
        mod.register_resolver("fakeport", lambda rest: [("127.0.0.1",
                                                         int(rest))])
        mod.register_resolver("fakecfg", lambda rest: (
            [("127.0.0.1", int(rest))], {"methodConfig": []}))
    for t in ("fakeport:4242", "fakecfg:///77"):
        assert tres.resolve_target(t) == jres.resolve_target(t)
        want, got = (jres.resolve_target_full(t), tres.resolve_target_full(t))
        assert (got.addresses, got.service_config) == (
            want.addresses, want.service_config)


def test_least_loaded_parse_matches_reference():
    for raw in REPORTS + ["3,5", "-4,-2,-1.0", b"1,2,3,4"]:
        assert (tres.LeastLoaded.parse_report(raw)
                == jres.LeastLoaded.parse_report(raw))


def test_ring_hash_ring_points_equal_reference():
    for n in (1, 2, 4, 7):
        assert tres.RingHash(n)._points == jres.RingHash(n)._points


# -- the reference's test_resolver_lb.py cases on the port ---------------------

def _echo_server(name):
    srv = Server(max_workers=4)
    srv.add_method("/t.S/Who", unary_unary_rpc_method_handler(
        lambda req, ctx: name.encode()))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


#: sockets that keep dead ports reserved for the process's life
_HELD = []


def _dead_port():
    """A port that refuses connections: bound, never listening, and held,
    so that no server of another test process can take it meanwhile."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    _HELD.append(s)
    return s.getsockname()[1]


def test_pick_first_fails_over_to_live_address():
    srv, port = _echo_server("b")
    try:
        with Channel(f"ipv4:127.0.0.1:{_dead_port()},127.0.0.1:{port}",
                     connect_timeout=2) as ch:
            mc = ch.unary_unary("/t.S/Who")
            assert mc(b"", timeout=10) == b"b"
            assert mc(b"", timeout=10) == b"b"   # sticks with the live one
            assert len(ch._subchannels) == 2
    finally:
        srv.stop(grace=0)


def test_round_robin_spreads_calls():
    s1, p1 = _echo_server("s1")
    s2, p2 = _echo_server("s2")
    try:
        with Channel(f"ipv4:127.0.0.1:{p1},127.0.0.1:{p2}",
                     lb_policy="round_robin") as ch:
            mc = ch.unary_unary("/t.S/Who")
            got = [bytes(mc(b"", timeout=10)) for _ in range(6)]
        assert got.count(b"s1") == 3 and got.count(b"s2") == 3
    finally:
        s1.stop(grace=0)
        s2.stop(grace=0)


def test_round_robin_skips_dead_member():
    s1, p1 = _echo_server("alive")
    try:
        with Channel(f"ipv4:127.0.0.1:{_dead_port()},127.0.0.1:{p1}",
                     lb_policy="round_robin", connect_timeout=2) as ch:
            mc = ch.unary_unary("/t.S/Who")
            for _ in range(4):
                assert mc(b"", timeout=10) == b"alive"
    finally:
        s1.stop(grace=0)


def test_lb_policy_from_grpc_options():
    s1, p1 = _echo_server("s1")
    s2, p2 = _echo_server("s2")
    try:
        with Channel(f"ipv4:127.0.0.1:{p1},127.0.0.1:{p2}",
                     options=[("grpc.lb_policy_name", "round_robin"),
                              ("grpc.max_receive_message_length", 1234),
                              ("grpc.unknown_arg", 1)]) as ch:
            assert ch._policy.name == "round_robin"
            assert ch.max_receive_message_length == 1234
            mc = ch.unary_unary("/t.S/Who")
            assert {bytes(mc(b"", timeout=10)) for _ in range(4)} == {
                b"s1", b"s2"}
    finally:
        s1.stop(grace=0)
        s2.stop(grace=0)


def test_ring_hash_channel_stickiness():
    s1, p1 = _echo_server("s1")
    s2, p2 = _echo_server("s2")
    try:
        with Channel(f"ipv4:127.0.0.1:{p1},127.0.0.1:{p2}",
                     lb_policy="ring_hash") as ch:
            mc = ch.unary_unary("/t.S/Who")
            for key in ("session-9", "user-1", "user-2"):
                with tres.ring_hash_key(key):
                    got = {bytes(mc(b"", timeout=10)) for _ in range(4)}
                with jres.ring_hash_key(key):
                    primary = list(jres.RingHash(2).order())[0]
                assert got == {[b"s1", b"s2"][primary]}, key
    finally:
        s1.stop(grace=0)
        s2.stop(grace=0)


def test_priority_channel_integration_failover():
    s1, p1 = _echo_server("primary")
    s2, p2 = _echo_server("backup")
    try:
        spec = {"priority": {
            "children": [{"policy": "pick_first", "indices": [0]},
                         {"policy": "pick_first", "indices": [1]}],
            "failover_timeout_s": 30}}
        with Channel(f"ipv4:127.0.0.1:{p1},127.0.0.1:{p2}",
                     lb_policy=spec, connect_timeout=2) as ch:
            mc = ch.unary_unary("/t.S/Who")
            assert mc(b"", timeout=10) == b"primary"
            s1.stop(grace=0)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                try:
                    if mc(b"", timeout=5) == b"backup":
                        break
                except RpcError:
                    time.sleep(0.05)
            assert mc(b"", timeout=10) == b"backup"
    finally:
        s1.stop(grace=0)
        s2.stop(grace=0)


def test_weighted_target_channel_integration_split():
    s1, p1 = _echo_server("w3")
    s2, p2 = _echo_server("w1")
    try:
        spec = {"weighted_target": [
            {"weight": 3, "policy": "pick_first", "indices": [0]},
            {"weight": 1, "policy": "pick_first", "indices": [1]}]}
        with Channel(f"ipv4:127.0.0.1:{p1},127.0.0.1:{p2}",
                     lb_policy=spec) as ch:
            mc = ch.unary_unary("/t.S/Who")
            got = [bytes(mc(b"", timeout=10)) for _ in range(8)]
        assert got.count(b"w3") == 6 and got.count(b"w1") == 2
    finally:
        s1.stop(grace=0)
        s2.stop(grace=0)


def test_update_addresses_keeps_live_subchannels():
    s1, p1 = _echo_server("s1")
    s2, p2 = _echo_server("s2")
    s3, p3 = _echo_server("s3")
    try:
        with Channel(f"ipv4:127.0.0.1:{p1},127.0.0.1:{p2}",
                     lb_policy="round_robin") as ch:
            mc = ch.unary_unary("/t.S/Who")
            assert {bytes(mc(b"", timeout=10)) for _ in range(4)} == {
                b"s1", b"s2"}
            kept = ch._subchannels[1]
            conn = kept._conn
            ch.update_addresses([("127.0.0.1", p2), f"127.0.0.1:{p3}"])
            assert ch._subchannels[0] is kept and kept._conn is conn
            assert {bytes(mc(b"", timeout=10)) for _ in range(4)} == {
                b"s2", b"s3"}
            with pytest.raises(ValueError):
                ch.update_addresses([])
    finally:
        for s in (s1, s2, s3):
            s.stop(grace=0)


def test_one_address_channel_has_one_pick_first_subchannel():
    s1, p1 = _echo_server("one")
    try:
        with Channel(f"127.0.0.1:{p1}") as ch:
            assert len(ch._subchannels) == 1
            assert ch._policy.name == "pick_first"
            assert ch.unary_unary("/t.S/Who")(b"", timeout=10) == b"one"
            assert ch._conn is ch._subchannels[0]._conn is not None
    finally:
        s1.stop(grace=0)


def test_concurrent_least_loaded_picks_stay_permutations():
    """Many threads picking and reporting at once: every order is still a
    permutation and the EWMAs stay finite."""
    pol = tres.make_policy("least_loaded", 4)
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(300):
                order = list(pol.order())
                if sorted(order) != [0, 1, 2, 3]:
                    errors.append(order)
                pol.load_report(int(rng.integers(4)),
                                f"{rng.integers(9)},{rng.integers(3)},1.0")
        except Exception as exc:  # pragma: no cover - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert all(np.isfinite(pol.snapshot()["load"]))
