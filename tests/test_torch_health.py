"""The port's grpc.health.v1 service (``tpurpc_torch.rpc.health``) against
the reference's (``tpurpc.rpc.health``).

The messages are byte-equal (encode and decode, unknown fields skipped
alike), and so are the Check and Watch response payloads the two servers
put on the framed transport for the same requests. Then the reference's
``tests/test_health.py`` cases on the port: status lifecycle, Watch
transitions, unknown services, drain flipping to NOT_SERVING with probes
still admitted (past the admission gate too), and a malformed request
mapping to INVALID_ARGUMENT. Its stock-grpcio case waits for the port's
HTTP/2 plane.
"""

import threading
import time

import pytest

import tpurpc.rpc as jrpc
from tpurpc.rpc import health as jhealth
from tpurpc_torch.rpc import health as thealth
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.server import (AdmissionGate, Server,
                                     unary_unary_rpc_method_handler)
from tpurpc_torch.rpc.status import RpcError, StatusCode

CHECK = f"/{thealth.SERVICE_NAME}/Check"
WATCH = f"/{thealth.SERVICE_NAME}/Watch"
SERVICES = ["", "a.b.C", "demo.Svc", "x" * 200, "ünï.Cödé"]


def _rig(pkg=thealth, server=Server, **kw):
    srv = server(max_workers=4, **kw)
    servicer = pkg.add_health_servicer(srv)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, servicer, port


def probe_fresh(port, service="", timeout=10.0):
    """Check ``service`` on a fresh connection to a (draining) server. A
    server tells a connection dialed during its drain to go away (GOAWAY at
    adoption), and a client that reads the GOAWAY before it opened its
    stream fails the call with nothing sent ("while starting call"): the
    probe dials again, within ``timeout``. A probe the server refuses
    fails at once."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            with Channel(f"127.0.0.1:{port}") as ch:
                return thealth.decode_response(ch.unary_unary(CHECK)(
                    thealth.encode_request(service), timeout=timeout))
        except RpcError as exc:
            if ("while starting call" not in exc.details()
                    or time.monotonic() >= deadline):
                raise
            time.sleep(0.02)


def _poll(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- the messages --------------------------------------------------------------

@pytest.mark.parametrize("service", SERVICES)
def test_request_bytes_equal_reference(service):
    raw = thealth.encode_request(service)
    assert raw == jhealth.encode_request(service)
    assert thealth.decode_request(raw) == jhealth.decode_request(raw) \
        == service


@pytest.mark.parametrize("status", list(thealth.ServingStatus))
def test_response_bytes_equal_reference(status):
    raw = thealth.encode_response(status)
    assert raw == jhealth.encode_response(jhealth.ServingStatus(int(status)))
    assert thealth.decode_response(raw) is status
    assert int(jhealth.decode_response(raw)) == int(status)


@pytest.mark.parametrize("raw", [
    b"", b"\x0a\x03svc\x10\x05", b"\x10\x05\x0a\x01a", b"\x1a\x02hi\x0a\x00",
    b"\x08\x01", b"\x10\x07\x08\x02", b"\x1a\x01z\x08\x03", b"\x0d\x00",
    b"\x08\x96\x01"])
def test_decoders_agree_on_unknown_and_odd_fields(raw):
    try:
        want = jhealth.decode_request(raw)
    except (ValueError, IndexError, UnicodeDecodeError) as exc:
        with pytest.raises(type(exc)):
            thealth.decode_request(raw)
    else:
        assert thealth.decode_request(raw) == want
    try:
        want_st = int(jhealth.decode_response(raw))
    except ValueError as exc:
        with pytest.raises(type(exc)):
            thealth.decode_response(raw)
    else:
        assert int(thealth.decode_response(raw)) == want_st


def test_proto_roundtrip_and_unknown_fields():
    assert thealth.decode_request(thealth.encode_request("a.b.C")) == "a.b.C"
    assert thealth.decode_request(b"") == ""
    for st in thealth.ServingStatus:
        assert thealth.decode_response(thealth.encode_response(st)) is st
    extra = thealth.encode_request("svc") + b"\x10\x05"  # field 2 varint
    assert thealth.decode_request(extra) == "svc"


def test_wire_payloads_equal_reference():
    """Check and Watch replies from both servers, byte for byte."""
    tsrv, tserv, tport = _rig()
    jsrv, jserv, jport = _rig(jhealth, jrpc.Server)
    try:
        for serv, mod in ((tserv, thealth), (jserv, jhealth)):
            serv.set("demo.Svc", mod.ServingStatus.SERVING)
            serv.set("down.Svc", mod.ServingStatus.NOT_SERVING)
        with Channel(f"127.0.0.1:{tport}") as tch, \
                jrpc.Channel(f"127.0.0.1:{jport}") as jch:
            for svc in ("", "demo.Svc", "down.Svc"):
                req = thealth.encode_request(svc)
                got = bytes(tch.unary_unary(CHECK)(req, timeout=10))
                want = bytes(jch.unary_unary(CHECK)(req, timeout=10))
                assert got == want
                got = bytes(next(iter(tch.unary_stream(WATCH)(
                    req, timeout=10))))
                want = bytes(next(iter(jch.unary_stream(WATCH)(
                    req, timeout=10))))
                assert got == want
            for svc in ("no.such.Svc",):
                codes = []
                for ch in (tch, jch):
                    with pytest.raises(Exception) as ei:
                        ch.unary_unary(CHECK)(thealth.encode_request(svc),
                                              timeout=10)
                    codes.append(ei.value.code().name)
                assert codes == ["NOT_FOUND", "NOT_FOUND"]
    finally:
        tsrv.stop(grace=0)
        jsrv.stop(grace=0)


# -- the reference's test_health.py cases on the port --------------------------

def test_check_overall_and_named_service():
    srv, servicer, port = _rig()
    try:
        servicer.set("demo.Svc", thealth.ServingStatus.SERVING)
        with Channel(f"127.0.0.1:{port}") as ch:
            check = ch.unary_unary(CHECK)
            assert thealth.decode_response(
                check(thealth.encode_request(""), timeout=10)) \
                is thealth.ServingStatus.SERVING
            assert thealth.decode_response(
                check(thealth.encode_request("demo.Svc"), timeout=10)) \
                is thealth.ServingStatus.SERVING
            servicer.set("demo.Svc", thealth.ServingStatus.NOT_SERVING)
            assert thealth.decode_response(
                check(thealth.encode_request("demo.Svc"), timeout=10)) \
                is thealth.ServingStatus.NOT_SERVING
            with pytest.raises(RpcError) as ei:
                check(thealth.encode_request("no.such.Svc"), timeout=10)
            assert ei.value.code() is StatusCode.NOT_FOUND
    finally:
        srv.stop(grace=0)


def test_watch_streams_status_transitions():
    srv, servicer, port = _rig()
    try:
        servicer.set("w.Svc", thealth.ServingStatus.SERVING)
        seen = []
        done = threading.Event()

        def watch():
            with Channel(f"127.0.0.1:{port}") as ch:
                stream = ch.unary_stream(WATCH)(
                    thealth.encode_request("w.Svc"), timeout=30)
                for msg in stream:
                    seen.append(thealth.decode_response(msg))
                    if len(seen) == 3:
                        done.set()
                        return

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        assert _poll(lambda: len(seen) >= 1)
        servicer.set("w.Svc", thealth.ServingStatus.NOT_SERVING)
        assert _poll(lambda: len(seen) >= 2)
        servicer.set("w.Svc", thealth.ServingStatus.SERVING)
        assert done.wait(timeout=10), seen
        assert seen == [thealth.ServingStatus.SERVING,
                        thealth.ServingStatus.NOT_SERVING,
                        thealth.ServingStatus.SERVING]
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        srv.stop(grace=0)


def test_watch_unknown_service_reports_service_unknown():
    srv, _, port = _rig()
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            stream = iter(ch.unary_stream(WATCH)(
                thealth.encode_request("never.registered"), timeout=10))
            assert thealth.decode_response(next(stream)) \
                is thealth.ServingStatus.SERVICE_UNKNOWN
    finally:
        srv.stop(grace=0)


def test_drain_reports_not_serving_and_admits_probes():
    """During drain the health service answers NOT_SERVING (overall and
    named), on a connection dialed after the drain began too: probes are
    admitted where other calls are refused."""
    srv, servicer, port = _rig()
    srv.add_method("/t.S/Ping", unary_unary_rpc_method_handler(
        lambda req, ctx: b"pong"))
    servicer.set("drain.Svc", thealth.ServingStatus.SERVING)
    try:
        assert srv.drain(linger=1.0) is True  # no streams: clean drain
        assert srv.draining
        for svc in ("", "drain.Svc"):
            got = probe_fresh(port, svc)
            assert got is thealth.ServingStatus.NOT_SERVING, svc
        with Channel(f"127.0.0.1:{port}") as ch:
            with pytest.raises(RpcError) as ei:
                ch.unary_unary("/t.S/Ping")(b"", timeout=10)
            assert ei.value.code() is StatusCode.UNAVAILABLE
    finally:
        srv.stop(grace=0)


def test_watch_sees_drain_transition():
    srv, servicer, port = _rig()
    servicer.set("wd.Svc", thealth.ServingStatus.SERVING)
    seen = []
    try:
        def watch():
            try:
                with Channel(f"127.0.0.1:{port}") as ch:
                    stream = ch.unary_stream(WATCH)(
                        thealth.encode_request("wd.Svc"), timeout=30)
                    for msg in stream:
                        seen.append(thealth.decode_response(msg))
                        if seen[-1] is thealth.ServingStatus.NOT_SERVING:
                            return
            except RpcError:
                pass  # the draining server may close after delivery

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        assert _poll(lambda: seen)
        assert seen[0] is thealth.ServingStatus.SERVING
        # the held-open Watch does not count against the drain
        assert srv.drain(linger=5.0) is True
        t.join(timeout=10)
        assert not t.is_alive()
        assert thealth.ServingStatus.NOT_SERVING in seen, seen
    finally:
        srv.stop(grace=0)


def test_admission_exempts_health_probes():
    srv, _servicer, port = _rig(admission=AdmissionGate(1, soft_limit=1))
    hold = threading.Event()

    def slow(req, ctx):
        hold.wait(5)
        return b"ok"

    srv.add_method("/fleet.S/Slow", unary_unary_rpc_method_handler(slow))
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            fut = ch.unary_unary("/fleet.S/Slow").future(b"", timeout=10)
            assert _poll(lambda: srv.admission.inflight() >= 1)
            # the probe is admitted even though the gate is full
            assert thealth.decode_response(ch.unary_unary(CHECK)(
                thealth.encode_request(""), timeout=5)) \
                is thealth.ServingStatus.SERVING
            with pytest.raises(RpcError) as ei:
                ch.unary_unary("/fleet.S/Slow")(b"", timeout=5)
            assert ei.value.code() is StatusCode.UNAVAILABLE
            hold.set()
            assert fut.result(timeout=10) == b"ok"
    finally:
        hold.set()
        srv.stop(grace=0)


@pytest.mark.parametrize("raw", [b"\x0a\x80", b"\x0a\x05ab", b"\x0a\x02\xff\xfe"])
def test_malformed_request_maps_to_invalid_argument(raw):
    srv, _, port = _rig()
    jsrv, _, jport = _rig(jhealth, jrpc.Server)
    try:
        codes = []
        for ch in (Channel(f"127.0.0.1:{port}"),
                   jrpc.Channel(f"127.0.0.1:{jport}")):
            with ch:
                with pytest.raises(Exception) as ei:
                    ch.unary_unary(CHECK)(raw, timeout=10)
                codes.append(ei.value.code().name)
        assert codes[0] == codes[1]
        if raw == b"\x0a\x80":   # truncated length varint
            assert codes[0] == "INVALID_ARGUMENT"
    finally:
        srv.stop(grace=0)
        jsrv.stop(grace=0)
