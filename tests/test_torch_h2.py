"""The port's HTTP/2 framing (``tpurpc_torch.wire.h2``) and protobuf wire
primitives (``tpurpc_torch.wire.protowire``) against the reference's
(``tpurpc.wire.h2``, ``tpurpc.wire.protowire``).

Every ``pack_*`` gives the same bytes on the same inputs;
``parse_settings``, ``validate_settings`` and ``strip_padding`` accept and
reject the same inputs with the same messages; the frame scanner splits
the same byte stream, fed in seeded chunks, into the same frames; the
flow window answers the same scripted takes and grants. The protowire
module (varints, ``ld``, ``vf``, ``fields``) is compared on seeded
messages and truncations. Tolerance: exact.
"""

import numpy as np
import pytest

from tpurpc.wire import h2 as jh2
from tpurpc.wire import protowire as jpw
from tpurpc_torch.wire import h2 as th2
from tpurpc_torch.wire import protowire as tpw

CONSTANTS = ["PREFACE", "DATA", "HEADERS", "PRIORITY", "RST_STREAM",
             "SETTINGS", "PUSH_PROMISE", "PING", "GOAWAY", "WINDOW_UPDATE",
             "CONTINUATION", "FLAG_END_STREAM", "FLAG_ACK",
             "FLAG_END_HEADERS", "FLAG_PADDED", "FLAG_PRIORITY",
             "SETTINGS_HEADER_TABLE_SIZE", "SETTINGS_ENABLE_PUSH",
             "SETTINGS_MAX_CONCURRENT_STREAMS", "SETTINGS_INITIAL_WINDOW_SIZE",
             "SETTINGS_MAX_FRAME_SIZE", "SETTINGS_MAX_HEADER_LIST_SIZE",
             "TPURPC_RDV", "SETTINGS_TPURPC_RDV", "DEFAULT_WINDOW",
             "DEFAULT_MAX_FRAME", "NO_ERROR", "PROTOCOL_ERROR",
             "FLOW_CONTROL_ERROR", "CANCEL"]


def _same_outcome(jfn, tfn, *args):
    """Both return equal values, or both raise with the same message."""
    try:
        want = ("ok", jfn(*args))
    except Exception as exc:  # noqa: BLE001 — compared below
        want = ("raise", type(exc).__name__, str(exc))
    try:
        got = ("ok", tfn(*args))
    except Exception as exc:  # noqa: BLE001
        got = ("raise", type(exc).__name__, str(exc))
    assert got == want
    return want


def test_constants_equal():
    for name in CONSTANTS:
        assert getattr(th2, name) == getattr(jh2, name), name


@pytest.mark.parametrize("ftype,flags,sid,n", [
    (0x0, 0x1, 1, 0), (0x1, 0x5, 3, 17), (0x4, 0x0, 0, 36),
    (0x8, 0x0, 0x7FFFFFFF, 4), (0x9, 0x4, 0xFFFFFFFF, 300),
    (0xF0, 3, 5, 40), (0x0, 0x0, 7, 1 << 16)])
def test_pack_frame_bytes_equal(ftype, flags, sid, n):
    payload = np.random.default_rng(n).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    assert th2.pack_frame(ftype, flags, sid, payload) == \
        jh2.pack_frame(ftype, flags, sid, payload)


def test_pack_frame_too_large_raises_in_both():
    _same_outcome(lambda: jh2.pack_frame(0, 0, 1, bytes(1 << 24)),
                  lambda: th2.pack_frame(0, 0, 1, bytes(1 << 24)))


SETTINGS = [{}, {0x4: 4 << 20, 0x5: 1 << 20, 0xF0F0: 1},
            {0x1: 0, 0x3: 1024, 0x6: 8192}, {0x4: 0x7FFFFFFF, 0x99: 7}]


@pytest.mark.parametrize("i", range(len(SETTINGS)))
@pytest.mark.parametrize("ack", [False, True])
def test_pack_and_parse_settings_equal(i, ack):
    s = SETTINGS[i]
    frame = jh2.pack_settings(s, ack=ack)
    assert th2.pack_settings(s, ack=ack) == frame
    payload = frame[1] if len(frame) > 1 else b""
    assert th2.parse_settings(payload) == jh2.parse_settings(payload) == s


@pytest.mark.parametrize("payload", [b"\x00", b"\x00\x04\x00\x00\x00\x01\x00"])
def test_parse_settings_malformed_raises_in_both(payload):
    assert _same_outcome(jh2.parse_settings, th2.parse_settings,
                         payload)[0] == "raise"


@pytest.mark.parametrize("settings", [
    {}, {0x5: 16384}, {0x5: (1 << 24) - 1}, {0x5: 0}, {0x5: 16383},
    {0x5: 1 << 24}, {0x4: 0x7FFFFFFF}, {0x4: 0x80000000}, {0x4: 0xFFFFFFFF},
    {0xF0F0: 1, 0x3: 0}])
def test_validate_settings_same_verdict(settings):
    _same_outcome(jh2.validate_settings, th2.validate_settings, settings)


@pytest.mark.parametrize("last,code,debug", [
    (0, 0, b""), (7, 0, b"server drain"), (0xFFFFFFFF, 2, b"x" * 40),
    (1 << 31, 0xB, b"")])
def test_pack_goaway_bytes_equal(last, code, debug):
    assert th2.pack_goaway(last, code, debug) == \
        jh2.pack_goaway(last, code, debug)


@pytest.mark.parametrize("sid,code", [(1, 0x8), (3, 0x7), (0x7FFFFFFF, 0)])
def test_pack_rst_bytes_equal(sid, code):
    assert th2.pack_rst(sid, code) == jh2.pack_rst(sid, code)


@pytest.mark.parametrize("sid,inc", [(0, 1), (0, (4 << 20) - 65535),
                                     (5, 0x7FFFFFFF), (9, 0xFFFFFFFF)])
def test_pack_window_update_bytes_equal(sid, inc):
    assert th2.pack_window_update(sid, inc) == jh2.pack_window_update(sid, inc)


@pytest.mark.parametrize("flags,payload,prio", [
    (0, b"abc", False), (0x8, b"\x02abcde", False), (0x8, b"\x00abc", True),
    (0x28, b"\x01" + b"\x00" * 5 + b"hdr" + b"p", True),
    (0x20, b"\x00" * 5 + b"hdr", True), (0x20, b"\x00" * 5 + b"hdr", False),
    (0x8, b"", False), (0x8, b"\x09abc", False),
    (0x28, b"\x02" + b"\x00" * 5, True)])
def test_strip_padding_same_outcome(flags, payload, prio):
    _same_outcome(jh2.strip_padding, th2.strip_padding, flags, payload, prio)


@pytest.mark.parametrize("seed", range(4))
def test_frame_scanner_splits_alike(seed):
    rng = np.random.default_rng(seed)
    stream = b""
    for _ in range(20):
        n = int(rng.integers(0, 3000))
        stream += b"".join(jh2.pack_frame(
            int(rng.integers(0, 10)), int(rng.integers(0, 256)),
            int(rng.integers(0, 1 << 31)),
            rng.integers(0, 256, n, dtype=np.uint8).tobytes()))
    cuts = np.sort(rng.integers(0, len(stream), 12))
    chunks = np.split(np.frombuffer(stream, np.uint8), cuts)
    out = []
    for mod in (jh2, th2):
        sc = mod.FrameScanner()
        frames = []
        for c in chunks:
            sc.feed(c.tobytes())
            frames += sc.next_frames()
        assert sc.next_frame() is None and not sc.buf
        out.append(frames)
    assert out[0] == out[1] and len(out[0]) == 20


def test_flow_window_scripted_alike():
    def script(mod):
        w = mod.FlowWindow(100)
        log = [w.take(30), w.take(500), w.try_take(10), w.try_take(0)]
        w.grant(25)
        log += [w.try_take(26), w.try_take(25)]
        w.adjust(-10)
        log.append(w._value)
        w.adjust(60)
        log += [w.take(1000), w._value]
        try:
            w.grant(0x7FFFFFFF)
        except mod.H2Error as exc:
            log.append(str(exc))
        w.kill()
        try:
            w.take(1, timeout=1)
        except mod.H2Error as exc:
            log.append(str(exc))
        log.append(w.try_take(0))
        return log

    assert script(th2) == script(jh2)


def test_flow_window_starved_take_times_out_alike():
    for mod in (jh2, th2):
        w = mod.FlowWindow(0)
        with pytest.raises(TimeoutError):
            w.take(1, timeout=0.05)


# -- protowire -----------------------------------------------------------------

VARINTS = [0, 1, 127, 128, 300, 16383, 16384, (1 << 32) - 1, 1 << 32,
           (1 << 63) - 1, (1 << 64) - 1]


@pytest.mark.parametrize("v", VARINTS)
def test_varint_bytes_equal(v):
    raw = jpw.encode_varint(v)
    assert tpw.encode_varint(v) == raw
    assert tpw.decode_varint(raw + b"\x01", 0) == \
        jpw.decode_varint(raw + b"\x01", 0) == (v, len(raw))


@pytest.mark.parametrize("raw", [b"", b"\x80", b"\xff" * 11])
def test_varint_malformed_raises_in_both(raw):
    assert _same_outcome(jpw.decode_varint, tpw.decode_varint,
                         raw, 0)[0] == "raise"


@pytest.mark.parametrize("seed", range(4))
def test_ld_vf_fields_equal(seed):
    rng = np.random.default_rng(seed)
    msg = b""
    for _ in range(12):
        field = int(rng.integers(1, 40))
        if rng.integers(0, 2):
            payload = rng.integers(0, 256, int(rng.integers(0, 200)),
                                   dtype=np.uint8).tobytes()
            part = jpw.ld(field, payload)
            assert tpw.ld(field, payload) == part
        else:
            value = int(rng.integers(0, 1 << 40))
            part = jpw.vf(field, value)
            assert tpw.vf(field, value) == part
        msg += part
    # fixed32 and fixed64 fields too
    msg += bytes([(3 << 3) | 5]) + b"abcd" + bytes([(4 << 3) | 1]) + b"12345678"
    assert list(tpw.fields(msg)) == list(jpw.fields(msg))


@pytest.mark.parametrize("msg", [
    b"\x0a\x05abc", b"\x0d\x01\x02", b"\x09\x01", b"\x0b", b"\x08",
    b"\x0a"])
def test_fields_truncated_raises_in_both(msg):
    assert _same_outcome(lambda m: list(jpw.fields(m)),
                         lambda m: list(tpw.fields(m)), msg)[0] == "raise"


def test_health_uses_the_moved_protowire():
    from tpurpc_torch.rpc import health

    assert health._encode_varint is tpw.encode_varint
    assert health._decode_varint is tpw.decode_varint
    with pytest.raises(ImportError):
        import tpurpc_torch.rpc.protowire  # noqa: F401
