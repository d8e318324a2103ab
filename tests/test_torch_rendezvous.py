"""The port's rendezvous plane against the reference's, on the CPU.

Every case runs the same inputs through ``tpurpc.core.rendezvous`` (and the
reference's RPC stack) and through ``tpurpc_torch.core.rendezvous`` (and the
port's), and holds the two to each other: the knobs and size classes, the
control payloads' bytes, the tensor descriptor codec over every wire dtype,
the landing pool's lifetime rules, two links wired back to back, and end to
end over TCP, the ring platform and the device-ring platform; and the two
packages against each other on one connection (interop).

Tolerances: byte and integer results are compared exactly. The device-ring
stream compares float64 sums of float32 payloads taken by numpy, XLA and
torch in different orders: relative 1e-9 (float64's rounding over 6,144
terms is below 1e-12 of the sum's scale).
"""

import gc
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpurpc.core.rendezvous as ref_rdv
from tpurpc.core import _native as ref_native
from tpurpc.jaxshim import TensorClient as RefClient
from tpurpc.jaxshim import add_tensor_method as ref_add_tensor_method
from tpurpc.jaxshim import codec as ref_codec
from tpurpc.obs import metrics as ref_metrics
from tpurpc.rpc.channel import Channel as RefChannel
from tpurpc.rpc.server import Server as RefServer
from tpurpc.rpc.server import stream_stream_rpc_method_handler as ref_ss
from tpurpc.rpc.server import unary_unary_rpc_method_handler as ref_uu
from tpurpc.rpc.status import RpcError as RefRpcError
from tpurpc.tpu import ledger as ref_ledger
from tpurpc.utils import config as ref_config
from tpurpc_torch.core import _native as port_native
from tpurpc_torch.core import rendezvous as rdv
from tpurpc_torch.core.poller import PairPool, Poller
from tpurpc_torch.ops import ring_scatter as rs_mod
from tpurpc_torch.ops import ring_window as rw_mod
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.server import (Server, stream_stream_rpc_method_handler,
                                     unary_unary_rpc_method_handler)
from tpurpc_torch.rpc.status import RpcError, StatusCode
from tpurpc_torch.torchshim import codec
from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method
from tpurpc_torch.tpu import ledger
from tpurpc_torch.utils import config as torch_config

ECHO = "/rdv.S/Echo"
TOTAL = "/rdv.S/Total"
BIG = bytes(range(256)) * (4096 + 13)   # ~1 MiB, patterned
SUM_RTOL = 1e-9


@pytest.fixture
def platform(monkeypatch):
    """``platform(name, **env)``: both packages on ``name`` with ``env``
    set, the port on the CPU; the port's singletons reset afterwards."""
    # The reference loads its native library on a ring's first use and,
    # in a checkout without native/build, first builds it with g++ under
    # an exclusive lock that every other process waits on for the whole
    # compile. Take that wait here, not inside a call that has a deadline.
    ref_native.load()
    port_native.load()  # and the port's, outside deadlines too

    def use(name, **env):
        monkeypatch.setenv("GRPC_PLATFORM_TYPE", name)
        monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        ref_config.set_config(None)
        torch_config.set_config(None)
    yield use
    Poller.reset()
    PairPool.reset()
    torch_config.set_config(None)


@pytest.fixture
def fresh_pools(monkeypatch):
    """Empty process-wide landing pools in both packages, so a budget set
    by the test binds (the regions of earlier tests stay in the old
    pools)."""
    monkeypatch.setattr(ref_rdv, "_pools", {})
    monkeypatch.setattr(rdv, "_pools", {})
    yield
    for m in (ref_rdv, rdv):
        for pool in m._pools.values():
            pool.trim()   # unmap and unlink what the test left pooled


# ---------------------------------------------------------------------------
# The two packages behind one interface.
# ---------------------------------------------------------------------------

def _ref_totals(ch=None, srv=None):
    """The reference counts transfers process-wide."""
    m = ref_metrics.registry().metrics()
    return {"sent": m["rdv_transfers_sent"].snapshot(),
            "received": m["rdv_transfers_received"].snapshot(),
            "fallbacks": m["rdv_fallbacks"].snapshot()}


def _port_totals(ch=None, srv=None):
    """The port counts per link; a scenario's links are all new."""
    links = []
    if ch is not None and ch._conn is not None:
        links.append(ch._conn.rdv)
    if srv is not None:
        links += [c.rdv for c in list(srv._connections)]
    return {k: sum(link.stats()[k] for link in links if link is not None)
            for k in ("sent", "received", "fallbacks")}


REF = SimpleNamespace(
    name="ref", rdv=ref_rdv, codec=ref_codec, ledger=ref_ledger,
    server=lambda **kw: RefServer(native_dataplane=False, **kw),
    channel=RefChannel, uu=ref_uu, ss=ref_ss, error=RefRpcError,
    unary=lambda ch, path: ch.unary_unary(path, tpurpc_native=False),
    stream=lambda ch, path: ch.stream_stream(path, tpurpc_native=False),
    add=ref_add_tensor_method,
    duplex=lambda ch, name, trees: RefClient(ch).duplex(
        name, trees, timeout=60, native=False),
    tensor=lambda a: a, totals=_ref_totals)

PORT = SimpleNamespace(
    name="port", rdv=rdv, codec=codec, ledger=ledger,
    server=lambda **kw: Server(native_dataplane=False, **kw),
    channel=Channel,
    uu=unary_unary_rpc_method_handler, ss=stream_stream_rpc_method_handler,
    error=RpcError,
    unary=lambda ch, path: ch.unary_unary(path, tpurpc_native=False),
    stream=lambda ch, path: ch.stream_stream(path, tpurpc_native=False),
    add=add_tensor_method,
    duplex=lambda ch, name, trees: TensorClient(ch).duplex(
        name, trees, timeout=60, native=False),
    tensor=torch.from_numpy, totals=_port_totals)

BOTH = (REF, PORT)


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _echo_server(pkg, **kw):
    kw.setdefault("max_workers", 4)
    srv = pkg.server(**kw)
    srv.add_method(ECHO, pkg.uu(lambda req, ctx: bytes(req)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _total_server(pkg):
    srv = pkg.server(max_workers=4)

    def total(req_iter, ctx):
        n = 0
        for m in req_iter:
            n += len(m)
        yield str(n).encode()

    srv.add_method(TOTAL, pkg.ss(total))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _same(results):
    """Both packages' observations, which must be equal; returns one."""
    assert results["ref"] == results["port"], results
    return results["port"]


# ---------------------------------------------------------------------------
# Knobs and size classes.
# ---------------------------------------------------------------------------

SIZES = [0, 1, 65535, 65536, 65537, 100_000, 131072, 131073, 4 << 20,
         (4 << 20) + 1, (1 << 30) - 1, 1 << 30]


@pytest.mark.parametrize("n", SIZES)
def test_size_class_matches_reference(n):
    got = rdv.size_class(n)
    assert got == ref_rdv.size_class(n)
    assert got >= max(n, 64 * 1024) and got & (got - 1) == 0


def test_size_class_refuses_past_the_bound_like_the_reference():
    for m in (ref_rdv, rdv):
        with pytest.raises(ValueError):
            m.size_class((1 << 30) + 1)


@pytest.mark.parametrize("val", [None, "256", "64", "1", "0", "-5", "abc"])
def test_min_bytes_matches_reference(monkeypatch, val):
    if val is None:
        monkeypatch.delenv("TPURPC_RENDEZVOUS_MIN_KB", raising=False)
    else:
        monkeypatch.setenv("TPURPC_RENDEZVOUS_MIN_KB", val)
    assert rdv.min_bytes() == ref_rdv.min_bytes()


@pytest.mark.parametrize("val", [None, "1", "0", "off", "OFF", "false",
                                 "yes"])
def test_enabled_matches_reference(monkeypatch, val):
    if val is None:
        monkeypatch.delenv("TPURPC_RENDEZVOUS", raising=False)
    else:
        monkeypatch.setenv("TPURPC_RENDEZVOUS", val)
    assert rdv.enabled() == ref_rdv.enabled()


# ---------------------------------------------------------------------------
# Control payloads: the bytes on the wire.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds", [(), ("shm",), ("shm", "local")])
def test_offer_bytes_match_reference(kinds):
    want = ref_rdv._pack_offer(17, 4 << 20, kinds)
    assert rdv._pack_offer(17, 4 << 20, kinds) == want
    assert rdv._unpack_offer(want) == ref_rdv._unpack_offer(want)


def _lease_stub(standing: bool):
    fields = ("shm", "shm:psm_abc123", 13, 1 << 22, bytes(range(16)),
              standing)
    return SimpleNamespace(lease_id=42, claim_fields=lambda: fields)


@pytest.mark.parametrize("req,standing,granted", [
    (9, False, True), (9, True, True), (0, True, True), (9, False, False)])
def test_claim_bytes_match_reference(req, standing, granted):
    lease = _lease_stub(standing) if granted else None
    want = ref_rdv._pack_claim(req, lease)
    assert rdv._pack_claim(req, lease) == want
    r_req, r_claim = ref_rdv._unpack_claim(want)
    p_req, p_claim = rdv._unpack_claim(want)
    assert p_req == r_req == req
    if not granted:
        assert p_claim is None and r_claim is None
        return
    names = ("lease_id", "kind", "handle", "offset", "capacity", "nonce",
             "standing", "used")
    assert ([getattr(p_claim, k) for k in names]
            == [getattr(r_claim, k) for k in names])
    assert p_claim.standing is standing


def test_complete_and_release_bytes_match_reference():
    for name, args in (("_COMPLETE", (42, 1 << 20, 0x1FF & 0xFF)),
                       ("_RELEASE", (42, 0)), ("_RELEASE", (0, 9))):
        assert (getattr(rdv, name).pack(*args)
                == getattr(ref_rdv, name).pack(*args))
    assert rdv.HELLO_PAYLOAD == ref_rdv.HELLO_PAYLOAD
    assert (rdv.OP_OFFER, rdv.OP_CLAIM, rdv.OP_COMPLETE, rdv.OP_RELEASE) \
        == (ref_rdv.OP_OFFER, ref_rdv.OP_CLAIM, ref_rdv.OP_COMPLETE,
            ref_rdv.OP_RELEASE)


# ---------------------------------------------------------------------------
# Tensor descriptors over every wire dtype.
# ---------------------------------------------------------------------------

CODES = sorted(codec._CODE_TO_DTYPE)


def _pair_of_tensors(code, shape, seed):
    """The same bytes as a numpy array of the reference's dtype and a torch
    tensor of the port's."""
    npdt = ref_codec._CODE_TO_DTYPE[code]
    tdt = codec._CODE_TO_DTYPE[code]
    count = int(np.prod(shape, dtype=np.int64))
    raw = np.random.default_rng(seed).integers(
        0, 256, count * npdt.itemsize, dtype=np.uint8)
    if npdt == np.bool_:
        raw &= 1
    arr = raw.view(npdt).reshape(shape)
    if count == 0:
        return arr, torch.empty(shape, dtype=tdt)
    return arr, torch.from_numpy(raw.copy()).view(tdt).reshape(shape)


@pytest.mark.parametrize("shape", [(7, 5), (0, 3), ()],
                         ids=["7x5", "empty", "0d"])
@pytest.mark.parametrize("code", CODES)
def test_descriptor_roundtrip_matches_reference(code, shape):
    arr, t = _pair_of_tensors(code, shape, seed=code)
    r_desc, r_payload = ref_codec.encode_tensor_descriptor(arr)
    p_desc, p_payload = codec.encode_tensor_descriptor(t)
    assert p_desc == r_desc and len(p_desc) % 64 == 0
    assert bytes(p_payload) == bytes(r_payload)
    # the payload lands in a region of its own; the decode aliases it
    region = bytearray(bytes(r_payload))
    back = codec.decode_tensor_external(r_desc, memoryview(region))
    want = ref_codec.decode_tensor_external(r_desc, memoryview(region))
    assert tuple(back.shape) == want.shape and back.dtype == t.dtype
    got = (bytes(back.reshape(-1).view(torch.uint8).numpy())
           if back.numel() else b"")
    assert got == want.tobytes() == bytes(r_payload)
    if len(region):
        region[0] ^= 0xFF  # a write to the region shows through the tensor
        assert back.reshape(-1).view(torch.uint8)[0].item() == region[0]


@pytest.mark.parametrize("code", [0, 11])
def test_descriptor_short_payload_raises_like_reference(code):
    arr, t = _pair_of_tensors(code, (65, 3), seed=3)
    desc, payload = codec.encode_tensor_descriptor(t)
    with pytest.raises(ref_codec.CodecError):
        ref_codec.decode_tensor_external(desc, payload[:100])
    with pytest.raises(codec.CodecError):
        codec.decode_tensor_external(desc, payload[:100])


# ---------------------------------------------------------------------------
# Landing pool: each scenario runs on both packages' pools.
# ---------------------------------------------------------------------------

def _scenario_classes(m, kind):
    pool = m.LandingPool(kind)
    lease = pool.lease(100_000, 1)
    wrapper = lease.deliver(100_000)
    flat = np.frombuffer(wrapper, np.uint8)
    out = [lease.pr.capacity, flat.ctypes.data % 64, len(wrapper)]
    del flat, wrapper
    gc.collect()
    pool.trim()
    return out


def _scenario_recycle(m, kind):
    pool = m.LandingPool(kind)
    lease = pool.lease(70_000, 1)
    body = lease.deliver(70_000)
    view = np.frombuffer(body, np.uint8)[10:20]  # a consumer alias
    del body
    gc.collect()
    out = [pool.stats()["free_regions"]]       # the alias pins it
    del view
    gc.collect()
    out.append(pool.stats()["free_regions"])   # recycled
    before = pool.stats()["allocated_bytes"]
    lease2 = pool.lease(70_000, 2)
    out.append(pool.stats()["allocated_bytes"] == before)  # reused
    lease2.release()
    out.append(pool.stats()["free_regions"])
    pool.trim()
    return out


def _scenario_budget(m, kind):
    pool = m.LandingPool(kind, budget=256 * 1024)
    l1 = pool.lease(100_000, 1)
    out = [l1 is not None, pool.lease(100_000, 2) is None]
    l1.release()
    l3 = pool.lease(100_000, 3)
    out.append(l3 is not None)
    l3.release()
    pool.trim()
    return out


def _scenario_discard(m, kind):
    pool = m.LandingPool(kind)
    lease = pool.lease(65_536, 1)
    lease.release(discard=True)
    out = [pool.stats()]
    lease2 = pool.lease(65_536, 2)
    body = lease2.deliver(65_536)
    lease2.release(discard=True)   # aliased: destruction waits for the GC
    out.append(pool.stats())
    del body
    gc.collect()
    pool.lease(65_536, 3).release()  # sweeps the zombie; never reused
    out.append(pool.stats())
    pool.trim()
    return out


def _scenario_doorbell(m, kind):
    pool = m.LandingPool(kind)
    lease = pool.lease(65_536, 1)
    lease.standing = True
    db = lease.pr.offset + lease.pr.capacity + 16
    body = lease.deliver(1024)
    out = [bytes(lease.pr.region.buf[db:db + 8])]
    del body
    gc.collect()
    out.append(bytes(lease.pr.region.buf[db:db + 8]))  # freed count 1
    body2 = lease.deliver(2048)                         # legal again
    try:
        lease.deliver(512)   # a third while body2 is aliased: violation
        out.append("delivered")
    except RuntimeError:
        out.append("refused")
    del body2
    gc.collect()
    lease.release()
    out.append(pool.stats()["free_regions"])
    pool.trim()
    return out


SCENARIOS = {"classes": _scenario_classes, "recycle": _scenario_recycle,
             "budget": _scenario_budget, "discard": _scenario_discard,
             "doorbell": _scenario_doorbell}
EXPECTED = {
    "classes": [128 * 1024, 0, 100_000],
    "recycle": [0, 1, True, 1],
    "budget": [True, True, True],
    # the aliased region stays allocated until its alias dies; the next
    # lease is a new region
    "discard": [{"allocated_bytes": 0, "free_regions": 0},
                {"allocated_bytes": rdv._alloc_bytes(65_536),
                 "free_regions": 0},
                {"allocated_bytes": rdv._alloc_bytes(65_536),
                 "free_regions": 1}],
    "doorbell": [b"\x00" * 8, struct.pack("<Q", 1), "refused", 1],
}


@pytest.mark.parametrize("kind", ["local", "shm"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_landing_pool_matches_reference(name, kind):
    got = _same({m.name: SCENARIOS[name](m.rdv, kind) for m in BOTH})
    assert got == EXPECTED[name]


def _scenario_torch_alias(pkg, kind):
    """A tensor decoded from a delivered region pins it; a slice of that
    tensor pins it too; the region recycles when the last one dies."""
    pool = pkg.rdv.LandingPool(kind)
    x = np.arange(4096, dtype=np.float32)
    rec = codec.encode_tensor_bytes(torch.from_numpy(x))
    lease = pool.lease(len(rec), 1)
    off = lease.pr.offset
    lease.pr.region.buf[off:off + len(rec)] = rec
    body = lease.deliver(len(rec))
    t, _ = pkg.codec.decode_tensor(body)
    del body
    gc.collect()
    out = [pool.stats()["free_regions"], bool((np.asarray(t) == x).all())]
    part = t[1:3]
    del t
    gc.collect()
    out.append(pool.stats()["free_regions"])
    out.append([float(v) for v in part])
    del part
    gc.collect()
    out.append(pool.stats()["free_regions"])
    pool.trim()
    return out


@pytest.mark.parametrize("kind", ["local", "shm"])
def test_region_outlives_no_torch_alias(kind):
    got = _same({m.name: _scenario_torch_alias(m, kind) for m in BOTH})
    assert got == [0, True, 0, [1.0, 2.0], 1]


# ---------------------------------------------------------------------------
# Two links back to back (the control frames as direct calls).
# ---------------------------------------------------------------------------

def _linked(m, kind):
    """A sender link and a receiver link whose control ops are delivered
    synchronously to each other; bodies the receiver delivers are kept."""
    bodies = []
    a = m.RdvLink("a", lambda *op: b.on_op(*op), lambda *d: None,
                  pool_kinds=(kind,), open_kinds=(kind,))
    b = m.RdvLink("b", lambda *op: a.on_op(*op),
                  lambda sid, flags, body: bodies.append(body),
                  pool_kinds=(kind,), open_kinds=(kind,))
    a.on_peer_hello()
    b.on_peer_hello()
    return a, b, bodies


def _view(link):
    s = link.stats()
    return (s["negotiated"], s["claimed_leases"], s["cached_grants"])


def _scenario_steady(m, kind):
    a, b, bodies = _linked(m, kind)
    pool = m.landing_pool(kind)
    out = []
    payloads = [np.full(100_000, i, np.uint8) for i in range(8)]
    # first send: a solicited claim; the delivery tops up 4 standing grants
    assert a.send_message(1, 0, [payloads[0]], 100_000)
    out.append((_view(a), _view(b), bytes(bodies[0]) == payloads[0].tobytes()))
    bodies.clear()
    gc.collect()
    # each body dies before the next send: one standing region is reused
    for p in payloads[1:3]:
        assert a.send_message(1, 0, [p], 100_000)
        out.append((_view(a), _view(b), bytes(bodies[-1]) == p.tobytes()))
        bodies.clear()
        gc.collect()
    # bodies kept alive: the 4 standing regions are used, then a fifth
    # send finds every doorbell behind and claims a one-shot region
    for p in payloads[3:]:
        assert a.send_message(1, 0, [p], 100_000)
    out.append((_view(a), _view(b), len(bodies),
                [bytes(x[:1]) for x in bodies]))
    bodies.clear()
    gc.collect()
    a.close()
    b.close()
    out.append((_view(b), pool.stats()["allocated_bytes"]))
    return out


@pytest.mark.parametrize("kind", ["local", "shm"])
def test_linked_steady_state_matches_reference(fresh_pools, kind):
    got = _same({m.name: _scenario_steady(m.rdv, kind) for m in BOTH})
    assert got[0] == ((1, 0, 4), (1, 4, 0), True)
    assert got[1] == got[2] == ((1, 0, 4), (1, 4, 0), True)
    assert got[3] == ((1, 0, 4), (1, 4, 0), 5,
                      [bytes([i]) for i in range(3, 8)])
    # the standing regions died with the link; the two one-shot leases'
    # region (one, reused) went back to the pool
    assert got[4] == ((1, 0, 0), rdv._alloc_bytes(128 * 1024))


def _scenario_peer_death(m, kind):
    a, b, bodies = _linked(m, kind)
    pool = m.landing_pool(kind)
    claim = a.rdv_claim(1, 100_000, m.size_class(100_000))
    out = [claim is not None, _view(b), pool.stats()["allocated_bytes"] > 0]
    b.close()   # the receiver's connection dies with the region claimed
    out += [_view(b), pool.stats()]
    # the sender's late write lands in orphaned memory, never a new lease
    a.close()
    return out


@pytest.mark.parametrize("kind", ["local", "shm"])
def test_linked_peer_death_releases_claims(fresh_pools, kind):
    got = _same({m.name: _scenario_peer_death(m.rdv, kind) for m in BOTH})
    assert got == [True, (1, 1, 0), True, (1, 0, 0),
                   {"allocated_bytes": 0, "free_regions": 0}]


def _scenario_refused(m, kind):
    a, b, bodies = _linked(m, kind)
    b.recv_limit = 64 * 1024     # past the limit: refused, then framed
    out = [a.send_message(1, 0, [BIG], len(BIG)), _view(a), _view(b)]
    a.close()
    b.close()
    return out


@pytest.mark.parametrize("kind", ["local", "shm"])
def test_linked_refusal_falls_back_like_reference(fresh_pools, kind):
    got = _same({m.name: _scenario_refused(m.rdv, kind) for m in BOTH})
    assert got == [False, (1, 0, 0), (1, 0, 0)]


def test_port_link_counts_its_transfers(fresh_pools):
    a, b, bodies = _linked(rdv, "local")
    assert a.send_message(1, 0, [BIG], len(BIG))
    b.recv_limit = 1024
    a._grants.clear()   # no standing grant: the next offer is refused
    assert not a.send_message(1, 0, [BIG], len(BIG))
    sa, sb = a.stats(), b.stats()
    assert (sa["sent"], sa["fallbacks"], sb["received"], sb["refused"]) \
        == (1, 1, 1, 1)
    # a: two offers; b: one claim, four pre-grants, one refusal
    assert (sa["ctrl_frames"], sb["ctrl_frames"]) == (3, 6)
    bodies.clear()
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# End to end, each scenario on both packages.
# ---------------------------------------------------------------------------

def _scenario_unary(pkg):
    before = pkg.totals()
    srv, port = _echo_server(pkg)
    try:
        with pkg.channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.unary(ch, ECHO)
            # a small call settles the hello exchange first
            small = bytes(mc(b"tiny", timeout=10))
            out = bytes(mc(BIG, timeout=30))
            counts = _delta(pkg.totals(ch, srv), before)
    finally:
        srv.stop(grace=1)
    return small, out == BIG, counts


@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
def test_unary_1mib_both_ways(platform, name):
    platform(name)
    got = _same({m.name: _scenario_unary(m) for m in BOTH})
    # request and response each rode the bulk plane
    assert got == (b"tiny", True, {"sent": 2, "received": 2, "fallbacks": 0})


def _sink(pkg, each=None):
    """bench.py's Sink: the stream's byte total and a checksum of two
    elements per message (each read through the decoded alias);
    ``each()`` runs after each message is read."""
    def consume(req_iter):
        total = 0
        checks = 0.0
        for tree in req_iter:
            arr = tree["x"]
            total += arr.nbytes
            checks += float(arr[0, 0]) + float(arr[-1, -1])
            if each is not None:
                each()
        yield {"bytes": np.int64(total), "check": np.float64(checks)}
    srv = pkg.server(max_workers=4)
    pkg.add(srv, "Sink", consume, kind="stream_stream")
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _scenario_stream_ledger(pkg, n=8, step=False):
    """The stream's ledger. With ``step`` the timed messages go in step
    with the handler: message i leaves once the handler has read message
    i-1, so each finds a standing region its doorbell has freed. A sender
    that runs ahead solicits a claim (an OFFER and a CLAIM framed) whenever
    the handler lags 2 ms behind, which the host's load decides, in both
    packages; on the ring platform the pair's ring bills those frames."""
    payload = np.random.default_rng(7).standard_normal(
        (512, 512)).astype(np.float32)   # 1 MiB
    read = threading.Semaphore(0)

    def gen(k, step=False):
        for i in range(k):
            if step and i:
                assert read.acquire(timeout=30), "the handler stalled"
            yield {"x": pkg.tensor(payload)}

    srv, port = _sink(pkg, each=read.release)
    try:
        with pkg.channel(f"127.0.0.1:{port}") as ch:
            list(pkg.duplex(ch, "Sink", gen(2)))   # warm-up: hello settles
            while read.acquire(blocking=False):
                pass                               # the warm-up's reads
            before = pkg.totals(ch, srv)
            with pkg.ledger.track() as w:
                replies = list(pkg.duplex(ch, "Sink", gen(n, step=step)))
            counts = _delta(pkg.totals(ch, srv), before)
    finally:
        srv.stop(grace=1)
    total = int(np.asarray(replies[-1]["bytes"]).ravel()[0])
    check = float(np.asarray(replies[-1]["check"]).ravel()[0])
    keys = ("rdma_write", "rdma_write_ops", "host_copy", "host_copy_ops",
            "zero_copy", "dma_h2d", "dma_d2d")
    return (total, check, counts, {k: w[k] for k in keys},
            n * (float(payload[0, 0]) + float(payload[-1, -1])),
            payload.nbytes)


@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
def test_tensor_stream_ledger_matches_reference(platform, name):
    # descriptor rings off: both packages frame their control ops
    if name == "TCP":
        platform(name, TPURPC_CTRL_RING="0")
        got = _same({m.name: _scenario_stream_ledger(m) for m in BOTH})
    else:
        # on the ring platform the pair's ring bills the control frames'
        # bytes as host_copy on both sides, which the same coalescer makes
        # equal. Both channels' tail-capture trace header rides each
        # HEADERS alike; the load report's p99 (each watchdog's, whose
        # digits follow the process's earlier calls) is off for the length
        # of the case, and the stream goes in step with the handler, so
        # that the ledgers compare whole.
        platform(name, TPURPC_CTRL_RING="0", TPURPC_LOAD_REPORTS="0")
        res = {m.name: _scenario_stream_ledger(m, step=True) for m in BOTH}
        # The number of ring writes and reads that carry those bytes
        # (host_copy_ops) depends on how the reader's drains batch frames
        # in time, and varies between runs of one package alike: it is
        # held to the same bound on both, every other entry compared whole
        ops = {k: r[3].pop("host_copy_ops") for k, r in res.items()}
        got = _same(res)
        assert all(0 < n <= 32 for n in ops.values()), ops
    total, check, counts, delta, want_check, nbytes = got
    assert total == 8 * nbytes and check == want_check
    assert counts == {"sent": 8, "received": 8, "fallbacks": 0}
    # every payload byte moved by one one-sided write, none landed by a
    # host copy (the small reply still rides the framed path)
    assert delta["rdma_write_ops"] == 8 and delta["rdma_write"] >= 8 * nbytes
    assert delta["host_copy"] < 64 * 1024, delta


def _scenario_disabled(pkg):
    before = pkg.totals()
    srv, port = _echo_server(pkg)
    try:
        with pkg.channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.unary(ch, ECHO)
            out = bytes(mc(BIG, timeout=30)) == BIG
            links = (ch._conn.rdv if pkg is PORT else None,
                     [c.rdv for c in srv._connections] if pkg is PORT
                     else None)
            counts = _delta(pkg.totals(ch, srv), before)
    finally:
        srv.stop(grace=1)
    return out, counts, links


def test_disabled_rendezvous_stays_framed(platform):
    platform("TCP", TPURPC_RENDEZVOUS="0")
    got = {m.name: _scenario_disabled(m) for m in BOTH}
    assert got["ref"][:2] == got["port"][:2] == (
        True, {"sent": 0, "received": 0, "fallbacks": 0})
    assert got["port"][2] == (None, [None])   # no link at all


def _scenario_exhausted(pkg):
    before = pkg.totals()
    srv, port = _echo_server(pkg)
    big = b"f" * (4 << 20)   # 4 MiB > the whole 1 MiB pool budget
    try:
        with pkg.channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.unary(ch, ECHO)
            assert bytes(mc(b"tiny", timeout=10)) == b"tiny"
            out = bytes(mc(big, timeout=60)) == big
            counts = _delta(pkg.totals(ch, srv), before)
    finally:
        srv.stop(grace=1)
    return out, counts


def test_pool_exhaustion_falls_back_to_framed(platform, fresh_pools):
    platform("TCP", TPURPC_RENDEZVOUS_POOL_MB="1")
    got = _same({m.name: _scenario_exhausted(m) for m in BOTH})
    # both directions were refused a region and framed instead
    assert got == (True, {"sent": 0, "received": 0, "fallbacks": 2})


def _scenario_recv_limit(pkg):
    srv, port = _echo_server(pkg, max_receive_message_length=512 * 1024)
    try:
        with pkg.channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.unary(ch, ECHO)
            ok = bytes(mc(b"ok", timeout=10))
            with pytest.raises(pkg.error) as exc:
                mc(b"z" * (1 << 20), timeout=30)
    finally:
        srv.stop(grace=1)
    return ok, exc.value.code().name


def test_recv_limit_not_bypassed(platform):
    platform("TCP")
    got = _same({m.name: _scenario_recv_limit(m) for m in BOTH})
    assert got == (b"ok", StatusCode.RESOURCE_EXHAUSTED.name)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _scenario_peer_death_e2e(pkg):
    """The client vanishes with standing regions claimed on the server:
    the server's link releases (destroys) every one of them."""
    srv, port = _total_server(pkg)
    payload = bytes(range(256)) * 4096   # 1 MiB
    pool = pkg.rdv.landing_pool("shm")
    try:
        ch = pkg.channel(f"127.0.0.1:{port}")
        mc = pkg.stream(ch, TOTAL)
        assert list(mc(iter([b"warm"]), timeout=30)) == [b"4"]
        out = list(mc(iter([payload] * 3), timeout=60))
        link = srv._connections[0].rdv
        held = link.stats()["claimed_leases"]
        gc.collect()
        allocated = pool.stats()["allocated_bytes"]
        ch.close()
        released = _wait(lambda: link.closed
                         and link.stats()["claimed_leases"] == 0)

        def only_free():
            # what stays allocated is pooled free regions (the one-shot
            # leases' recycled ones): every standing region was destroyed.
            # The link drops its leases before it destroys their regions,
            # so this is awaited, not read once
            gc.collect()
            after = pool.stats()
            return (after["allocated_bytes"]
                    == after["free_regions"] * rdv._alloc_bytes(1 << 20))

        destroyed = _wait(only_free)
    finally:
        srv.stop(grace=1)
    return out, held, allocated > 0, released, destroyed


def test_peer_death_releases_claimed_regions(platform, fresh_pools):
    platform("TCP")
    got = _same({m.name: _scenario_peer_death_e2e(m) for m in BOTH})
    assert got == ([str(3 << 20).encode()], 4, True, True, True)


# ---------------------------------------------------------------------------
# The device-ring stream on the CPU.
# ---------------------------------------------------------------------------

RING_KB = 64
STREAM = 6
ELEMS = 6144   # 24 KiB payloads: the 3rd and 6th wrap the 64 KiB ring


@pytest.fixture
def counted_plain(monkeypatch):
    """Count calls of the kernels' plain versions (the CPU path)."""
    calls = {"ring_scatter": 0, "ring_window": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(rs_mod, "ring_scatter_plain",
                        counting("ring_scatter", rs_mod.ring_scatter_plain))
    monkeypatch.setattr(rw_mod, "ring_window_plain",
                        counting("ring_window", rw_mod.ring_window_plain))
    return calls


def _device_sink(pkg):
    """Each message's float64 sum, reduced from its device-ring view
    before the next message is pulled."""
    def consume(trees):
        sums = []
        for tree in trees:
            x = tree["x"]
            if pkg is PORT:
                assert x.device.type == "cpu" and x.shape == (ELEMS,)
                sums.append(float(x.double().sum()))
            else:
                sums.append(float(np.asarray(x).astype(np.float64).sum()))
        yield {"sums": np.asarray(sums, np.float64)}
    srv = pkg.server(max_workers=4)
    pkg.add(srv, "Sink", consume, kind="stream_stream", device=True)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def _scenario_device_stream(pkg, xs):
    srv, port = _device_sink(pkg)
    try:
        with pkg.channel(f"127.0.0.1:{port}") as ch:
            before = pkg.totals(ch, srv)
            replies = list(pkg.duplex(
                ch, "Sink", ({"x": pkg.tensor(x)} for x in xs)))
            counts = _delta(pkg.totals(ch, srv), before)
            ring = srv._connections[0].endpoint.device_ring
    finally:
        srv.stop(grace=1)
    return np.asarray(replies[-1]["sums"]), counts, ring


def test_device_ring_stream_matches_reference(platform, counted_plain):
    platform("TPU", TPURPC_HBM_RING_SIZE_KB=str(RING_KB),
             TPURPC_RENDEZVOUS_MIN_KB="16")
    rng = np.random.default_rng(23)
    xs = [(rng.standard_normal(ELEMS) + i).astype(np.float32)
          for i in range(STREAM)]
    want = np.array([x.astype(np.float64).sum() for x in xs])
    ref_sums, ref_counts, _ = _scenario_device_stream(REF, xs)
    sums, counts, ring = _scenario_device_stream(PORT, xs)
    np.testing.assert_allclose(sums, ref_sums, rtol=SUM_RTOL, atol=0)
    np.testing.assert_allclose(sums, want, rtol=SUM_RTOL, atol=0)
    # every message rode rendezvous (the ring platform negotiates at the
    # pair bootstrap: no warm-up needed) ...
    assert counts == ref_counts == {"sent": STREAM, "received": STREAM,
                                    "fallbacks": 0}
    # ... and landed in the device ring: two of six wrap it
    assert counted_plain == {"ring_scatter": 2, "ring_window": 2}
    stats = ring.stats()
    assert stats["head"] == stats["tail"] and stats["live_spans"] == 0


# ---------------------------------------------------------------------------
# Interop: a port client to a reference server, and the other way round.
# ---------------------------------------------------------------------------

def _interop(server_pkg, client_pkg):
    srv, port = _total_server(server_pkg)
    payload = bytes(range(256)) * 4096   # 1 MiB
    n = 4
    ref0 = _ref_totals()
    try:
        with client_pkg.channel(f"127.0.0.1:{port}") as ch:
            mc = client_pkg.stream(ch, TOTAL)
            # a tiny stream settles the hello; snapshot after it
            assert list(mc(iter([b"warm"]), timeout=30)) == [b"4"]
            ref1 = _ref_totals()
            out = list(mc(iter([payload] * n), timeout=60))
            port_counts = _port_totals(ch if client_pkg is PORT else None,
                                       srv if server_pkg is PORT else None)
        ref_counts = _delta(_ref_totals(), ref1)
    finally:
        srv.stop(grace=1)
    assert _delta(ref1, ref0)["fallbacks"] == 0
    return out, n * len(payload), port_counts, ref_counts


@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
def test_port_client_to_reference_server(platform, name):
    platform(name)
    out, nbytes, port_counts, ref_counts = _interop(REF, PORT)
    assert out == [str(nbytes).encode()]
    # the port sent every payload into the reference's regions
    assert port_counts == {"sent": 4, "received": 0, "fallbacks": 0}
    assert ref_counts == {"sent": 0, "received": 4, "fallbacks": 0}


@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
def test_reference_client_to_port_server(platform, name):
    platform(name)
    out, nbytes, port_counts, ref_counts = _interop(PORT, REF)
    assert out == [str(nbytes).encode()]
    assert ref_counts == {"sent": 4, "received": 0, "fallbacks": 0}
    assert port_counts == {"sent": 0, "received": 4, "fallbacks": 0}


def _scenario_reader_thread(m):
    a, b, bodies = _linked(m, "local")
    out = [a.eligible(len(BIG)), a.eligible(1024)]
    a.disallowed_thread = threading.get_ident()
    out.append(a.eligible(len(BIG)))
    seen = []
    t = threading.Thread(target=lambda: seen.append(a.eligible(len(BIG))))
    t.start()
    t.join(10)
    out += seen
    a.close()
    out.append(a.eligible(len(BIG)))
    b.close()
    return out


def test_reader_thread_sends_frame_instead_of_waiting():
    """A send from the connection's reader thread is never eligible: it
    would wait for a CLAIM that only that thread could deliver. Below the
    size bar and after close nothing is eligible either."""
    got = _same({m.name: _scenario_reader_thread(m.rdv) for m in BOTH})
    assert got == [True, False, False, True, False]


def _scenario_concurrent(pkg, threads=8, calls=6):
    """Many threads share one connection's link: standing grants, claims
    and doorbells under contention. Every reply must be its own request."""
    import sys

    before = pkg.totals()
    srv, port = _echo_server(pkg, max_workers=threads)
    bad, errors = [], []
    try:
        with pkg.channel(f"127.0.0.1:{port}") as ch:
            mc = pkg.unary(ch, ECHO)
            assert bytes(mc(b"tiny", timeout=10)) == b"tiny"

            def worker(t):
                try:
                    for k in range(calls):
                        req = bytes([t, k]) * (150 * 1024)   # 300 KiB
                        if bytes(mc(req, timeout=60)) != req:
                            bad.append((t, k))
                except Exception as exc:   # surfaced by the assert below
                    errors.append(repr(exc))

            old = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                ts = [threading.Thread(target=worker, args=(t,))
                      for t in range(threads)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(120)
            finally:
                sys.setswitchinterval(old)
            alive = any(t.is_alive() for t in ts)
            counts = _delta(pkg.totals(ch, srv), before)
    finally:
        srv.stop(grace=1)
    return alive, errors, bad, counts


def test_concurrent_calls_share_one_link(platform):
    platform("RDMA_BPEV")
    got = _same({m.name: _scenario_concurrent(m) for m in BOTH})
    assert got == (False, [], [], {"sent": 96, "received": 96,
                                   "fallbacks": 0})


# ---------------------------------------------------------------------------
# A delivered body is dropped as soon as the handler moves on (a port
# divergence, ROADMAP C): its landing region recycles, and its standing
# grant's doorbell rings, while the handler waits for the next message.
# ---------------------------------------------------------------------------

def _dropped_while_waiting(make_iter, put, end):
    import weakref

    body = np.zeros(8)
    ref = weakref.ref(body)
    put(body)
    del body
    it = make_iter()
    first = next(it)
    del first
    rest = []
    t = threading.Thread(target=lambda: rest.extend(it))
    t.start()   # blocks in the iterator, waiting for a second message
    dropped = _wait(lambda: ref() is None)
    put(end)
    t.join(10)
    return dropped, t.is_alive(), rest


def test_request_iterator_drops_each_message_before_waiting():
    from tpurpc_torch.rpc.server import _ServerStream

    st = _ServerStream(1)
    ctx = SimpleNamespace(is_active=lambda: True)
    got = _dropped_while_waiting(
        lambda: st.request_iterator(lambda b: b, ctx), st.requests.put,
        _ServerStream._END)
    assert got == (True, False, [])


def test_device_decode_drops_each_raw_body_before_waiting():
    import queue

    from tpurpc_torch.torchshim.service import _decoded

    q = queue.Queue()

    def raw_iter():   # a stand-in for the request iterator
        box = []
        while True:
            box.append(q.get())
            if box[0] is None:
                return
            yield box.pop()   # holds nothing while suspended

    got = _dropped_while_waiting(
        lambda: _decoded(lambda raw: float(raw.sum()), raw_iter()),
        q.put, None)
    assert got == (True, False, [])


def test_steady_tensor_calls_reuse_standing_regions(platform, monkeypatch):
    """Sequential 300 KiB tensor calls after a warm-up, with the cyclic
    garbage collector off: each request must land in a standing region
    freed by the previous call (its doorbell rang when the decoded tree
    died, not at a later collection), so no call solicits a claim. The
    Python plane's links are read, so the native plane is off."""
    platform("RDMA_BPEV")
    monkeypatch.setenv("TPURPC_NATIVE_FAST_UNARY", "0")
    srv = Server(max_workers=4, native_dataplane=False)
    add_tensor_method(srv, "Sum", lambda t: {"s": t["x"].double().sum()})
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    xs = [torch.full((75 << 10,), float(k)) for k in range(12)]   # 300 KiB
    sums = []
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            cli = TensorClient(ch)
            for x in xs[:2]:   # hello, the first claim, standing grants
                cli.call("Sum", {"x": x}, timeout=30)
            link = ch._conn.rdv
            before = link.stats()
            gc.disable()
            try:
                for x in xs[2:]:
                    sums.append(float(cli.call("Sum", {"x": x},
                                               timeout=30)["s"]))
            finally:
                gc.enable()
            after = link.stats()
    finally:
        srv.stop(grace=1)
    assert sums == [float(k) * (75 << 10) for k in range(2, 12)]
    # one COMPLETE per call, and no OFFER, so no call solicited a region;
    # the COMPLETE rides the descriptor ring (on by default, as in the
    # reference, whose rdv_ctrl_frames stays flat here): no control frame
    assert {k: after[k] - before[k]
            for k in ("sent", "ctrl_frames", "ctrl_posts")} \
        == {"sent": 10, "ctrl_frames": 0, "ctrl_posts": 10}
