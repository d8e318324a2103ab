"""Tests of the port that need a CUDA card; each skips where
``torch.cuda.is_available()`` is false. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax.) The CPU tests hold
the kernels' plain versions against the reference; here the CUDA kernels are
held against the plain versions, and the device ring (with a release
against a side stream's read), the fan-in batcher, device serialization,
4 MiB tensor streams over rendezvous (landed on the host, and through the
device ring) and over HTTP/2, the MoE transformer's forward, its serving
over HTTP/2 with a drain, and its train steps, the generation plane's step
model, a spawned shard worker's device ring, the call plane (retries
behind a seeded fault injector, a hedge's loser) on the device ring, and
mTLS onto the card ring (bit-equal to plaintext; refused clients leave the
ring alone), the device ring's obs hooks (exact landing counts, no device
synchronization), async handlers of the asyncio surface on the card ring
(bit-equal to the sync device path), a look-aside balancer moving a
channel between two card-ring servers, the transport's head (a gzip'd
request, a stream with its control ops on the descriptor ring, and a
``tcp_window`` pair feeding the card's ring), and the connection lifecycle
(a parked card-ring connection woken, a call redialed by max connection
age, ``ping`` on the card ring), the inline pump (a pump-mode call
bit-equal to a reader-mode one, a pipelined window, a rendezvous landing
whose sender pumped its own CLAIM), the pipelined drain migration
between two card-ring servers run on the card, and the scrape plane of a
card-ring server (``/metrics`` deltas of its landings, ``/debug/history``)
with a device-infer trip that writes and diagnoses a bundle, and the
generation plane's observability (``/debug/seq`` of a card scheduler, a
decode step held on the card tripping the watchdog at decode-step), and the
native plane (tensor unary calls and a duplex of an adopted ring server,
each request moved to the card in its handler).
"""

import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import (CLIENT_URI, AioRingServer, CallPlaneServer,
                        pipelined_drain, retry_arithmetic, tls_pki)
from tpurpc_torch.models.resnet import make_infer_fn, resnet18_thin
from tpurpc_torch.ops import ring_scatter as rs_mod
from tpurpc_torch.ops import ring_window as rw_mod
from tpurpc_torch.ops.ring_scatter import ring_scatter, ring_scatter_plain
from tpurpc_torch.ops.ring_window import ring_window, ring_window_plain
from tpurpc_torch.torchshim import codec
from tpurpc_torch.core.poller import PairPool, Poller
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.server import Server
from tpurpc_torch.torchshim.service import (FanInBatcher, ShardedFanIn,
                                            TensorClient, add_tensor_method)
from tpurpc_torch.tpu import ledger
from tpurpc_torch.tpu.hbm_ring import HbmRing
from tpurpc_torch.tpu.serialize import (deserialize_to_device,
                                        serialize_from_device)
from tpurpc_torch.utils import config

CAP = 16384
SPANS = [(0, 4096), (4 * 37, 4096), (CAP - 2048, 8192), (CAP - 400, 4096),
         (4 * 77, CAP), (CAP - 4096, 4096), (3, 1001), (CAP - 1, 2),
         (CAP - 1, 1), (CAP - 7, 13), (5, CAP), (CAP - 4093, 4099), (1, 0)]
#: every start residue mod 16, unwrapped (4099) and across the wrap (8192+5)
SKEWED = [(CAP - 6144 + r, n) for r in range(16) for n in (4099, 8192 + 5)]
#: a reply vs the same model run directly on the card at the same batch
#: shape: the same kernels on the same inputs, up to cuDNN's choice of
#: algorithm per call
REPLY_TOL = 1e-3
#: a 4 MiB message's float64 sum on the card vs numpy's: the same float32
#: terms in another order, within 1e-9 of the sum of their magnitudes
SUM_TOL = 1e-9
STREAM_SHAPE = (1024, 1024)    # bench.py's payload, 4 MiB
STREAM_MSGS = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("start,n", SPANS + SKEWED)
def test_kernels_match_plain_on_card(dev, start, n):
    g = torch.Generator(device=dev).manual_seed(start + n)
    ring = torch.randint(0, 256, (CAP,), dtype=torch.uint8, device=dev,
                         generator=g)
    payload = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                            generator=g)
    before = (rs_mod.launches, rw_mod.launches)
    a = ring_scatter(ring.clone(), payload, start)
    w = ring_window(ring, start, n)
    torch.cuda.synchronize()
    launched = 1 if n else 0
    assert (rs_mod.launches, rw_mod.launches) == (before[0] + launched,
                                                   before[1] + launched)
    assert torch.equal(a, ring_scatter_plain(ring.clone(), payload, start))
    assert torch.equal(w, ring_window_plain(ring, start, n))


@pytest.mark.cuda
def test_device_ring_on_card_aliases_and_gathers(dev):
    ring = HbmRing(CAP, device=dev)
    x = np.random.default_rng(0).standard_normal(1536).astype(np.float32)
    spans = [ring.place(x) for _ in range(2)]      # 6144 B each
    views = [ring.view(o, n, dtype=torch.float32, shape=(1536,))
             for o, n in spans]
    assert all(v.aliased for v in views)
    for v in views:
        v.release()
    before = (rs_mod.launches, rw_mod.launches)
    off, n = ring.place(x)                          # 12288 + 6144 > CAP
    lease = ring.view(off, n, dtype=torch.float32, shape=(1536,))
    assert (rs_mod.launches, rw_mod.launches) == (before[0] + 1, before[1] + 1)
    assert not lease.aliased and lease.array.device.type == "cuda"
    np.testing.assert_array_equal(lease.array.cpu().numpy(), x)
    lease.release()
    assert ring.stats()["writable"] == CAP
    assert ring.buf.data_ptr() == ring._base_ptr


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", [False, True], ids=["unwrapped", "wrapped"])
def test_released_span_waits_for_a_side_stream_read(dev, wrap):
    """A handler reads its view on a side stream, behind a long sleep, and
    releases the lease there; the next landing write, on the default
    stream, covers the span (a ring-sized payload: two segments, the
    ``ring_scatter`` kernel). The write must wait for the read: the read
    sees the old bytes. (For a wrapped span the view itself is the
    ``ring_window`` gather, on the side stream.) Both kernels are built
    first: a build inside the timed part blocks the host for longer than
    the sleep, which would hide the fault."""
    warm = HbmRing(64, device=dev)
    warm.view(*warm.place(np.zeros(48, np.uint8))).release()
    warm.view(*warm.place(np.zeros(32, np.uint8))).release()  # both kernels
    ring = HbmRing(CAP, device=dev)
    if wrap:    # move the tail so that the span lands across the wrap point
        pad = ring.place(np.zeros(CAP - 4096, np.uint8))
        ring.view(*pad).release()
    off, n = ring.place(np.full(8192, 1, np.uint8))
    assert ((off & (CAP - 1)) + n > CAP) == wrap
    torch.cuda.synchronize(dev)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)     # about 0.1 s of the card's clock
        lease = ring.view(off, n)
        seen = lease.array.clone()
        lease.release()
    ring.place(np.full(CAP, 2, np.uint8))
    torch.cuda.synchronize(dev)
    assert bool((seen == 1).all()), int((seen != 1).sum())
    assert bool((ring.buf == 2).all())


def _fan_in(batcher, xs):
    """Call ``batcher`` concurrently, one thread per tree; the replies."""
    import threading

    outs = [None] * len(xs)

    def call(i):
        outs[i] = batcher(xs[i])

    ts = [threading.Thread(target=call, args=(i,)) for i in range(len(xs))]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    assert not any(t.is_alive() for t in ts)
    return outs


@pytest.fixture
def exact_f32():
    """TF32 off: a reply and a direct run at another batch shape may take
    different cuDNN algorithms, which agree to REPLY_TOL only in float32."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = saved


def _small_model(dev):
    torch.manual_seed(0)
    return make_infer_fn(resnet18_thin(num_classes=10).to(dev))


def _check_replies(infer, xs, outs, bucket, dev):
    for x, out in zip(xs, outs):
        y = out["y"]
        assert y.device.type == "cpu" and y.shape == (1, 10)
        padded = torch.zeros((bucket, *x["x"].shape[1:]))
        padded[:1] = x["x"].cpu()
        want = infer(padded.to(dev))[:1].cpu()
        scale = max(1.0, want.abs().max().item())
        assert (y - want).abs().max().item() <= REPLY_TOL * scale


@pytest.mark.cuda
def test_batcher_on_card_one_h2d_per_batch(dev, exact_f32):
    """Host requests: one pinned staging H2D and one D2H per batch, and
    each reply equals a direct run at the batch's shape."""
    infer = _small_model(dev)
    b = FanInBatcher(lambda t: {"y": infer(t["x"])}, max_batch=4,
                     max_delay_s=0.05, fixed_bucket=True, device=dev)
    rng = np.random.default_rng(0)
    xs = [{"x": torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(
        np.float32))} for _ in range(8)]
    try:
        with ledger.track() as w:
            outs = _fan_in(b, xs)
    finally:
        b.close()
    assert b.rows_run == 8 and b.batches_run < 8
    assert w["dma_h2d_ops"] == b.batches_run
    assert w["dma_h2d"] == b.batches_run * 4 * 32 * 32 * 3 * 4
    assert w["dma_d2h_ops"] == b.batches_run
    assert all(o["y"].is_pinned() for o in outs)
    _check_replies(infer, xs, outs, 4, dev)


@pytest.mark.cuda
def test_batcher_on_card_device_inputs_and_bf16_transfer(dev, exact_f32):
    """Device-resident requests concatenate on the card (no H2D); host
    requests with transfer_dtype=bfloat16 ship half the bytes."""
    infer = _small_model(dev)
    rng = np.random.default_rng(1)
    host = [{"x": torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(
        np.float32))} for _ in range(4)]
    on_card = [{"x": t["x"].to(dev)} for t in host]
    b = FanInBatcher(lambda t: {"y": infer(t["x"].float())}, max_batch=4,
                     max_delay_s=0.05, device=dev)
    try:
        with ledger.track() as w:
            outs = _fan_in(b, on_card)
        assert w["dma_h2d_ops"] == 0
        _check_replies(infer, host, outs, 4, dev)
    finally:
        b.close()
    b = FanInBatcher(lambda t: {"y": t["x"]}, max_batch=4, max_delay_s=0.05,
                     fixed_bucket=True, transfer_dtype=torch.bfloat16,
                     device=dev)
    try:
        with ledger.track() as w:
            out = b(host[0])
    finally:
        b.close()
    assert w["dma_h2d"] == 4 * 32 * 32 * 3 * 2
    assert torch.equal(out["y"], host[0]["x"].to(torch.bfloat16))


@pytest.mark.cuda
def test_sharded_fanin_on_card(dev, exact_f32):
    infer = _small_model(dev)
    fan = ShardedFanIn(lambda t: {"y": infer(t["x"])}, n_shards=2,
                       max_batch=4, max_delay_s=0.01, fixed_bucket=True,
                       device=dev)
    rng = np.random.default_rng(2)
    xs = [{"x": torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(
        np.float32))} for _ in range(12)]
    try:
        outs = _fan_in(fan, xs)
    finally:
        fan.close()
    assert fan.rows_run == 12
    _check_replies(infer, xs, outs, 4, dev)


@pytest.mark.cuda
def test_serialize_from_device_one_d2h(dev):
    x = torch.randn(1024, 1024, device=dev)
    with ledger.track() as w:
        segs = serialize_from_device(x)
    assert w["dma_d2h_ops"] == 1 and w["dma_d2h"] == x.numel() * 4
    assert w["host_copy"] == 0
    buf = b"".join(bytes(memoryview(s).cast("B")) for s in segs)
    assert buf == codec.encode_tensor_bytes(x.cpu())
    with ledger.track() as w:
        y, end = deserialize_to_device(buf, device=dev)
    assert end == len(buf) and y.device == x.device
    assert w["dma_h2d_ops"] == 1 and torch.equal(y, x)


@pytest.fixture
def stream_env(dev, monkeypatch):
    """``stream_env(platform, **env)``: the port on ``platform`` on the
    card, its singletons reset afterwards."""
    def use(platform, **env):
        monkeypatch.setenv("GRPC_PLATFORM_TYPE", platform)
        monkeypatch.setenv("TPURPC_TORCH_DEVICE", str(dev))
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        config.set_config(None)
    yield use
    Poller.reset()
    PairPool.reset()
    config.set_config(None)


def _stream_sums(dev, device_ring, h2=False):
    """Stream STREAM_MSGS float32 [1024,1024] tensors (``base + i``, each
    beside its index) to a Sink that reduces each one on the card, over the
    native framing or (``h2``) an ``H2Channel``; returns the reply, the
    client link's counters (None without a link) and the messages."""
    from tpurpc_torch.wire.h2_client import H2Channel
    from tpurpc_torch.torchshim.codec import to_torch

    rng = np.random.default_rng(4)
    base = rng.standard_normal(STREAM_SHAPE).astype(np.float32)
    xs = [base + np.float32(i) for i in range(STREAM_MSGS)]

    def consume(trees):
        seen, sums = [], []
        for tree in trees:
            x = tree["x"] if device_ring else to_torch(tree["x"])
            assert x.device.type == "cuda"
            seen.append(tree["i"].clone())
            sums.append(x.double().sum())
        yield {"i": torch.cat(seen).cpu(), "sums": torch.stack(sums).cpu()}

    # the Python plane: the client link's counters are what it reads
    srv = Server(max_workers=8, native_dataplane=False)
    add_tensor_method(srv, "Sink", consume, kind="stream_stream",
                      device=device_ring)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")

    def gen(k):
        for i in range(k):
            yield {"i": torch.tensor([i]), "x": torch.from_numpy(xs[i])}

    try:
        with (H2Channel if h2 else Channel)(f"127.0.0.1:{port}") as ch:
            cli = TensorClient(ch)
            list(cli.duplex("Sink", gen(2), timeout=120,
                            native=False))   # warm-up
            link = ch.rdv if h2 else ch._conn.rdv
            s0 = link.stats() if link is not None else None
            reply = list(cli.duplex("Sink", gen(STREAM_MSGS), timeout=120,
                                    native=False))
            s1 = link.stats() if link is not None else None
    finally:
        srv.stop()
    counts = (None if link is None else
              {k: s1[k] - s0[k] for k in ("sent", "fallbacks")})
    return reply[-1], counts, xs


def _check_stream(reply, xs):
    assert reply["i"].tolist() == list(range(len(xs)))
    for got, x in zip(reply["sums"].tolist(), xs):
        x64 = x.astype(np.float64)
        assert abs(got - x64.sum()) <= SUM_TOL * np.abs(x64).sum()


@pytest.mark.cuda
def test_rendezvous_stream_onto_card(dev, stream_env):
    """8 x 4 MiB over rendezvous, each landed on the host and moved to the
    card by to_torch: every payload rides rendezvous, sums equal."""
    stream_env("RDMA_BPEV")
    reply, counts, xs = _stream_sums(dev, device_ring=False)
    assert counts == {"sent": STREAM_MSGS, "fallbacks": 0}
    _check_stream(reply, xs)


@pytest.mark.cuda
def test_rendezvous_stream_through_device_ring(dev, stream_env):
    """The same stream on the device-ring platform (a 16 MiB ring): the
    index leaf makes 4 MiB + 8 bytes a message, so the 4th message's span
    wraps the ring and takes both kernels."""
    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB=str(16 << 10))
    before = (rs_mod.launches, rw_mod.launches)
    reply, counts, xs = _stream_sums(dev, device_ring=True)
    assert counts == {"sent": STREAM_MSGS, "fallbacks": 0}
    assert rs_mod.launches > before[0] and rw_mod.launches > before[1]
    _check_stream(reply, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("rendezvous", ["1", "0"], ids=["rdv", "framed"])
def test_h2_stream_onto_card(dev, stream_env, rendezvous):
    """Phase 10 (b) at 8 messages: 4 MiB tensors in one stream_stream call
    over ``H2Channel``, each landed on the card by to_torch. With
    rendezvous negotiated through SETTINGS_TPURPC_RDV every payload is sent
    one-sided; without it they travel in DATA frames. Sums equal."""
    stream_env("TCP", TPURPC_RENDEZVOUS=rendezvous)
    reply, counts, xs = _stream_sums(dev, device_ring=False, h2=True)
    if rendezvous == "1":
        assert counts == {"sent": STREAM_MSGS, "fallbacks": 0}
    else:
        assert counts is None
    _check_stream(reply, xs)


# -- the MoE transformer (phase 6's model) ------------------------------------

#: card vs CPU, float32 with TF32 off, of max(1, max |logit|)
TF_TOL = 1e-4
#: bf16, per token position the max |diff| over the vocab, of max(1, max
#: |logit|): the median within 2^-7 and at most 2 positions above 2^-6 (a
#: token whose router margin lies inside a bf16 rounding may take the other
#: expert on one side), as tests/test_torch_transformer.py holds the port's
#: bf16 forward against the reference's
TF_BF16_MEDIAN, TF_BF16_POS, TF_BF16_FLIPS = 2 ** -7, 2 ** -6, 2


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _transformers(dev, dtype):
    from tpurpc_torch.models.transformer import Transformer, TransformerConfig
    from tpurpc_torch.parallel import build_mesh

    cfg = TransformerConfig(n_layers=2, dtype=dtype)
    return [Transformer(cfg, build_mesh(1, device=d),
                        generator=torch.Generator().manual_seed(0)).eval()
            for d in (dev, "cpu")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_transformer_on_card_matches_cpu(dev, no_tf32, dtype):
    card, cpu = _transformers(dev, dtype)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 64)).astype(np.int32))
    with torch.inference_mode():
        got = card(tokens.to(dev)).cpu()
        want = cpu(tokens)
    assert got.shape == (4, 64, 256) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, want.abs().max().item())
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= TF_TOL * scale
    else:
        d = ((got - want).abs().amax(dim=-1) / scale).flatten()
        assert d.median().item() <= TF_BF16_MEDIAN
        assert int((d > TF_BF16_POS).sum()) <= TF_BF16_FLIPS


@pytest.mark.cuda
def test_transformer_out_of_range_token_keeps_the_context(dev, no_tf32):
    """Token 300 (at or above vocab) and −1 reach the gather: NaN rows and
    a wrapped row as on the CPU (and in the reference), no device-side
    assert, and the next forward on the card is still right."""
    card, cpu = _transformers(dev, torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 32)).astype(np.int32))
    bad = tokens.clone()
    bad[0, 3], bad[3, 5] = 300, -1
    with torch.inference_mode():
        got, want = card(bad.to(dev)).cpu(), cpu(bad)
        torch.cuda.synchronize(dev)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert bool(torch.isnan(want[:2]).all())        # microbatch 0
        fin = ~torch.isnan(want)
        assert bool(fin[2:].all())                      # -1 wraps
        scale = max(1.0, want[fin].abs().max().item())
        assert (got[fin] - want[fin]).abs().max().item() <= TF_TOL * scale
        again, ok = card(tokens.to(dev)).cpu(), cpu(tokens)
    assert (again - ok).abs().max().item() <= TF_TOL * max(
        1.0, ok.abs().max().item())


#: training, card vs CPU from the same weights, float32 with TF32 off. The
#: gradient of one backward: within TRAIN_GRAD_TOL of each parameter's
#: largest |gradient| (on the CPU the port's 8-rank gradients read 1.1e-6
#: of it against the reference's). Two AdamW steps: the losses within
#: TRAIN_LOSS_TOL (chip_smoke.py phase 7 read 0 and 8.9e-8); the parameters
#: after them with a median |diff| within TRAIN_MEDIAN, and none above
#: 2 x lr a step: Adam divides each gradient entry by its RMS, so an entry
#: whose gradient is near 0 and rounds to the other sign on one device
#: moves by up to lr one way there and lr the other here
TRAIN_GRAD_TOL, TRAIN_LOSS_TOL, TRAIN_LR, TRAIN_MEDIAN = 1e-5, 1e-6, 3e-3, 1e-6


@pytest.mark.cuda
def test_h2_transformer_serving_bit_equal_and_drain(dev, no_tf32,
                                                    stream_env):
    """Phase 10 (a) and (c) at a small size: a 2-layer transformer on the
    card behind serve_torch's batcher, padded to the [8,64] bucket; 4
    closed-loop ``H2Channel`` clients and a native pipeline on one port,
    every reply bit-equal to the direct run of its tokens; then ``drain()``
    while the h2 clients call on: the taken calls finish bit-equal, the
    rest are refused before the server takes them, none fails."""
    import threading

    from tpurpc_torch.models.transformer import make_serve_fn
    from tpurpc_torch.rpc.status import RpcError, StatusCode
    from tpurpc_torch.torchshim.service import serve_torch
    from tpurpc_torch.wire.h2_client import H2Channel

    stream_env("TCP")
    model, _ = _transformers(dev, torch.float32)
    serve = make_serve_fn(model)

    def fn(tree):
        tokens = torch.as_tensor(tree["tokens"])
        padded = tokens.new_zeros((8, tokens.shape[1]))
        padded[:tokens.shape[0]] = tokens
        return {"logits": serve({"tokens": padded})["logits"][
            :tokens.shape[0]]}

    rows = [torch.from_numpy(r) for r in np.random.default_rng(10).integers(
        0, 256, (20, 1, 64)).astype(np.int32)]
    want = [fn({"tokens": r.to(dev)})["logits"].cpu() for r in rows]
    srv, port, batcher = serve_torch(fn, name="Generate", batching=True,
                                     max_batch=8, max_delay_s=0.005)
    got, errors, refused = {}, [], []
    # the drain starts once every client has made 4 calls, so each of the
    # 16 rows has been answered before any call can be refused
    go = threading.Event()
    ready, ready_lock = [0], threading.Lock()

    def h2_client(c):
        try:
            with H2Channel(f"127.0.0.1:{port}") as ch:
                cli = TensorClient(ch)
                for k in range(1000):
                    i = (c + 4 * k) % 16
                    if k == 4:
                        with ready_lock:
                            ready[0] += 1
                            if ready[0] == 4:
                                go.set()
                    try:
                        out = cli.call("Generate", {"tokens": rows[i]},
                                       timeout=120)
                    except RpcError as exc:
                        assert exc.code() is StatusCode.UNAVAILABLE
                        assert "GOAWAY" in exc.details() or \
                            "h2 error 7" in exc.details(), exc.details()
                        refused.append(c)
                        return
                    got.setdefault(i, []).append(out["logits"])
        except Exception as exc:
            errors.append(repr(exc))

    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            pl = TensorClient(ch, depth=4).pipeline("Generate")
            futs = [pl.call_async({"tokens": r}, timeout=120)
                    for r in rows[16:]]
            ts = [threading.Thread(target=h2_client, args=(c,))
                  for c in range(4)]
            for t in ts:
                t.start()
            for j, f in enumerate(futs):
                got.setdefault(16 + j, []).append(f.result(timeout=120)[
                    "logits"])
        assert go.wait(120)
        assert srv.drain(linger=30)
        for t in ts:
            t.join(120)
    finally:
        srv.stop()
        batcher.close()
    assert not errors, errors
    assert sorted(refused) == [0, 1, 2, 3]
    assert sorted(got) == list(range(20))
    for i, outs in got.items():
        for o in outs:
            assert torch.equal(o, want[i]), i


@pytest.mark.cuda
def test_train_steps_on_card_match_cpu(dev, no_tf32):
    """``value_and_grad`` once, then two AdamW steps of
    ``build_train_step``, on the card and on the CPU from the same weights
    (2 layers, [4,64] tokens, next-token targets)."""
    from tpurpc_torch.models import transformer as tfm

    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 64)).astype(np.int32))
    targets = torch.roll(tokens, -1, dims=1)
    runs = []
    for model in _transformers(dev, torch.float32):
        d = model.mesh.device
        tok, tgt = tokens.to(d), targets.to(d)
        tfm.value_and_grad(tfm.build_loss_fn(model.cfg, model.mesh), model,
                           tok, tgt)
        grads = {k: v.grad.cpu() for k, v in model.named_parameters()}
        step, make_optimizer = tfm.build_train_step(model.cfg, model.mesh,
                                                    lr=TRAIN_LR)
        opt = make_optimizer(model)
        losses = [float(step(model, opt, tok, tgt)) for _ in range(2)]
        runs.append((grads, losses, {k: v.detach().cpu() for k, v in
                                     model.named_parameters()}))
    (card_g, card, card_p), (cpu_g, cpu, cpu_p) = runs
    for k, want in cpu_g.items():
        err = (card_g[k] - want).abs().max() / want.abs().max()
        assert err.item() <= TRAIN_GRAD_TOL, (k, err.item())
    for a, b in zip(card, cpu):
        assert abs(a - b) <= TRAIN_LOSS_TOL * abs(b), (card, cpu)
    assert card[1] < card[0]
    for k, want in cpu_p.items():
        d = (card_p[k] - want).abs()
        assert d.max().item() <= 2 * TRAIN_LR * 2, (k, d.max().item())
        assert d.median().item() <= TRAIN_MEDIAN, (k, d.median().item())


def _gen_prompts(n=64):
    rng = np.random.default_rng(8)
    return [rng.integers(0, 251, int(rng.integers(1, 65))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.cuda
def test_step_model_on_card_matches_reference_decode(dev):
    """``ToyDecodeModel`` on the card, 64 seeded prompts, both contracts:
    its int64 state stays on the card and every token equals
    ``reference_decode`` (which proves int64 ``*`` and ``+`` wrap there as
    on the CPU); a poisoned row fails the batch and a clean row alone
    passes."""
    from tpurpc_torch.serving.kv import HostKv
    from tpurpc_torch.torchshim.generate import (ToyDecodeModel,
                                                 reference_decode)

    prompts = _gen_prompts()
    want = [reference_decode(p, 16) for p in prompts]
    m = ToyDecodeModel(device=dev)
    states, toks = m.prefill(prompts)
    assert states.device == dev and states.dtype == torch.int64
    got = [[int(t)] for t in toks]
    for _ in range(15):
        states, toks = m.step(states, toks)
        assert states.device == dev
        for row, t in zip(got, toks):
            row.append(int(t))
    assert got == want
    cpu = ToyDecodeModel(device="cpu")
    kvs, kc = [HostKv() for _ in prompts], [HostKv() for _ in prompts]
    paged = [[int(t)] for t in m.prefill_paged(prompts, kvs)]
    cpu.prefill_paged(prompts, kc)
    for _ in range(15):
        toks = m.step_paged(kvs, np.asarray([r[-1] for r in paged]))
        cpu.step_paged(kc, toks)
        for row, t in zip(paged, toks):
            row.append(int(t))
    assert paged == want
    assert all(bytes(a.payload()) == bytes(b.payload())
               for a, b in zip(kvs, kc))
    bad = ToyDecodeModel(device=dev, poison_token=666)
    s, t = bad.prefill([np.asarray([1, 666], np.int32), prompts[0]])
    with pytest.raises(ValueError, match="poisoned row"):
        bad.step(s, t)
    _s1, t1 = bad.step(s[1:], t[1:])
    assert int(t1[0]) == want[0][1]
    pk = [HostKv(), HostKv()]
    bad.prefill_paged([np.asarray([1, 666], np.int32), prompts[0]], pk)
    with pytest.raises(ValueError, match="poisoned row"):
        bad.step_paged(pk, np.zeros(2, np.int32))
    assert int(bad.step_paged(pk[1:], np.zeros(1, np.int32))[0]) == \
        want[0][1]


@pytest.mark.cuda
def test_spawned_worker_device_ring_launches_both_kernels(dev, stream_env):
    """One spawned shard worker on the device-ring platform (a 64 KiB ring
    on the card): a connection's 3rd and 6th float32 [2,32,32,3] requests
    wrap the ring, so the worker, in its own CUDA context, launches both
    kernels; every reply equals 2x + 1 computed here."""
    import json
    import os

    import torch_shard_builds as builds
    from tpurpc_torch.rpc.shard import ShardedServer

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    sup = ShardedServer(builds.ring, workers=1, listener="handoff")
    sup.start(ready_timeout=180)
    rng = np.random.default_rng(5)
    try:
        with Channel(f"127.0.0.1:{sup.port}") as ch:
            cli = TensorClient(ch)
            for _ in range(6):
                x = torch.from_numpy(rng.standard_normal(
                    (2, 32, 32, 3)).astype(np.float32))
                y = cli.call("Call", {"x": x}, timeout=60)["y"]
                assert torch.equal(y.cpu(), x * 2.0 + 1.0)
            st = json.loads(bytes(ch.unary_unary(builds.STATS)(
                b"", timeout=60)))
    finally:
        sup.stop()
    assert st["pid"] == sup.worker_pid(0) != os.getpid()
    assert st["device"] == torch.cuda.get_device_name(0)
    assert st["launches"]["ring_scatter"] >= 2, st
    assert st["launches"]["ring_window"] >= 2, st
    assert st["plain"] == {"ring_scatter": 0, "ring_window": 0}


#: the call plane's seeded aborts: a FaultInjector of this seed aborting
#: this fraction, under this retry policy and throttle
CP_SEED, CP_ABORT = 0, 0.3
CP_RETRY = {"maxAttempts": 5, "initialBackoff": "0.01s",
            "maxBackoff": "0.1s", "backoffMultiplier": 2,
            "retryableStatusCodes": ["UNAVAILABLE"]}
CP_THROTTLE = {"maxTokens": 10, "tokenRatio": 0.5}


@pytest.mark.cuda
def test_call_plane_retries_on_the_card_ring(dev, stream_env, exact_f32):
    """Phase 11 (a) at a small model: a device-mode method on the card's
    ring (64 KiB; the 3rd and 6th float32 [2,32,32,3] requests wrap it)
    behind a seeded FaultInjector, the retry policy and throttle from a
    registered resolver's service config. Every call succeeds and equals a
    direct run; the attempts and tokens are the seeded sequence's; the
    kernels launch as without faults (an aborted attempt lands nothing) and
    the ring comes back whole."""
    import random

    from tpurpc_torch.rpc.interceptors import FaultConfig, FaultInjector
    from tpurpc_torch.rpc.resolver import _RESOLVERS, register_resolver
    from tpurpc_torch.rpc.status import StatusCode

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)
    fi = FaultInjector({"*": FaultConfig(abort_code=StatusCode.UNAVAILABLE,
                                         abort_fraction=CP_ABORT)},
                       rng=random.Random(CP_SEED))
    rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, [fi],
                          max_workers=4)
    cfg = {"methodConfig": [{"name": [{"service": "tpurpc.Tensor"}],
                             "retryPolicy": CP_RETRY}],
           "retryThrottling": CP_THROTTLE}
    register_resolver("cardretry",
                      lambda rest: ([("127.0.0.1", rig.port)], cfg))
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32)) for _ in range(6)]
    attempts, aborts, tokens = retry_arithmetic(
        CP_SEED, len(xs), CP_ABORT, CP_RETRY["maxAttempts"], CP_THROTTLE)
    assert aborts > 0
    try:
        with Channel("cardretry:///x") as ch:
            before = (rs_mod.launches, rw_mod.launches)
            outs = [TensorClient(ch).call("Classify", {"x": x}, timeout=60)
                    for x in xs]
            launched = (rs_mod.launches - before[0],
                        rw_mod.launches - before[1])
            left = ch._service_config.retry_throttle.tokens()
            stats = rig.ring().stats()
    finally:
        _RESOLVERS.pop("cardretry", None)
        rig.server.stop()
    for x, out in zip(xs, outs):
        want = infer(x.to(dev)).cpu()
        scale = max(1.0, want.abs().max().item())
        assert (out["y"] - want).abs().max().item() <= REPLY_TOL * scale
    assert (len(rig.seen), left) == (attempts, tokens)
    assert launched == ((2, 2) if dev.type == "cuda" else (0, 0))
    assert launched == (rig.launched["ring_scatter"],
                        rig.launched["ring_window"])
    assert stats["tail"] == len(xs) * xs[0].numel() * 4
    assert stats["writable"] == stats["capacity"] and not stats["live_spans"]


@pytest.mark.cuda
def test_call_plane_hedge_loser_releases_the_card_ring(dev, stream_env,
                                                       exact_f32):
    """Phase 11 (b) at a small model: two device-ring servers on the card,
    the first delayed 1.0 s; the hedge (50 ms) wins on the second well
    before that, and once the delayed handler has landed its request, run
    the model and replied into the cancelled stream, its ring is back to
    capacity."""
    import threading
    import time

    from tpurpc_torch.rpc.channel import HedgingPolicy
    from tpurpc_torch.rpc.interceptors import FaultConfig, FaultInjector

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)
    done = threading.Event()

    def slow_fn(t):
        out = {"y": infer(t["x"])}
        done.set()
        return out

    slow = CallPlaneServer(slow_fn, [FaultInjector({"*": FaultConfig(
        delay_s=1.0, delay_fraction=1.0)})], max_workers=4)
    fast = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    try:
        with Channel(f"ipv4:127.0.0.1:{slow.port},127.0.0.1:{fast.port}",
                     hedging_policy=HedgingPolicy(2, 0.05)) as ch:
            for sc in ch._subchannels:  # both dialed before the hedge
                sc.get()
            t0 = time.monotonic()
            out = TensorClient(ch).call("Classify", {"x": x}, timeout=60)
            took = time.monotonic() - t0
            assert done.wait(30)
            ring = slow.ring()
            deadline = time.monotonic() + 30
            while (ring.stats()["live_spans"]
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            stats = ring.stats()
    finally:
        slow.server.stop()
        fast.server.stop()
    want = infer(x.to(dev)).cpu()
    assert (out["y"] - want).abs().max().item() <= REPLY_TOL * max(
        1.0, want.abs().max().item())
    assert took < 1.0 and (len(slow.seen), len(fast.seen)) == (1, 1)
    assert stats["tail"] == x.numel() * 4          # the loser landed it
    assert stats["writable"] == stats["capacity"] and not stats["live_spans"]


def _tls_rig(infer, pki):
    from tpurpc_torch.rpc import ssl_server_credentials

    return CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4,
                           credentials=ssl_server_credentials(
                               [(pki["srv_key"], pki["srv_cert"])],
                               root_certificates=pki["ca"],
                               require_client_auth=True))


def _mutual(pki):
    from tpurpc_torch.rpc import ssl_channel_credentials

    return ssl_channel_credentials(root_certificates=pki["ca"],
                                   private_key=pki["cli_key"],
                                   certificate_chain=pki["cli_cert"])


@pytest.mark.cuda
def test_mtls_call_on_the_card_ring_bit_equal(dev, stream_env, exact_f32):
    """Phase 12 (a) at a small model: the same 6 float32 [2,32,32,3]
    requests into a 64 KiB card ring (the 3rd and 6th wrap it) through a
    plaintext port and through an mTLS port: replies bit-equal, both
    kernels launched twice on each (measured at the server), each ring
    back to capacity, and the handlers' contexts hold the client's SAN."""
    from tpurpc_torch.rpc import insecure_channel, secure_channel

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)
    pki = tls_pki()
    rng = np.random.default_rng(9)
    xs = [torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32)) for _ in range(6)]
    runs = []
    for secure in (False, True):
        rig = (_tls_rig(infer, pki) if secure else CallPlaneServer(
            lambda t: {"y": infer(t["x"])}, max_workers=4))
        try:
            with (secure_channel(f"localhost:{rig.port}", _mutual(pki))
                  if secure
                  else insecure_channel(f"127.0.0.1:{rig.port}")) as ch:
                before = (rs_mod.launches, rw_mod.launches)
                outs = [TensorClient(ch).call("Classify", {"x": x},
                                              timeout=60) for x in xs]
                launched = (rs_mod.launches - before[0],
                            rw_mod.launches - before[1])
                stats = rig.ring().stats()
        finally:
            rig.server.stop()
        runs.append((outs, launched, dict(rig.launched), stats, rig.auth))
    (plain, p_l, p_m, p_st, p_auth), (tls, t_l, t_m, t_st, t_auth) = runs
    for p, t in zip(plain, tls):
        assert torch.equal(p["y"], t["y"])
    assert p_l == t_l == (2, 2)
    assert p_m == t_m == {"ring_scatter": 2, "ring_window": 2}
    for st in (p_st, t_st):
        assert st["writable"] == st["capacity"] and not st["live_spans"]
    assert p_auth == [{}] * 6
    assert all(a["x509_subject_alternative_name"] == [CLIENT_URI]
               and a["transport_security_type"] == [b"ssl"] for a in t_auth)


@pytest.mark.cuda
def test_refused_plaintext_client_leaves_the_card_ring(dev, stream_env,
                                                       exact_f32):
    """Phase 12 (c) at a small model: after one mTLS call onto the card
    ring, a plaintext client and a certless TLS client are refused at the
    handshake; neither kernel launches and the ring stays at capacity."""
    from tpurpc_torch.rpc import (RpcError, insecure_channel, secure_channel,
                                  ssl_channel_credentials)

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)
    pki = tls_pki()
    rig = _tls_rig(infer, pki)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    try:
        with secure_channel(f"localhost:{rig.port}", _mutual(pki)) as ch:
            out = TensorClient(ch).call("Classify", {"x": x}, timeout=60)
            ring = rig.ring()
            before = ((rs_mod.launches, rw_mod.launches), ring.stats())
            codes = []
            for bad in (insecure_channel(f"127.0.0.1:{rig.port}"),
                        secure_channel(f"localhost:{rig.port}",
                                       ssl_channel_credentials(
                                           root_certificates=pki["ca"]))):
                with bad:
                    with pytest.raises(RpcError) as ei:
                        TensorClient(bad).call("Classify", {"x": x},
                                               timeout=10)
                    codes.append(ei.value.code().name)
            after = ((rs_mod.launches, rw_mod.launches), ring.stats())
            conns = len(rig.server._connections)
    finally:
        rig.server.stop()
    want = infer(x.to(dev)).cpu()
    assert (out["y"] - want).abs().max().item() <= REPLY_TOL * max(
        1.0, want.abs().max().item())
    assert codes == ["UNAVAILABLE", "UNAVAILABLE"]
    assert after == before and conns == 1
    assert after[1]["writable"] == after[1]["capacity"]
    assert not after[1]["live_spans"]


@pytest.mark.cuda
def test_aio_calls_on_the_card_ring_bit_equal_to_sync(dev, stream_env,
                                                      exact_f32):
    """Phase 13 (a) at a small model: the same 3 float32 [2,32,32,3]
    requests into a 64 KiB card ring (the 3rd wraps it) through the sync
    device path and, all at once, through ``AioRingServer`` over an
    ``aio`` channel: replies bit-equal, both kernels launched once on
    each (measured at the server), the ring back to capacity."""
    import asyncio

    from tpurpc_torch.rpc import aio, insecure_channel
    from tpurpc_torch.torchshim.service import TENSOR_SERVICE

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)

    def fn(t):
        return {"y": infer(t["x"])}

    rng = np.random.default_rng(11)
    xs = [torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32)) for _ in range(3)]
    sync = CallPlaneServer(fn, max_workers=4)
    try:
        with insecure_channel(f"127.0.0.1:{sync.port}") as ch:
            want = [TensorClient(ch).call("Classify", {"x": x}, timeout=60)
                    for x in xs]
    finally:
        sync.server.stop()
    rig = AioRingServer(fn, max_workers=4)

    async def main():
        await rig.server.start()
        try:
            async with aio.insecure_channel(f"127.0.0.1:{rig.port}") as ch:
                call = ch.unary_unary(f"/{TENSOR_SERVICE}/Classify",
                                      codec.tree_serializer,
                                      codec.tree_deserializer)
                before = (rs_mod.launches, rw_mod.launches)
                outs = await asyncio.gather(
                    *[call({"x": x}, timeout=60) for x in xs])
                launched = (rs_mod.launches - before[0],
                            rw_mod.launches - before[1])
                return outs, launched, rig.ring().stats()
        finally:
            await rig.stop()

    outs, launched, stats = asyncio.run(main())
    for w, o in zip(want, outs):
        assert torch.equal(w["y"], o["y"])
    assert sync.launched == rig.launched == {"ring_scatter": 1,
                                             "ring_window": 1}
    assert launched == (1, 1)
    assert stats["writable"] == stats["capacity"] and not stats["live_spans"]


@pytest.mark.cuda
def test_balancer_moves_a_channel_between_card_rings(dev, stream_env,
                                                     exact_f32):
    """Phase 14 (a) at a small model: two device-mode servers on the card's
    rings (64 KiB; from offset 0 the 3rd and 6th float32 [2,32,32,3]
    requests wrap one), a port balancer on the grpclb wire naming the
    first, then the second, and a channel over both moved by
    ``enable_lookaside``. Every reply is bit-equal to the same request
    served directly by the server that ran it, each server launches both
    kernels twice for its 6 landings (measured at the server), and every
    ring comes back whole."""
    import time

    from tpurpc_torch.rpc import LoadBalancerServicer, enable_lookaside

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)
    rigs = [CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4)
            for _ in range(2)]
    addr = [("127.0.0.1", r.port) for r in rigs]
    rng = np.random.default_rng(14)
    xs = [torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32)) for _ in range(6)]
    bal = Server(max_workers=4)
    balancer = LoadBalancerServicer()
    balancer.attach(bal)
    bal_port = bal.add_insecure_port("127.0.0.1:0")
    bal.start()

    def calls(ch, k):
        done = len(rigs[k].done)
        outs = [TensorClient(ch).call("Classify", {"x": x}, timeout=60)
                for x in xs]
        assert len(rigs[k].done) - done == len(xs)   # all ran on server k
        return outs

    def moved(ch, want):
        deadline = time.monotonic() + 30
        while ch._addrs != want and time.monotonic() < deadline:
            time.sleep(0.001)
        return ch._addrs == want

    try:
        direct = []
        for k, rig in enumerate(rigs):
            with Channel(f"127.0.0.1:{rig.port}") as ch:
                direct.append(calls(ch, k))
        for rig in rigs:
            rig.launched.update(ring_scatter=0, ring_window=0)
        balancer.set_servers("card", [f"127.0.0.1:{rigs[0].port}"])
        stats = []
        with Channel("ipv4:" + ",".join(f"{h}:{p}" for h, p in addr),
                     lb_policy="round_robin") as ch:
            watcher = enable_lookaside(ch, f"127.0.0.1:{bal_port}", "card",
                                       wire="grpclb")
            try:
                assert moved(ch, [addr[0]])
                on_a = calls(ch, 0)
                stats.append([c.endpoint.device_ring.stats()
                              for c in list(rigs[0].server._connections)])
                balancer.set_servers("card", [f"127.0.0.1:{rigs[1].port}"])
                assert moved(ch, [addr[1]])
                on_b = calls(ch, 1)
                stats.append([c.endpoint.device_ring.stats()
                              for c in list(rigs[1].server._connections)])
            finally:
                watcher.stop()
    finally:
        bal.stop(grace=0)
        for rig in rigs:
            rig.server.stop()
    for got, want in ((on_a, direct[0]), (on_b, direct[1])):
        for g, w in zip(got, want):
            assert torch.equal(g["y"], w["y"])
    assert [r.launched for r in rigs] == [{"ring_scatter": 2,
                                           "ring_window": 2}] * 2
    for rings in stats:
        assert rings
        for st in rings:
            assert st["writable"] == st["capacity"] and not st["live_spans"]


# -- the transport's head (phase 15) ------------------------------------------

@pytest.mark.cuda
def test_compressed_round_trip_onto_the_card_ring(dev, stream_env,
                                                 exact_f32):
    """Phase 15 (b) at a small model: float32 [2,32,32,3] requests, each
    with an int64 index leaf of the same byte size, into the card's ring
    (64 KiB) with ``compression="gzip"`` and without: gunzipped at
    reassembly, then placed as an uncompressed request is. Replies
    bit-equal, the same launches (measured at the server), the ring whole;
    a request inflating past the receive limit fails RESOURCE_EXHAUSTED
    and launches nothing."""
    from tpurpc_torch.rpc.status import RpcError, StatusCode

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)
    rng = np.random.default_rng(9)
    reqs = []
    for _ in range(6):
        x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
            np.float32))
        reqs.append({"x": x, "index": torch.arange(x.numel() // 2)})
    runs = {}
    for way in (None, "gzip"):
        rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4)
        try:
            with Channel(f"127.0.0.1:{rig.port}", compression=way) as ch:
                outs = [TensorClient(ch).call("Classify", r, timeout=60)
                        for r in reqs]
                stats = rig.ring().stats()
        finally:
            rig.server.stop()
        runs[way] = (outs, dict(rig.launched), stats)
    (plain, l_plain, s_plain), (gz, l_gz, s_gz) = runs[None], runs["gzip"]
    for a, b in zip(plain, gz):
        assert torch.equal(a["y"], b["y"])
    assert l_gz == l_plain and min(l_plain.values()) >= 1
    for st in (s_plain, s_gz):
        assert st["writable"] == st["capacity"] and not st["live_spans"]
    rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=2,
                          max_receive_message_length=1 << 20)
    before = (rs_mod.launches, rw_mod.launches)
    try:
        with Channel(f"127.0.0.1:{rig.port}", compression="gzip") as ch:
            with pytest.raises(RpcError) as ei:
                TensorClient(ch).call("Classify",
                                      {"x": torch.zeros(4 << 20)},
                                      timeout=60)
    finally:
        rig.server.stop()
    assert ei.value.code() is StatusCode.RESOURCE_EXHAUSTED
    assert (rs_mod.launches, rw_mod.launches) == before


def _ring_links(ch, srv):
    """The client's and the server's rendezvous link counters, summed."""
    links = [ch._conn.rdv] + [c.rdv for c in list(srv._connections)]
    return {k: sum(link.stats()[k] for link in links)
            for k in ("sent", "fallbacks", "ctrl_frames", "ctrl_posts")}


def _card_sink_stream(dev, msgs=STREAM_MSGS):
    """STREAM_MSGS 4 MiB tensors through the device ring to a Sink that
    reduces each on the card; the reply, the links' counters over the
    timed stream (after a warm-up), the client's pair and the messages."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal(STREAM_SHAPE).astype(np.float32)
    xs = [base + np.float32(i) for i in range(msgs)]

    def consume(trees):
        seen, sums = [], []
        for tree in trees:
            x = tree["x"]
            assert x.device.type == "cuda"
            seen.append(tree["i"].clone())
            sums.append(x.double().sum())
        yield {"i": torch.cat(seen).cpu(), "sums": torch.stack(sums).cpu()}

    srv = Server(max_workers=8)
    add_tensor_method(srv, "Sink", consume, kind="stream_stream",
                      device=True)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")

    def gen(k):
        for i in range(k):
            yield {"i": torch.tensor([i]), "x": torch.from_numpy(xs[i])}

    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            cli = TensorClient(ch)
            list(cli.duplex("Sink", gen(2), timeout=120))   # warm-up
            c0 = _ring_links(ch, srv)
            reply = list(cli.duplex("Sink", gen(msgs), timeout=120))
            c1 = _ring_links(ch, srv)
            pair = ch._conn.endpoint.pair
            armed = ch._conn.ctrl is not None and ch._conn.ctrl.armed
    finally:
        srv.stop()
    return reply[-1], {k: c1[k] - c0[k] for k in c0}, pair, armed, xs


@pytest.mark.cuda
def test_ring_control_stream_onto_the_card_ring(dev, stream_env):
    """Phase 15 (a) at 8 messages: 4 MiB tensors over rendezvous into the
    card's 16 MiB ring with the descriptor ring on (the default): every
    payload by rendezvous, no control op framed by either side in the
    steady stream, sums equal, both kernels launched."""
    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB=str(16 << 10))
    before = (rs_mod.launches, rw_mod.launches)
    reply, counts, _, armed, xs = _card_sink_stream(dev)
    assert armed
    assert counts["sent"] == STREAM_MSGS and counts["fallbacks"] == 0
    assert counts["ctrl_frames"] == 0 and counts["ctrl_posts"] >= STREAM_MSGS
    assert rs_mod.launches > before[0] and rw_mod.launches > before[1]
    _check_stream(reply, xs)


@pytest.mark.cuda
def test_tcp_window_pair_feeds_the_card_ring(dev, stream_env):
    """Phase 15 (c) in one process: the same stream with the connection's
    pair on ``tcp_window`` (every one-sided write a record over a socket);
    each payload lands one-sided in a tcp_window region, then in the card's
    ring. Sums equal, both kernels launched, each COMPLETE framed (the
    record stream orders it after the bytes)."""
    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB=str(16 << 10),
               TPURPC_RING_DOMAIN="tcp_window", TPURPC_TCPW_BIND="127.0.0.1",
               TPURPC_RING_BUFFER_SIZE_KB="1024")
    before = (rs_mod.launches, rw_mod.launches)
    reply, counts, pair, _, xs = _card_sink_stream(dev)
    assert pair.domain.kind == "tcp_window"
    assert counts["sent"] == STREAM_MSGS and counts["fallbacks"] == 0
    assert counts["ctrl_frames"] >= STREAM_MSGS
    assert rs_mod.launches > before[0] and rw_mod.launches > before[1]
    _check_stream(reply, xs)


def _parked_ends(srv, ch, timeout=30.0):
    import time

    ends = (ch._conn.endpoint.pair, srv._connections[0].endpoint.pair)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        # a pair's flag goes up a moment before the parked set takes it
        if all(p._parked for p in ends) and Poller.get().parked_count() >= 2:
            return ends
        time.sleep(0.01)
    raise AssertionError(f"ends not parked: {[p._parked for p in ends]}")


@pytest.mark.cuda
def test_parked_card_ring_connection_wakes_bit_equal(dev, stream_env,
                                                     exact_f32):
    """Phase 16 (a) at a small model: a device-ring connection idles until
    both ends park (host rings to the pool), then the next call wakes it:
    the card's ring keeps its storage and tail (the request lands where the
    last one ended), and the reply is bit-equal to the first."""
    from tpurpc_torch.core.pair import RingPool

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64", TPURPC_PAIR_PARK_S="0.2")
    infer = _small_model(dev)
    rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            first = TensorClient(ch).call("Classify", {"x": x}, timeout=60)
            ring = rig.ring()
            ptr, tail = ring.buf.data_ptr(), ring.stats()["tail"]
            ends = _parked_ends(rig.server, ch)
            assert Poller.get().parked_count() >= 2
            again = TensorClient(ch).call("Classify", {"x": x}, timeout=60)
            assert not any(p._parked for p in ends)
            assert ring.buf.data_ptr() == ptr
            assert ring.stats()["tail"] == tail + x.numpy().nbytes
            assert torch.equal(first["y"], again["y"])
    finally:
        rig.server.stop()
        RingPool.reset()


@pytest.mark.cuda
def test_max_age_redial_lands_on_a_fresh_card_ring(dev, stream_env,
                                                   exact_f32):
    """Phase 16 (c) at a small model: with a 300 ms max connection age the
    server GOAWAYs the connection; the next call redials transparently,
    lands at offset 0 of the new connection's card ring and replies
    bit-equal to the first."""
    import time

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64",
               TPURPC_MAX_CONNECTION_AGE_MS="300")
    infer = _small_model(dev)
    rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            conn1 = ch._subchannels[0].get()
            first = TensorClient(ch).call("Classify", {"x": x}, timeout=60)
            deadline = time.monotonic() + 10
            while ((conn1.alive and not conn1.draining)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            before = (rs_mod.launches, rw_mod.launches)
            again = TensorClient(ch).call("Classify", {"x": x}, timeout=60)
            assert ch._conn is not conn1
            assert rig.server._connections[-1].endpoint.device_ring.stats()[
                "tail"] == x.numpy().nbytes
            assert (rs_mod.launches, rw_mod.launches) == before
            assert torch.equal(first["y"], again["y"])
    finally:
        rig.server.stop()


@pytest.mark.cuda
def test_ping_on_the_card_ring(dev, stream_env):
    """``Channel.ping`` over a device-ring connection on the card answers,
    and a call on the same connection still lands on the card's ring."""
    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)
    rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4)
    x = torch.zeros((1, 32, 32, 3))
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            rtts = [ch.ping(timeout=5.0) for _ in range(8)]
            assert all(0 <= r < 5.0 for r in rtts)
            out = TensorClient(ch).call("Classify", {"x": x}, timeout=60)
            assert out["y"].shape == (1, 10)
            assert rig.ring().stats()["tail"] == x.numpy().nbytes
    finally:
        rig.server.stop()


def _dial(port, mode, monkeypatch):
    """A channel whose connection is dialed with TPURPC_INLINE_PUMP set to
    ``mode`` (read once, when the connection is built)."""
    monkeypatch.setenv("TPURPC_INLINE_PUMP", mode)
    ch = Channel(f"127.0.0.1:{port}")
    ch._subchannels[0].get()
    monkeypatch.delenv("TPURPC_INLINE_PUMP")
    return ch


def _reader(conn):
    t = getattr(conn, "_thread", None)
    return t is not None and t.is_alive()


@pytest.mark.cuda
def test_pump_mode_card_ring_call_bit_equal_to_reader_mode(
        dev, stream_env, exact_f32, monkeypatch):
    """Phase 17 (a) at a small model: the same request through a pump-mode
    connection (no reader thread) and a reader-mode one lands on the card's
    ring and replies bit-equal, launching the same kernels."""
    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)
    rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))   # 48 KiB: the 2nd wraps
    outs = {}
    try:
        for mode in ("0", "auto"):
            ch = _dial(rig.port, mode, monkeypatch)
            try:
                conn = ch._conn
                assert conn._pump_mode is (mode == "auto")
                assert _reader(conn) is (mode == "0")
                before = (rs_mod.launches, rw_mod.launches)
                outs[mode] = [TensorClient(ch).call("Classify", {"x": x},
                                                    timeout=60)
                              for _ in range(2)]
                outs[mode + "_launches"] = (rs_mod.launches - before[0],
                                            rw_mod.launches - before[1])
            finally:
                ch.close()
    finally:
        rig.server.stop()
    for a, b in zip(outs["0"], outs["auto"]):
        assert torch.equal(a["y"], b["y"])
    assert outs["0_launches"] == outs["auto_launches"]
    assert min(outs["auto_launches"]) >= 1


@pytest.mark.cuda
def test_pipelined_window_in_pump_mode_on_card(dev, stream_env, exact_f32,
                                               monkeypatch):
    """Phase 17 (b) at a small model: 32 calls through a pipeline of depth 8
    on one pump-mode card-ring connection reply bit-equal to sequential
    calls; one servicing thread while calls are in flight, none a second
    after the window drains."""
    import time

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="256")
    infer = _small_model(dev)
    rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=8)
    rng = np.random.default_rng(8)
    xs = [torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32)) for _ in range(4)]
    try:
        ch = _dial(rig.port, "auto", monkeypatch)
        try:
            client = TensorClient(ch)
            want = [client.call("Classify", {"x": x}, timeout=60)
                    for x in xs]
            pipe = client.pipeline("Classify", depth=8)

            def servicing():
                with pipe._lock:
                    return [t for t in pipe._pump_threads.values()
                            if t.is_alive()]

            most, futs = 0, []
            for i in range(32):
                futs.append(pipe.call_async({"x": xs[i % 4]}, timeout=60))
                most = max(most, len(servicing()))
            got = [f.result(timeout=60) for f in futs]
            deadline = time.monotonic() + 1.0
            while servicing() and time.monotonic() < deadline:
                time.sleep(0.005)
            left = len(servicing())
            pipe.close()
            assert ch._conn._pump_mode and not _reader(ch._conn)
        finally:
            ch.close()
    finally:
        rig.server.stop()
    assert most == 1 and left == 0
    for i, out in enumerate(got):
        assert torch.equal(out["y"], want[i % 4]["y"])


@pytest.mark.cuda
def test_rendezvous_landing_whose_sender_pumped_its_claim(dev, stream_env,
                                                          monkeypatch):
    """A 4 MiB request on a fresh pump-mode card-ring connection: with no
    standing grant the sender OFFERs and pumps the connection itself until
    its CLAIM arrives, then the payload lands one-sided and on the card's
    ring, where the handler reduces it."""
    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB=str(16 << 10))

    def total(tree):
        x = tree["x"]
        assert x.device.type == "cuda"
        return {"sum": x.double().sum().reshape(1).cpu()}

    rig = CallPlaneServer(total, max_workers=4)
    x = np.random.default_rng(9).standard_normal(STREAM_SHAPE).astype(
        np.float32)
    try:
        ch = _dial(rig.port, "auto", monkeypatch)
        try:
            link = ch._conn.rdv
            pumped = []
            inner = link._pump

            def spy(pred, deadline):
                got = inner(pred, deadline)
                pumped.append(bool(pred()))
                return got

            link._pump = spy
            before = link.stats()
            out = TensorClient(ch).call("Classify",
                                        {"x": torch.from_numpy(x)},
                                        timeout=60)
            after = link.stats()
            tail = rig.ring().stats()["tail"]
        finally:
            ch.close()
    finally:
        rig.server.stop()
    assert pumped and pumped[0]
    assert after["sent"] - before["sent"] == 1
    assert after["fallbacks"] == before["fallbacks"]
    assert tail == x.nbytes
    x64 = x.astype(np.float64)
    assert abs(out["sum"].item() - x64.sum()) <= SUM_TOL * np.abs(x64).sum()


@pytest.mark.cuda
def test_pipelined_drain_migrates_between_card_rings(dev, stream_env,
                                                     exact_f32):
    """Phase 18 (a) at a small model: 16 pipelined calls (depth 4) over two
    card-ring servers behind ``round_robin``, server A drained after reply
    4: no call fails, every reply is bit-equal to a sequential call's, at
    least one refused call replayed, A admits nothing after its drain, and
    each server launched the kernels its ring's offsets give."""
    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64")
    infer = _small_model(dev)

    def classify(tree):
        logits = infer(tree["images"])
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    rng = np.random.default_rng(18)
    images = [rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
              for _ in range(4)]   # 24 KiB each: the 3rd landing wraps
    rig = CallPlaneServer(classify, max_workers=4)
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            client = TensorClient(ch)
            first = [client.call("Classify", {"images": torch.from_numpy(x)},
                                 timeout=60) for x in images]
    finally:
        rig.server.stop()
    got = pipelined_drain(classify, images, first, calls=16, drain_after=4,
                          depth=4, label="card drain")
    assert got["replays"] >= 1 and got["admitted_after_drain"] == 0
    assert sum(got["served"]) == 16
    assert got["launched"] == [{"ring_scatter": w, "ring_window": w}
                               for w in got["wraps"]]
    assert sum(got["wraps"]) >= 1


def _hbm_readings():
    from tpurpc_torch.obs import lens, metrics

    b, ns, cp = lens.hop_counters("hbm")
    return (metrics.counter("hbm_place_msgs").snapshot(),
            metrics.counter("hbm_place_bytes").snapshot(),
            b.snapshot(), cp.snapshot(), ns.snapshot())


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", [False, True], ids=["unwrapped", "wrapped"])
def test_hbm_hooks_count_card_landings(dev, wrap):
    """On a card ring the ``hbm`` hop and ``hbm_place_*`` move by exactly
    the bytes and messages landed, across the wrap point too (a
    ``place_many`` of two leaves is one landing of two messages), and
    ``hbm_ring_occupancy_bytes`` reads ``tail - head`` as leases come and
    go."""
    from tpurpc_torch.obs import metrics

    ring = HbmRing(CAP, device=dev)
    occ = metrics.fleet("hbm_ring_occupancy_bytes")
    if wrap:
        ring.view(*ring.place(np.zeros(CAP - 1000, np.uint8))).release()
    rng = np.random.default_rng(19)
    a = rng.integers(0, 256, 1500, dtype=np.uint8)
    b = rng.integers(0, 256, 900, dtype=np.uint8)
    r0 = _hbm_readings()
    spans = ring.place_many([a, b])
    r1 = _hbm_readings()
    assert ((spans[0][0] % CAP) + 2400 > CAP) == wrap
    assert [y - x for x, y in zip(r0[:4], r1[:4])] == [2, 2400, 2400, 2400]
    assert r1[4] > r0[4]
    assert occ._fn(ring) == 2400 and ring in set(occ._refs)
    leases = [ring.view(o, n) for o, n in spans]
    for le, want in zip(leases, (a, b)):
        np.testing.assert_array_equal(le.array.cpu().numpy(), want)
    leases[0].release()
    assert occ._fn(ring) == 900          # the head passed the first span
    leases[1].release()
    assert occ._fn(ring) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", [False, True], ids=["unwrapped", "wrapped"])
def test_hbm_hooks_wait_on_no_device(dev, wrap, monkeypatch):
    """No hook waits on the device: a landing and a view call no
    ``torch.cuda.synchronize``, no stream or event ``synchronize`` and no
    ``.item()`` (a landing over a released span makes its *stream* wait on
    the release's event, ``Event.wait``: the device waits, the host does
    not); and a view (an alias, or the ``ring_window`` gather) returns
    while work queued ahead of it on the stream still runs."""
    ring = HbmRing(CAP, device=dev)
    warm = HbmRing(64, device=dev)     # both kernels built first
    warm.view(*warm.place(np.zeros(48, np.uint8))).release()
    warm.view(*warm.place(np.zeros(32, np.uint8))).release()
    if wrap:
        ring.view(*ring.place(np.zeros(CAP - 1000, np.uint8))).release()
    calls = []

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapper

    for obj, name in ((torch.cuda, "synchronize"),
                      (torch.cuda.Stream, "synchronize"),
                      (torch.cuda.Event, "synchronize"),
                      (torch.Tensor, "item")):
        monkeypatch.setattr(obj, name, counted(name, getattr(obj, name)))
    off, n = ring.place(np.arange(3000, dtype=np.uint8))
    assert ((off % CAP) + n > CAP) == wrap
    assert calls == []                  # the landing
    torch.cuda.synchronize(dev)
    calls.clear()
    done = torch.cuda.Event()
    torch.cuda._sleep(200_000_000)      # about 0.1 s of the card's clock
    done.record()
    lease = ring.view(off, n)
    still_busy = not done.query()
    assert calls == [] and still_busy
    assert lease.aliased != wrap
    np.testing.assert_array_equal(lease.array.cpu().numpy(),
                                  np.arange(3000, dtype=np.uint8))
    lease.release()


def _scrape(port, path):
    """One HTTP/1.0 GET on loopback: ``(status, body)``."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.settimeout(30)
        s.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        buf = bytearray()
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    head, _, body = bytes(buf).partition(b"\r\n\r\n")
    return int(head.split(None, 2)[1]), body


def _metric(text, name):
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            return float(ln.rpartition(" ")[2])
    return 0.0


@pytest.mark.cuda
def test_scrape_routes_on_a_card_ring_server(dev, stream_env, exact_f32,
                                             monkeypatch):
    """Phase 20 (a) at a small model: the serving port of a card-ring server
    answers /metrics, whose hbm_place counters moved by exactly the calls'
    landings, and /debug/history samples the ring's occupancy on a short
    fine tier; the wrapped landings launched the kernels."""
    import json

    from tpurpc_torch.obs import tsdb

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64",
               TPURPC_TSDB_FINE_S="0.05")
    if tsdb._instance is not None:
        tsdb._instance.stop()
    tsdb.postfork_reset()
    infer = _small_model(dev)
    rig = CallPlaneServer(lambda t: {"y": infer(t["x"])}, max_workers=4)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))   # 48 KiB: the 2nd wraps
    try:
        before = _scrape(rig.port, "/metrics")[1].decode()
        launched = (rs_mod.launches, rw_mod.launches)
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            outs = [TensorClient(ch).call("Classify", {"x": x}, timeout=60)
                    for _ in range(4)]
        launched = (rs_mod.launches - launched[0],
                    rw_mod.launches - launched[1])
        status, body = _scrape(rig.port, "/metrics")
        after = body.decode()
        time.sleep(0.5)
        hist = json.loads(_scrape(
            rig.port, "/debug/history?series=hbm_ring_occupancy_bytes"
                      "&window_s=10")[1])
    finally:
        rig.server.stop()
        tsdb.get().stop()
        tsdb.postfork_reset()
    assert status == 200
    for name, want in (("tpurpc_hbm_place_bytes", 4 * x.numel() * 4),
                       ("tpurpc_hbm_place_msgs", 4)):
        assert _metric(after, name) - _metric(before, name) == want, name
    assert hist["kind"] == "gauge" and len(hist["points"]) >= 5
    assert min(launched) >= 1
    for out in outs:
        assert torch.equal(out["y"], outs[0]["y"])


@pytest.mark.cuda
def test_device_infer_trip_writes_and_diagnoses_a_bundle(
        dev, stream_env, exact_f32, tmp_path, monkeypatch):
    """Phase 20 (b) at a small model: a handler held in synchronized
    forwards on the card past the watchdog's bar trips it at device-infer;
    the armed bundle writer freezes the evidence, and the bundle's replay
    ranks the cause the live route ranked."""
    import json

    from tpurpc_torch.obs import bundle, diagnose, watchdog

    stream_env("TPU", TPURPC_HBM_RING_SIZE_KB="64",
               TPURPC_BUNDLE_DIR=str(tmp_path))
    infer = _small_model(dev)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    xd = x.to(dev)

    def slow(t):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.0:
            infer(xd)
            torch.cuda.synchronize(dev)
        return {"y": infer(t["x"])}

    wd = watchdog.get()
    prev = (wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled)
    wd.reset()
    wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = 0.3, 0.1, 1.0, True
    rig = CallPlaneServer(slow, max_workers=4)
    out, live = [], None
    try:
        assert bundle.enabled() and bundle.get().root == str(tmp_path)
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            th = threading.Thread(target=lambda: out.append(TensorClient(
                ch).call("Classify", {"x": x}, timeout=60)))
            th.start()
            deadline = time.monotonic() + 10
            while live is None and time.monotonic() < deadline:
                time.sleep(0.05)
                if any(d["kind"] == "server" for d in wd.active()):
                    live = json.loads(_scrape(rig.port, "/debug/diagnose")[1])
            th.join(60)
    finally:
        rig.server.stop()
        wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = prev
        bundle.disable()
    assert len(out) == 1
    assert live is not None and live["hypotheses"][0]["cause"] == \
        "device-infer"
    names = bundle.list_bundles(str(tmp_path))
    assert len(names) == 1 and "-watchdog-" in names[0]
    replay = diagnose.diagnose_bundle(str(tmp_path / names[0]))
    assert replay["hypotheses"][0]["cause"] == "device-infer"


@pytest.mark.cuda
def test_debug_seq_of_a_card_scheduler(dev):
    """Phase 21 (a) at a small size: a scheduler whose step model lives on
    the card serves streams over two accounts; ``/debug/seq`` on its port
    rolls each account up with the tokens its streams received, and
    ``/healthz?json=1`` carries the scheduler's ``gen`` line."""
    import json

    from tpurpc_torch.obs import odyssey
    from tpurpc_torch.serving import GenerationClient, serve_generation
    from tpurpc_torch.torchshim.generate import (ToyDecodeModel,
                                                 reference_decode)

    odyssey.reset()
    prompts = [[int(t) for t in np.random.default_rng(i).integers(0, 251, 9)]
               for i in range(4)]
    srv, port, sched = serve_generation(ToyDecodeModel(device=dev),
                                        max_batch=4, name="cardSeq")
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            toks = [list(GenerationClient(ch, name="cardSeq").generate(
                p, max_tokens=12, account=("card-a", "card-b")[i % 2],
                timeout=60)) for i, p in enumerate(prompts)]
        seq = json.loads(_scrape(port, "/debug/seq")[1])
        hz = json.loads(_scrape(port, "/healthz?json=1")[1])
    finally:
        srv.stop(grace=0)
        sched.close()
        odyssey.reset()
    assert toks == [reference_decode(p, 12) for p in prompts]
    for acct in ("card-a", "card-b"):
        row = seq["accounts"][acct]
        assert (row["seqs"], row["tokens"], row["sheds"]) == (2, 24, 0)
    assert seq["attributed_pct"] >= 95
    assert any(ln.startswith("gen cardSeq:") for ln in hz["lines"])


@pytest.mark.cuda
def test_decode_step_trip_on_a_card_scheduler(dev):
    """Phase 21 (c) at a small size: a decode step held 1 s in synchronized
    steps on the card trips the watchdog at decode-step, and
    ``/debug/diagnose`` on the serving port ranks it first."""
    import json

    from tpurpc_torch.obs import watchdog
    from tpurpc_torch.serving import GenerationClient, serve_generation
    from tpurpc_torch.torchshim.generate import (ToyDecodeModel,
                                                 reference_decode)

    class Held(ToyDecodeModel):
        holds = 1

        def step(self, states, tokens):
            if self.holds:
                self.holds = 0
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 1.0:
                    super().step(states, tokens)
                    torch.cuda.synchronize(dev)
            return super().step(states, tokens)

    wd = watchdog.get()
    prev = (wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled)
    wd.reset()
    wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = 0.3, 0.1, 1.0, True
    srv, port, sched = serve_generation(Held(device=dev), max_batch=4,
                                        name="cardHeld")
    out, diag, live = [], None, None
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            th = threading.Thread(target=lambda: out.append(list(
                GenerationClient(ch, name="cardHeld").generate(
                    [3, 1, 4], max_tokens=6, timeout=60))))
            th.start()
            deadline = time.monotonic() + 10
            while live is None and time.monotonic() < deadline:
                time.sleep(0.05)
                diag = next((d for d in wd.active()
                             if d["kind"] == "server"), None)
                if diag is not None:
                    live = json.loads(_scrape(port, "/debug/diagnose")[1])
            th.join(60)
    finally:
        srv.stop(grace=0)
        sched.close()
        wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = prev
        wd.reset()
    assert out == [reference_decode([3, 1, 4], 6)]
    assert diag is not None and diag["stage"] == "decode-step"
    assert live["hypotheses"][0]["cause"] == "decode-step"


# -- the native plane (the C core's client and server loops) ------------------

def _native_tensor_server(dev):
    """An adopting ``RDMA_BPEV`` server whose handlers take each request
    tensor to the card (a pageable copy, complete before the handler
    returns and the C loop frees the message) and compute there."""
    def affine(tree):
        x = tree["x"].to(dev)
        assert x.device.type == "cuda"
        return {"y": (x * 2 + 1).cpu()}

    def sums(trees):
        for tree in trees:
            x = tree["x"].to(dev)
            assert x.device.type == "cuda"
            yield {"i": tree["i"].clone(), "s": x.double().sum().cpu()}

    srv = Server(max_workers=8)
    add_tensor_method(srv, "Affine", affine)
    add_tensor_method(srv, "Sums", sums, kind="stream_stream")
    srv.start()
    return srv, srv.add_insecure_port("127.0.0.1:0")


@pytest.mark.cuda
def test_native_plane_tensor_unary_lands_on_card(dev, stream_env):
    """Unary tensor calls on the native plane (the channel's fast path and
    a ``NativeChannel`` pipeline) land on the card: replies bit-equal to
    the same arithmetic on the CPU; the server adopted and its Python plane
    saw no call."""
    from tpurpc_torch.rpc.native_client import NativeChannel

    stream_env("RDMA_BPEV")
    rng = np.random.default_rng(22)
    xs = [torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
          for _ in range(8)]
    srv, port = _native_tensor_server(dev)
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            got = [TensorClient(ch).call("Affine", {"x": x}, timeout=60)["y"]
                   for x in xs]
            assert ch._native_ch is not None
        with NativeChannel("127.0.0.1", port) as nch:
            pl = TensorClient(nch).pipeline("Affine", depth=4)
            piped = [f.result(60)["y"] for f in
                     [pl.call_async({"x": x}, timeout=60) for x in xs]]
        assert srv._native_dp is not None and srv._native_dp.adopted == 2
        assert srv.call_counters.started == 0 and not srv._connections
    finally:
        srv.stop(grace=0)
    for x, a, b in zip(xs, got, piped):
        assert torch.equal(a, x * 2 + 1) and torch.equal(b, x * 2 + 1)


@pytest.mark.cuda
def test_native_plane_duplex_lands_on_card(dev, stream_env):
    """``duplex(native=True)`` of 4 MiB tensors on the native plane, each
    summed on the card: the float64 sums equal numpy's within SUM_TOL."""
    stream_env("RDMA_BPEV")
    rng = np.random.default_rng(23)
    base = rng.standard_normal(STREAM_SHAPE).astype(np.float32)
    xs = [base + np.float32(i) for i in range(4)]
    srv, port = _native_tensor_server(dev)
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            replies = list(TensorClient(ch).duplex(
                "Sums", ({"i": torch.tensor([i]), "x": torch.from_numpy(x)}
                         for i, x in enumerate(xs)), timeout=120,
                native=True))
            assert ch._native_ch is not None
        assert srv._native_dp.adopted == 1 and srv.call_counters.started == 0
    finally:
        srv.stop(grace=0)
    assert [r["i"].item() for r in replies] == [0, 1, 2, 3]
    for r, x in zip(replies, xs):
        x64 = x.astype(np.float64)
        assert abs(r["s"].item() - x64.sum()) <= SUM_TOL * np.abs(x64).sum()
