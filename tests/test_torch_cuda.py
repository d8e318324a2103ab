"""Tests of the port that need a CUDA card; each skips where
``torch.cuda.is_available()`` is false. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax.) The CPU tests hold
the kernels' plain versions against the reference; here the CUDA kernels are
held against the plain versions, and the device ring, the fan-in batcher
and device serialization run on the card.
"""

import numpy as np
import pytest
import torch

from tpurpc_torch.models.resnet import make_infer_fn, resnet18_thin
from tpurpc_torch.ops import ring_scatter as rs_mod
from tpurpc_torch.ops import ring_window as rw_mod
from tpurpc_torch.ops.ring_scatter import ring_scatter, ring_scatter_plain
from tpurpc_torch.ops.ring_window import ring_window, ring_window_plain
from tpurpc_torch.torchshim import codec
from tpurpc_torch.torchshim.service import FanInBatcher, ShardedFanIn
from tpurpc_torch.tpu import ledger
from tpurpc_torch.tpu.hbm_ring import HbmRing
from tpurpc_torch.tpu.serialize import (deserialize_to_device,
                                        serialize_from_device)

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
