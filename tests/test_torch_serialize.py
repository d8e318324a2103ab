"""The port's device serialization (``tpurpc_torch.tpu.serialize``) against
the reference's (``tpurpc.tpu.serialize``), on the CPU.

For the same tensor, made from a seed with numpy, both packages must emit
the same wire bytes and the same copy-ledger deltas (each package's own
``ledger.track()``): on the host, segments alias the tensor (``zero_copy``),
a decode aliases the buffer, and a one-sided write is billed
``rdma_write``. Byte equality is exact; there is no tolerance.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from tpurpc.jaxshim import codec as jcodec
from tpurpc.tpu import ledger as jledger
from tpurpc.tpu import serialize as jser
from tpurpc_torch.torchshim import codec as tcodec
from tpurpc_torch.tpu import ledger as tledger
from tpurpc_torch.tpu import serialize as tser

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64),
          "int32": (np.int32, torch.int32),
          "uint8": (np.uint8, torch.uint8),
          "float16": (np.float16, torch.float16),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "bool": (np.bool_, torch.bool)}
SHAPES = [(8, 8), (0, 3), (5,), ()]
KEYS = ("host_copy", "dma_h2d", "dma_d2h", "zero_copy", "rdma_write")


def _pair(dtype: str, shape, seed: int = 0):
    """The same values as a numpy array (reference) and a CPU tensor."""
    np_dt, _ = DTYPES[dtype]
    raw = np.random.default_rng(seed).standard_normal(shape) * 10
    x = np.asarray(raw).astype(np_dt)
    if dtype == "bfloat16":   # torch reads no ml_dtypes array: its bits
        return x, torch.from_numpy(np.array(x).view(np.uint16)).view(
            torch.bfloat16)
    return x, torch.from_numpy(np.array(x))


def _delta(w):
    return {k: (w[k], w[k + "_ops"]) for k in KEYS}


def _joined(segs) -> bytes:
    return b"".join(bytes(memoryview(s).cast("B")) for s in segs)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_serialize_from_device_bytes_and_ledger_match(dtype, shape):
    x, t = _pair(dtype, shape)
    with jledger.track() as jw:
        jsegs = jser.serialize_from_device(x)
    with tledger.track() as tw:
        tsegs = tser.serialize_from_device(t)
    assert _joined(tsegs) == _joined(jsegs)
    assert _delta(tw) == _delta(jw)
    assert tw["zero_copy"] == x.nbytes and tw["dma_d2h"] == 0
    y, end = tser.deserialize_to_device(_joined(tsegs), device="cpu")
    assert end == len(_joined(tsegs))
    assert y.dtype == t.dtype
    assert torch.equal(y.reshape(t.shape), t)


def test_serialize_from_jax_array_on_host_backend_matches():
    """The reference's own case: a jax.Array on the CPU backend."""
    import jax.numpy as jnp

    x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    with jledger.track() as jw:
        jsegs = jser.serialize_from_device(x)
    with tledger.track() as tw:
        tsegs = tser.serialize_from_device(torch.arange(64.0).reshape(8, 8))
    assert _joined(tsegs) == _joined(jsegs)
    assert _delta(tw) == _delta(jw)


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8"])
def test_deserialize_counts_alias_on_host(dtype):
    """One alias, no host copy. Divergence, stated: the reference bills the
    alias twice (its ``codec.to_jax`` and its ``deserialize_to_device`` each
    call ``ledger.zero_copy``); the port bills it once, as it bills one
    ``dma_h2d`` on a card."""
    x, t = _pair(dtype, (32, 32), seed=1)
    jbuf = bytearray(jcodec.encode_tensor_bytes(x))
    tbuf = bytearray(tcodec.encode_tensor_bytes(t))
    assert tbuf == jbuf
    with jledger.track() as jw:
        jy, jend = jser.deserialize_to_device(jbuf)
    with tledger.track() as tw:
        ty, tend = tser.deserialize_to_device(tbuf, device="cpu")
    assert tend == jend == len(tbuf)
    want = _delta(jw)
    want["zero_copy"] = (want["zero_copy"][0] // 2, want["zero_copy"][1] // 2)
    assert _delta(tw) == want
    assert tw["zero_copy"] == x.nbytes and tw["zero_copy_ops"] == 1
    assert tw["host_copy"] == 0
    np.testing.assert_array_equal(np.asarray(jy), x)
    assert torch.equal(ty, t)
    tbuf[len(tbuf) - x.nbytes] ^= 0xFF   # the tensor aliases the buffer
    assert not torch.equal(ty, t)


def test_deserialize_bfloat16_on_host():
    """Divergence, stated: the reference's dlpack import refuses bfloat16
    (BufferError); the port decodes it as an alias."""
    x, t = _pair("bfloat16", (4, 4), seed=2)
    buf = bytearray(tcodec.encode_tensor_bytes(t))
    with pytest.raises(BufferError):
        jser.deserialize_to_device(bytearray(buf))
    with tledger.track() as tw:
        y, _ = tser.deserialize_to_device(buf, device="cpu")
    assert torch.equal(y, t) and tw["zero_copy_ops"] == 1


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "b": rng.standard_normal((3,)).astype(np.float32)},
            "step": np.arange(2, dtype=np.int32),
            "stats": (rng.integers(0, 9, (5,)).astype(np.int64),
                      [np.ones((2, 2), np.float64)])}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_from_device_bytes_and_ledger_match(seed):
    tree = _tree(seed)
    with jledger.track() as jw:
        jsegs = jser.tree_from_device(tree)
    with tledger.track() as tw:
        tsegs = tser.tree_from_device(_torch_tree(tree))
    assert _joined(tsegs) == _joined(jsegs)
    assert _delta(tw) == _delta(jw)


class _Window:
    """A one-sided write target: a bytearray written at offsets."""

    def __init__(self, n):
        self.buf = bytearray(n)

    def write(self, off, view):
        self.buf[off:off + len(view)] = view


@pytest.mark.parametrize("offset", [0, 64, 7])
def test_serialize_into_writes_the_wire_bytes(offset):
    x, t = _pair("float32", (16, 16), seed=offset)
    jwin, twin = _Window(4096), _Window(4096)
    with jledger.track() as jw:
        jn = jser.serialize_into(x, jwin.write, offset)
    with tledger.track() as tw:
        tn = tser.serialize_into(t, twin.write, offset)
    assert tn == jn
    assert twin.buf == jwin.buf
    assert twin.buf[offset:offset + tn] == tcodec.encode_tensor_bytes(t)
    assert _delta(tw) == _delta(jw)
    assert tw["rdma_write"] == tn and tw["host_copy"] == 0


def test_serialize_tree_into_writes_the_wire_bytes():
    tree = _tree(3)
    jwin, twin = _Window(8192), _Window(8192)
    with jledger.track() as jw:
        jn = jser.serialize_tree_into(tree, jwin.write, 32)
    with tledger.track() as tw:
        tn = tser.serialize_tree_into(_torch_tree(tree), twin.write, 32)
    assert tn == jn and twin.buf == jwin.buf
    assert _delta(tw) == _delta(jw)


def test_package_exports_serialization():
    import tpurpc_torch.tpu as tpu

    for name in ("serialize_from_device", "deserialize_to_device",
                 "tree_from_device", "serialize_into", "serialize_tree_into"):
        assert getattr(tpu, name) is getattr(tser, name)
