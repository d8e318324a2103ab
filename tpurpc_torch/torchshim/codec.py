"""Tensor wire codec: torch.Tensor / numpy ↔ framed bytes, zero-copy decode.

The port of ``tpurpc/jaxshim/codec.py``; the wire bytes are identical:

    [4B magic 'TPT1'][1B dtype][1B ndim][2B reserved][8B payload nbytes]
    [ndim x 8B little-endian dims][row-major payload, 64B-aligned start]

Pytrees are a ``TPTR`` record: a count-prefixed run of tensor records plus a
JSON treedef trailer. Trees flatten in jax's order — dict keys sorted
(``OrderedDict`` keeps insertion order), lists and tuples in order, ``None``
an empty node — so both packages emit the same bytes for the same tree.

Dtype codes are wire ABI and map to torch dtypes; a code torch cannot hold
raises :class:`CodecError`. Decoding yields CPU tensors aliasing the receive
buffer; :func:`to_torch` moves one to a device. For a rendezvous transfer,
:func:`encode_tensor_descriptor` splits a record into its descriptor and its
payload, and :func:`decode_tensor_external` joins them again over the
landing region, with no copy.

The codec boundary carries three lens hops under the reference's names:
``device`` (encode: tensor bytes gathered into wire form), ``decode`` (the
parse back) and ``jax_array`` (the reference's name, kept so that the hop
tables line up: here :func:`to_torch`, the materialization on the target
device), one set of bumps per tensor or tree record. Encode and decode are
the ``codec`` profiler stage, :func:`to_torch` is ``device-dispatch``.
"""

from __future__ import annotations

import collections
import json
import struct
import time
from typing import Any, List, Tuple

import numpy as np
import torch

from tpurpc_torch.obs import lens as _lens
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.utils.buffers import host_tensor

_LENS_DEV_BYTES, _LENS_DEV_NS, _LENS_DEV_COPY = _lens.hop_counters("device")
_LENS_DEC_BYTES, _LENS_DEC_NS, _LENS_DEC_COPY = _lens.hop_counters("decode")
_LENS_JAX_BYTES, _LENS_JAX_NS, _LENS_JAX_COPY = _lens.hop_counters(
    "jax_array")

_LENS_STAGES = {
    "encode_tensor": "codec",
    "encode_tree": "codec",
    "decode_tensor": "codec",
    "decode_tree_at": "codec",
    "to_torch": "device-dispatch",
}
_profiler.register_stages(__file__, _LENS_STAGES)

MAGIC = b"TPT1"
_ALIGN = 64

# dtype code table (codes are wire ABI — append only, never renumber):
# code → torch dtype name
_CODE_NAMES = [
    (0, "float32"), (1, "float64"), (2, "int8"), (3, "int16"), (4, "int32"),
    (5, "int64"), (6, "uint8"), (7, "uint16"), (8, "uint32"), (9, "uint64"),
    (10, "float16"), (11, "bfloat16"), (12, "bool"), (13, "complex64"),
    (14, "complex128"), (15, "float8_e4m3fn"), (16, "float8_e5m2"),
]
_CODE_TO_DTYPE = {c: getattr(torch, n) for c, n in _CODE_NAMES
                  if isinstance(getattr(torch, n, None), torch.dtype)}
_DTYPE_TO_CODE = {d: c for c, d in _CODE_TO_DTYPE.items()}

_HDR = struct.Struct("<4sBBHQ")  # magic, dtype code, ndim, reserved, nbytes


class CodecError(ValueError):
    pass


def dtype_code(dt: torch.dtype) -> int:
    try:
        return _DTYPE_TO_CODE[dt]
    except KeyError:
        raise CodecError(f"unsupported wire dtype {dt}") from None


def _code_dtype(code: int) -> torch.dtype:
    try:
        return _CODE_TO_DTYPE[code]
    except KeyError:
        raise CodecError(f"unknown dtype code {code}") from None


def _as_cpu_tensor(x) -> torch.Tensor:
    """A contiguous CPU tensor for ``x`` (a tensor, numpy array or scalar),
    without a copy when it already is one. A device tensor comes to the
    host with one copy. A 0-d value travels as shape (1,), as the
    reference's ``np.ascontiguousarray`` sends it."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.reshape(1) if t.dim() == 0 else t
    arr = np.ascontiguousarray(np.asarray(x))
    try:
        return torch.from_numpy(arr)
    except TypeError:
        raise CodecError(f"unsupported wire dtype {arr.dtype}") from None


def _u8_view(t: torch.Tensor) -> memoryview:
    """The raw bytes of a contiguous CPU tensor, as a memoryview, no copy."""
    flat = t.reshape(-1)
    if flat.dtype != torch.uint8:
        flat = flat.view(torch.uint8)
    return memoryview(flat.numpy()).cast("B")


def encode_tensor(x) -> List[Any]:
    """Encode one tensor as a gather list: ``[header+dims+pad, payload]``;
    the payload is a memoryview over the tensor's memory."""
    t0 = time.monotonic_ns()
    t = _as_cpu_tensor(x)
    code = dtype_code(t.dtype)
    nbytes = t.numel() * t.element_size()
    dims = struct.pack(f"<{t.dim()}q", *t.shape) if t.dim() else b""
    head = _HDR.pack(MAGIC, code, t.dim(), 0, nbytes) + dims
    head += b"\x00" * ((-len(head)) % _ALIGN)
    payload = _u8_view(t)
    dt = time.monotonic_ns() - t0
    _LENS_DEV_NS.inc(dt)
    _LENS_DEV_BYTES.inc(nbytes)
    # a host input made contiguous by a copy; a device tensor's download is
    # the copy ledger's to count, as the reference's device input is
    if isinstance(x, np.ndarray):
        if t.numel() and t.data_ptr() != x.ctypes.data:
            _LENS_DEV_COPY.inc(nbytes)
    elif isinstance(x, torch.Tensor) and x.device.type == "cpu":
        if t.numel() and t.data_ptr() != x.data_ptr():
            _LENS_DEV_COPY.inc(nbytes)
    return [head, payload]


def encode_tensor_descriptor(x) -> Tuple[bytes, memoryview]:
    """Descriptor-only encode for a rendezvous transfer: ``(descriptor,
    payload_view)``, the descriptor being the record's header, dims and
    pad (the bytes the framed path carries) and the view aliasing the
    tensor's memory (the bytes the one-sided write places).
    :func:`decode_tensor_external` is the inverse."""
    head, payload = encode_tensor(x)
    return bytes(head), memoryview(payload).cast("B")


def decode_tensor_external(desc, payload) -> torch.Tensor:
    """A tensor from its descriptor and its separately delivered payload
    (a rendezvous landing region). The tensor aliases ``payload`` and
    holds it, so the region stays unrecycled while the tensor lives."""
    view = memoryview(desc)
    if len(view) < _HDR.size:
        raise CodecError("short tensor descriptor")
    magic, code, ndim, _, nbytes = _HDR.unpack_from(view, 0)
    if magic != MAGIC:
        raise CodecError(f"bad tensor magic {magic!r}")
    dt = _code_dtype(code)
    if len(view) < _HDR.size + 8 * ndim:
        raise CodecError("short tensor descriptor dims")
    shape = struct.unpack_from(f"<{ndim}q", view, _HDR.size) if ndim else ()
    pv = memoryview(payload).cast("B")
    if len(pv) < nbytes:
        raise CodecError(f"external payload short: want {nbytes}, "
                         f"have {len(pv)}")
    itemsize = torch.empty(0, dtype=dt).element_size()
    expect = (int(np.prod(shape, dtype=np.int64)) * itemsize
              if ndim else itemsize)
    if expect != nbytes:
        raise CodecError(f"shape/nbytes mismatch: {shape} x {dt} "
                         f"!= {nbytes}")
    t = host_tensor(np.frombuffer(pv, dtype=np.uint8, count=nbytes))
    if dt != torch.uint8:
        t = t.view(dt)
    return t.reshape(shape)


def encode_tensor_bytes(x) -> bytes:
    out = bytearray()
    for s in encode_tensor(x):
        out += s
    return bytes(out)


def parse_tensor_header(view: memoryview, offset: int):
    """``(dtype, shape, nbytes, payload_pos)`` of the tensor record at
    ``offset``; checks that the payload is present."""
    if len(view) - offset < _HDR.size:
        raise CodecError("short tensor header")
    magic, code, ndim, _, nbytes = _HDR.unpack_from(view, offset)
    if magic != MAGIC:
        raise CodecError(f"bad tensor magic {magic!r}")
    dt = _code_dtype(code)
    pos = offset + _HDR.size
    if len(view) - pos < 8 * ndim:
        raise CodecError("short tensor dims")
    shape = struct.unpack_from(f"<{ndim}q", view, pos) if ndim else ()
    pos += 8 * ndim
    pos += (-(pos - offset)) % _ALIGN
    if len(view) - pos < nbytes:
        raise CodecError(
            f"short tensor payload: want {nbytes}, have {len(view) - pos}")
    return dt, shape, nbytes, pos


def decode_tensor(buf, offset: int = 0, copy: bool = False
                  ) -> Tuple[torch.Tensor, int]:
    """Decode one tensor record at ``offset``; returns ``(tensor,
    next_offset)``. With ``copy=False`` the tensor aliases ``buf`` (the
    caller keeps ``buf`` alive)."""
    view = memoryview(buf)
    dt, shape, nbytes, pos = parse_tensor_header(view, offset)
    itemsize = torch.empty(0, dtype=dt).element_size()
    expect = int(np.prod(shape, dtype=np.int64)) * itemsize if shape else itemsize
    if expect != nbytes:
        raise CodecError(f"shape/nbytes mismatch: {shape} x {dt} != {nbytes}")
    flat = np.frombuffer(view, dtype=np.uint8, count=nbytes, offset=pos)
    t = host_tensor(flat)
    if dt != torch.uint8:
        t = t.view(dt)
    t = t.reshape(shape)
    if copy:
        t = t.clone()
    return t, pos + nbytes


def to_torch(t: torch.Tensor, device=None) -> torch.Tensor:
    """Host tensor → tensor on ``device`` (the config's when None). On the
    CPU it is the same tensor (ledger ``zero_copy``); on a card, one
    host→device copy (``dma_h2d``)."""
    from tpurpc_torch.tpu import ledger
    from tpurpc_torch.utils.config import resolve_device

    t0 = time.monotonic_ns()
    dev = resolve_device(device)
    nbytes = t.numel() * t.element_size()
    try:
        if t.device == dev:
            ledger.zero_copy(nbytes)
            return t
        ledger.dma_h2d(nbytes)
        _LENS_JAX_COPY.inc(nbytes)
        return t.to(dev)
    finally:
        dt = time.monotonic_ns() - t0
        _LENS_JAX_NS.inc(dt)
        _LENS_JAX_BYTES.inc(nbytes)


# ---------------------------------------------------------------------------
# Pytrees: N tensor records + JSON treedef trailer
# ---------------------------------------------------------------------------

_TREE = struct.Struct("<4sIQ")  # magic 'TPTR', n_leaves, trailer nbytes
TREE_MAGIC = b"TPTR"

_LEAF = {"__leaf__": 1}
_NONE = {"__none__": 1}


def _key_to_json(k) -> Any:
    if isinstance(k, str):
        return {"t": "s", "v": k}
    if isinstance(k, bool):  # before int: bool is an int subclass
        return {"t": "b", "v": k}
    if isinstance(k, int):
        return {"t": "i", "v": k}
    raise CodecError(f"unsupported dict key {k!r} (str/int/bool only)")


def _key_from_json(j) -> Any:
    return {"s": str, "b": bool, "i": int}[j["t"]](j["v"])


def _dict_keys(d: dict) -> list:
    """Keys in jax's flattening order: sorted, except OrderedDict."""
    if isinstance(d, collections.OrderedDict):
        return list(d)
    return sorted(d)


# The walks below are module functions, not closures: a recursive closure
# is a reference cycle, which would keep the leaves (tensors aliasing a
# receive buffer or a rendezvous landing region) alive until the cyclic
# garbage collector runs, long after the caller dropped them.

def _walk(node, leaves: list):
    if node is None:
        return _NONE
    if isinstance(node, (list, tuple)):
        return {"__seq__": "list" if isinstance(node, list) else "tuple",
                "items": [_walk(v, leaves) for v in node]}
    if isinstance(node, dict):
        return {"__dict__": [[_key_to_json(k), _walk(node[k], leaves)]
                             for k in _dict_keys(node)]}
    leaves.append(node)
    return _LEAF


def tree_flatten(tree: Any) -> Tuple[list, Any]:
    """``(leaves, treedef_json)`` in jax's flattening order."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _build(j, it):
    if j == _LEAF:
        return next(it)
    if j == _NONE:
        return None
    if "__seq__" in j:
        items = [_build(v, it) for v in j["items"]]
        return items if j["__seq__"] == "list" else tuple(items)
    if "__dict__" in j:
        return {_key_from_json(k): _build(v, it) for k, v in j["__dict__"]}
    raise CodecError(f"bad treedef json {j!r}")


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    """Rebuild a tree from its JSON treedef and leaves in flattening order."""
    return _build(treedef, iter(leaves))


def encode_tree(tree: Any) -> List[Any]:
    """Encode a pytree of tensors as a gather list."""
    leaves, treedef = tree_flatten(tree)
    trailer = json.dumps(treedef).encode()
    segs: List[Any] = [_TREE.pack(TREE_MAGIC, len(leaves), len(trailer))]
    pad = (-_TREE.size) % _ALIGN
    if pad:
        segs.append(b"\x00" * pad)
    for leaf in leaves:
        segs.extend(encode_tensor(leaf))
        rem = (-len(segs[-1])) % _ALIGN
        if rem:
            segs.append(b"\x00" * rem)
    segs.append(trailer)
    return segs


def encode_tree_bytes(tree: Any) -> bytes:
    out = bytearray()
    for s in encode_tree(tree):
        out += s
    return bytes(out)


def read_tree_header(view: memoryview, offset: int = 0) -> Tuple[int, int, int]:
    """``(n_leaves, trailer_len, first_leaf_pos)`` of the tree record at
    ``offset``."""
    if len(view) - offset < _TREE.size:
        raise CodecError("short tree header")
    magic, n, trailer_len = _TREE.unpack_from(view, offset)
    if magic != TREE_MAGIC:
        raise CodecError(f"bad tree magic {magic!r}")
    return n, trailer_len, offset + _TREE.size + ((-_TREE.size) % _ALIGN)


def read_trailer(view: memoryview, pos: int, trailer_len: int) -> Any:
    if len(view) - pos < trailer_len:
        raise CodecError("short tree trailer")
    return json.loads(view[pos:pos + trailer_len].tobytes().decode())


def decode_tree_at(buf, offset: int = 0, copy: bool = False,
                   as_torch: bool = False, device=None) -> Tuple[Any, int]:
    """Decode one tree record at ``offset``; returns ``(tree, next_offset)``.
    Alignment is relative to the record start. ``as_torch`` moves each leaf
    to ``device`` through :func:`to_torch`."""
    t0 = time.monotonic_ns()
    view = memoryview(buf)
    n, trailer_len, pos = read_tree_header(view, offset)
    leaves = []
    payload = 0
    for _ in range(n):
        t, pos = decode_tensor(view, pos, copy=copy)
        pos += (-(pos - offset)) % _ALIGN
        payload += t.numel() * t.element_size()
        leaves.append(to_torch(t, device) if as_torch else t)
    treedef = read_trailer(view, pos, trailer_len)
    out = tree_unflatten(treedef, leaves), pos + trailer_len
    # the `decode` hop: one set of bumps per tree record (to_torch's share
    # shows on its own row too: hops nest)
    dt = time.monotonic_ns() - t0
    _LENS_DEC_NS.inc(dt)
    _LENS_DEC_BYTES.inc(payload)
    if copy:
        _LENS_DEC_COPY.inc(payload)
    return out


def decode_tree(buf, copy: bool = False, as_torch: bool = False,
                offset: int = 0, device=None) -> Any:
    tree, _ = decode_tree_at(buf, offset, copy=copy, as_torch=as_torch,
                             device=device)
    return tree


# Serializer/deserializer adapters for the rpc layer. Serializers return
# gather lists, so tensor payloads are never joined into a host buffer.

def tree_serializer(tree) -> List[Any]:
    return encode_tree(tree)


def tree_deserializer(buf) -> Any:
    return decode_tree(buf)


def raw_view(buf):
    """Identity deserializer that receives the assembly view itself:
    device-mode tensor handlers decode it into the device ring."""
    return buf


# These decode zero-copy over the received assembly view; the rpc layer
# hands them the memoryview as-is (rpc.status.deserialize).
tree_deserializer.alias_ok = True
raw_view.alias_ok = True
