"""Platform.TPU endpoint: the ring byte-pipe whose received tensor payloads
land in a device-resident ring and surface as lease-backed tensors.

The port of ``tpurpc/tpu/endpoint.py``. ``create_endpoint`` dispatches here
for ``GRPC_PLATFORM_TYPE=TPU`` / ``RDMA_TPU``:

* the byte pipe is the same pooled Pair as the other ring platforms; frame
  headers, metadata and trailers are parsed on the host;
* each connection owns an :class:`~tpurpc_torch.tpu.hbm_ring.HbmRing`
  (``device_ring``) on the config's device, created on first tensor decode;
* :func:`decode_tensor_to_ring` / :func:`decode_tree_to_ring` parse the
  codec's tensor headers on the host, land every payload in the device ring
  straight from the wire-assembly buffer, and hand back device views whose
  leases gate the ring's credit.

The device-plane decode (wire record to placed device view) is the
``decode`` lens hop, under the reference's name; its landing share shows on
the ``hbm`` hop (hops nest). Its functions are the ``codec`` profiler stage.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from tpurpc_torch.core.endpoint import RingEndpoint
from tpurpc_torch.obs import lens as _lens
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.torchshim import codec
from tpurpc_torch.tpu.hbm_ring import HbmLease, HbmRing
from tpurpc_torch.utils.config import Platform, get_config

_LENS_DEC_BYTES, _LENS_DEC_NS, _LENS_DEC_COPY = _lens.hop_counters("decode")

_LENS_STAGES = {
    "decode_tensor_to_ring": "codec",
    "decode_tree_to_ring": "codec",
    "_parse_tensor_record": "codec",
}
_profiler.register_stages(__file__, _LENS_STAGES)

#: default wait for device-ring space before failing a decode: long enough
#: to ride out a burst of unreleased leases, short enough to surface a leak
PLACE_TIMEOUT_S = 30.0


class TpuRingEndpoint(RingEndpoint):
    """Ring endpoint + device-resident receive ring for tensor payloads."""

    def __init__(self, sock: socket.socket, *, pool_key: str,
                 preread: bytes = b""):
        super().__init__(sock, discipline=Platform.TPU.discipline,
                         pool_key=pool_key, preread=preread)
        self._hbm: Optional[HbmRing] = None
        self._hbm_lock = threading.Lock()

    @property
    def device_ring(self) -> HbmRing:
        """The connection's device receive ring, created on first use on
        the config's device (``TPURPC_TORCH_DEVICE``)."""
        if self._hbm is None:
            with self._hbm_lock:
                if self._hbm is None:
                    cfg = get_config()
                    self._hbm = HbmRing(cfg.hbm_ring_size, device=cfg.device)
        return self._hbm

    def close(self) -> None:
        # leases pin spans and the device tensor dies with its last reference
        self._hbm = None
        super().close()


# ---------------------------------------------------------------------------
# DeserializeToDevice over the device ring.
# ---------------------------------------------------------------------------

def _parse_tensor_record(view: memoryview, offset: int):
    """Host-side parse of one codec tensor record: ``(dtype, shape,
    payload_view, next_offset)``, the payload a zero-copy numpy view."""
    dt, shape, nbytes, pos = codec.parse_tensor_header(view, offset)
    payload = np.frombuffer(view, dtype=np.uint8, count=nbytes, offset=pos)
    return dt, shape, payload, pos + nbytes


def decode_tensor_to_ring(ring: HbmRing, buf, offset: int = 0,
                          timeout: Optional[float] = PLACE_TIMEOUT_S
                          ) -> Tuple[HbmLease, int]:
    """One wire tensor record → device-ring placement + lease-backed view.
    Returns ``(lease, next_offset)``; releasing the lease returns credit."""
    t0 = time.monotonic_ns()
    dt, shape, payload, next_pos = _parse_tensor_record(memoryview(buf), offset)
    off, n = ring.place(payload, timeout=timeout)
    lease = ring.view(off, n, dtype=dt, shape=shape)
    elapsed = time.monotonic_ns() - t0
    _LENS_DEC_NS.inc(elapsed)
    _LENS_DEC_BYTES.inc(n)
    return lease, next_pos


def _tree_payload_bytes(view: memoryview, n_leaves: int) -> int:
    """Sum the payload sizes of a tree message by walking headers only."""
    _, _, pos = codec.read_tree_header(view)
    total = 0
    for _ in range(n_leaves):
        if len(view) - pos < codec._HDR.size:
            raise codec.CodecError("short tensor header")
        magic, _, ndim, _, nbytes = codec._HDR.unpack_from(view, pos)
        if magic != codec.MAGIC:
            raise codec.CodecError(f"bad tensor magic {magic!r}")
        rec = pos
        pos += codec._HDR.size + 8 * ndim
        pos += (-(pos - rec)) % codec._ALIGN
        pos += nbytes
        pos += (-pos) % codec._ALIGN
        total += nbytes
    return total


def decode_tree_to_ring(ring: HbmRing, buf,
                        timeout: Optional[float] = PLACE_TIMEOUT_S
                        ) -> Tuple[Any, List[HbmLease]]:
    """Pytree wire message → device-ring-backed tree + the leases pinning it.

    Every leaf header is parsed on the host first, then all payloads land
    with ONE ``place_many`` (one staging copy, one landing write). Returns
    ``(tree, leases)``; release every lease (or use :class:`DeviceMessage`)
    to return the ring credit."""
    t0 = time.monotonic_ns()
    view = memoryview(buf)
    n_leaves, trailer_len, pos = codec.read_tree_header(view)
    # a tree that can never fit must fail fast: waiting is futile when the
    # blocking leases are this same message's earlier leaves
    total = _tree_payload_bytes(view, n_leaves)
    if total > ring.capacity:
        raise BufferError(
            f"tree payloads total {total} bytes > ring capacity "
            f"{ring.capacity}; raise TPURPC_HBM_RING_SIZE_KB")
    metas = []  # (dtype, shape)
    payloads = []
    for _ in range(n_leaves):
        dt, shape, payload, pos = _parse_tensor_record(view, pos)
        pos += (-pos) % codec._ALIGN
        metas.append((dt, shape))
        payloads.append(payload)
    if len(view) - pos < trailer_len:
        raise codec.CodecError("short tree trailer")
    spans = ring.place_many(payloads, timeout=timeout)
    leases: List[HbmLease] = []
    try:
        for (dt, shape), (off, n) in zip(metas, spans):
            leases.append(ring.view(off, n, dtype=dt, shape=shape))
        treedef = codec.read_trailer(view, pos, trailer_len)
        tree = codec.tree_unflatten(treedef, [le.array for le in leases])
    except Exception:
        # corrupt leaf, trailer or treedef: every lease taken goes back, and
        # spans placed but never viewed are consumed-and-released too, or a
        # poison message pins ring credit for good
        for lease in leases:
            lease.release()
        for off, n in spans[len(leases):]:
            try:
                ring.view(off, n).release()
            except Exception:
                pass  # span already torn down; nothing more to free
        raise
    elapsed = time.monotonic_ns() - t0
    _LENS_DEC_NS.inc(elapsed)
    _LENS_DEC_BYTES.inc(total)
    return tree, leases


class DeviceMessage:
    """A decoded device-resident message: the tree + its ring leases. Use as
    a context manager (or call :meth:`release`): the spans stay pinned until
    then, which is the flow control."""

    __slots__ = ("tree", "_leases", "_released")

    def __init__(self, tree: Any, leases: List[HbmLease]):
        self.tree = tree
        self._leases = leases
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            for lease in self._leases:
                lease.release()

    def __enter__(self) -> Any:
        return self.tree

    def __exit__(self, *exc) -> bool:
        self.release()
        return False
