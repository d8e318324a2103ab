"""Device-path serialization: wire bytes ↔ torch.Tensor with ledger accounting.

The port of ``tpurpc/tpu/serialize.py``:

* :func:`serialize_from_device` — a tensor's payload leaves device memory in
  exactly one D2H copy, into a pinned host tensor, and the wire segments
  alias that landing buffer (no host staging after it). A CPU tensor's
  segments alias the tensor itself: no movement.
* :func:`deserialize_to_device` — received wire bytes become a tensor on the
  device with exactly one H2D copy; on the CPU the tensor aliases the
  receive buffer.

Both report to :mod:`tpurpc_torch.tpu.ledger` as the reference does, so the
copy counts are assertable. The wire bytes are the codec's, identical to
the reference's for the same tensor.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from tpurpc_torch.torchshim import codec
from tpurpc_torch.tpu import ledger
from tpurpc_torch.utils.config import resolve_device


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def start_host_copy(tree: Any):
    """Flatten ``tree`` and start each device leaf's one D2H at once, into
    a pinned host tensor, behind the work already on its stream (billed
    ``dma_d2h``). Returns ``(host_leaves, treedef, event)``: host leaves
    stay as they are, and ``event`` (None when nothing left a card)
    completes when every copy has landed — read no leaf before it has."""
    leaves, treedef = codec.tree_flatten(tree)
    host, stream = [], None
    for x in leaves:
        if _on_card(x):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            ledger.dma_d2h(_nbytes(x))   # the one device→host copy
            stream = torch.cuda.current_stream(x.device)
            x = h
        host.append(x)
    event = None
    if stream is not None:
        event = torch.cuda.Event()
        event.record(stream)
    return host, treedef, event


def serialize_from_device(x) -> List[Any]:
    """Wire segments for a tensor without host staging.

    Returns the codec's gather list; the payload segment aliases the D2H
    landing buffer (or the tensor itself on the CPU) — downstream gather
    writes consume it in place."""
    (host,), _, event = start_host_copy(x)
    if event is not None:
        event.synchronize()
    ledger.zero_copy(_nbytes(x))  # segments alias the landing buffer
    return codec.encode_tensor(host)


def deserialize_to_device(buf, offset: int = 0, device=None):
    """Wire record → tensor on ``device`` (the config's when None) with
    ledger accounting; returns ``(tensor, end)``. One H2D on a card; on the
    CPU the tensor aliases ``buf``."""
    t, end = codec.decode_tensor(buf, offset)  # zero-copy view of buf
    return codec.to_torch(t, resolve_device(device)), end


def tree_from_device(tree: Any) -> List[Any]:
    """Pytree variant of :func:`serialize_from_device` (gather segments):
    every device leaf's D2H is enqueued first, then one wait."""
    host, treedef, event = start_host_copy(tree)
    for leaf in codec.tree_flatten(tree)[0]:
        if not _on_card(leaf):
            ledger.zero_copy(getattr(leaf, "nbytes", 0))
    if event is not None:
        event.synchronize()
    return codec.encode_tree(codec.tree_unflatten(treedef, host))


# ---------------------------------------------------------------------------
# SerializeFromDevice → one-sided write target
# ---------------------------------------------------------------------------

def serialize_into(x, write, offset: int = 0) -> int:
    """Gather-serialize one tensor STRAIGHT into a one-sided write target
    (a rendezvous landing window): each codec segment lands via
    ``write(offset, segment)``; no intermediate host buffer is allocated or
    joined. Billed as ``rdma_write``; exactly one ``dma_d2h`` for a device
    tensor and zero ``host_copy``. Returns bytes written past ``offset``."""
    return _write_segments(serialize_from_device(x), write, offset)


def serialize_tree_into(tree: Any, write, offset: int = 0) -> int:
    """Pytree variant of :func:`serialize_into`."""
    return _write_segments(tree_from_device(tree), write, offset)


def _write_segments(segs: List[Any], write, offset: int) -> int:
    total = 0
    for seg in segs:
        view = memoryview(seg).cast("B")
        write(offset + total, view)
        total += len(view)
    ledger.rdma_write(total)
    return total
