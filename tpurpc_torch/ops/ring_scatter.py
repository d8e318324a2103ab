"""ring_scatter: land a payload into a device byte ring, across the wrap.

    ring[(start + i) mod capacity] = payload[i]        for i < n

Replaces the Pallas kernel ``tpurpc/ops/ring_scatter.py`` (``_kernel``,
``_ring_scatter_impl``). On a CUDA tensor :func:`ring_scatter` launches the
hand-written kernel ``csrc/ring_scatter.cu`` or raises; on a CPU tensor it
runs :func:`ring_scatter_plain`, the same function in plain PyTorch.

Bound on an H100: 2·n bytes (n read, n written) at 3.35 TB/s, 0.002876 ms
for one 4,816,896-byte request span. The wrapper plans the span on the host
(``_span.scatter_plan``: two segments, each a byte head, a body of 16-byte
destination words cut into chunks, and a byte tail) and passes the plan to
the kernel, which spreads the chunks of both segments over one grid, keeps
eight 16-byte loads in flight per lane and realigns a skewed payload in
registers (``csrc/ring_copy.cuh``). Every destination byte has one writer,
so the TPU kernel's in-order read-modify-write of shared rows is gone, and
any byte offset and length are taken.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurpc_torch.ops import _build, _span

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0


def _check(ring: torch.Tensor, payload: torch.Tensor) -> None:
    for name, t in (("ring", ring), ("payload", payload)):
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"ring_scatter: {name} must be a contiguous "
                             f"1-D uint8 tensor, got {t.dtype} {tuple(t.shape)}")
    if ring.device != payload.device:
        raise ValueError(f"ring_scatter: ring on {ring.device}, payload on "
                         f"{payload.device}")
    if payload.numel() > ring.numel():
        raise ValueError(f"ring_scatter: payload {payload.numel()} exceeds "
                         f"capacity {ring.numel()}")


def ring_scatter_plain(ring: torch.Tensor, payload: torch.Tensor,
                       start: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: two slice copies."""
    cap = ring.numel()
    n = payload.numel()
    if n == 0:
        return ring
    p = start % cap
    first = min(n, cap - p)
    ring[p:p + first].copy_(payload[:first])
    ring[:n - first].copy_(payload[first:])
    return ring


def ring_scatter(ring: torch.Tensor, payload: torch.Tensor,
                 start: int) -> torch.Tensor:
    """``ring[(start + i) mod capacity] = payload[i]``, in place; returns
    ``ring``. Raises ValueError when ``len(payload) > capacity`` or on a
    wrong dtype, device or layout."""
    global launches
    _check(ring, payload)
    n = payload.numel()
    if ring.device.type == "cpu":
        return ring_scatter_plain(ring, payload, start)
    if ring.device.type != "cuda":
        raise ValueError(f"ring_scatter: unsupported device {ring.device}")
    if n == 0:
        return ring
    plan = _span.scatter_plan(ring.data_ptr(), ring.numel(),
                              payload.data_ptr(), start, n)
    _build.launch("ring_scatter", plan, ring.device)
    launches += 1
    return ring


def ring_scatter_reference(buf: np.ndarray, payload: np.ndarray,
                           start: int) -> np.ndarray:
    """Numpy oracle for the kernel's contract."""
    out = np.array(buf, copy=True)
    idx = (start + np.arange(payload.shape[0])) % buf.shape[0]
    out[idx] = payload
    return out
