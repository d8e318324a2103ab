"""ring_window: contiguous copy of a span of a device byte ring.

    out[i] = ring[(head + i) mod capacity]        for i < n

Replaces the Pallas kernel ``tpurpc/ops/ring_window.py`` (``_kernel``,
``_ring_window_impl``). On a CUDA tensor :func:`ring_window` launches the
hand-written kernel ``csrc/ring_window.cu`` into a fresh ``torch.empty``
output or raises; on a CPU tensor it runs :func:`ring_window_plain`.

Bound on an H100: 2·n bytes at 3.35 TB/s, 0.002876 ms for a 4,816,896-byte
span. The wrapper plans the span on the host (``_span.window_plan``) and
passes the plan to the kernel, which spreads the chunks of both segments
over one grid, keeps eight 16-byte loads in flight per lane and realigns a
ring offset that is not a multiple of 16 in registers
(``csrc/ring_copy.cuh``). No (8,128) tiles, nine-row DMA windows or flat
rolls: those existed for the TPU's layout. Any byte offset and length are
taken.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurpc_torch.ops import _build, _span

#: launches of the CUDA kernel (the CPU path does not count)
launches = 0


def _check(ring: torch.Tensor, n: int) -> None:
    if ring.dtype != torch.uint8 or ring.dim() != 1 or not ring.is_contiguous():
        raise ValueError(f"ring_window: ring must be a contiguous 1-D uint8 "
                         f"tensor, got {ring.dtype} {tuple(ring.shape)}")
    if n < 0 or n > ring.numel():
        raise ValueError(f"ring_window: window {n} exceeds capacity "
                         f"{ring.numel()}")


def ring_window_plain(ring: torch.Tensor, head: int, n: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: two slice copies into a new
    tensor, one per segment as the kernel splits the span."""
    cap = ring.numel()
    out = torch.empty(n, dtype=torch.uint8, device=ring.device)
    if n == 0:
        return out
    p = head % cap
    first = min(n, cap - p)
    out[:first].copy_(ring[p:p + first])
    out[first:].copy_(ring[:n - first])
    return out


def ring_window(ring: torch.Tensor, head: int, n: int) -> torch.Tensor:
    """``out[i] = ring[(head + i) mod capacity]`` as a new uint8 tensor of
    length ``n``. Raises ValueError when ``n > capacity`` or on a wrong
    dtype, device or layout."""
    global launches
    _check(ring, n)
    if ring.device.type == "cpu":
        return ring_window_plain(ring, head, n)
    if ring.device.type != "cuda":
        raise ValueError(f"ring_window: unsupported device {ring.device}")
    out = torch.empty(n, dtype=torch.uint8, device=ring.device)
    if n == 0:
        return out
    plan = _span.window_plan(ring.data_ptr(), ring.numel(), head, n,
                             out.data_ptr())
    _build.launch("ring_window", plan, ring.device)
    launches += 1
    return out


def ring_window_reference(buf: np.ndarray, head: int, n: int) -> np.ndarray:
    """Numpy oracle for the kernel's contract."""
    capacity = buf.shape[0]
    idx = (head + np.arange(n)) % capacity
    return np.asarray(buf)[idx]
