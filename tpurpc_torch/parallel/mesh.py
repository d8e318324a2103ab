"""Device mesh of the port: five logical axes over the ranks of a program.

The port of ``tpurpc/parallel/mesh.py``. The axes and their meaning are the
reference's:

=====  =====================================================================
axis   meaning
=====  =====================================================================
dp     data parallel — batch sharding
pp     pipeline parallel — layer stages, microbatch ring
sp     sequence parallel — ring attention (K/V rotate between ranks)
tp     tensor parallel — heads split, activation psum
ep     expert parallel — MoE all_to_all dispatch/return
=====  =====================================================================

This package runs one rank: :func:`build_mesh` gives a mesh of size 1 on one
device, every axis of size 1, as the reference runs on one chip ("axes the
hardware can't fill get size 1"). The collectives of
:mod:`tpurpc_torch.parallel.collectives` are then the identity. More ranks
need the collectives over ``torch.distributed`` (ROADMAP A6); until then a
request for more than one device raises rather than running quietly on one.

A :class:`Mesh` is a plain value, so a test may build one with axes above 1
to check that the collectives refuse it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from tpurpc_torch.utils.config import resolve_device

AXES = ("dp", "pp", "sp", "tp", "ep")

#: what a request for more than one rank is told
MULTI_RANK = ("meshes of more than one rank need collectives over "
              "torch.distributed, which are ROADMAP A6; this package runs a "
              "one-rank mesh")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The five axis sizes (in ``AXES`` order) and this rank's device."""

    shape: Tuple[int, ...]
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXES

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(AXES, self.shape))

    @classmethod
    def of(cls, sizes: Dict[str, int], device) -> "Mesh":
        """A mesh value with ``sizes`` (missing axes 1) on ``device``."""
        unknown = set(sizes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"axes are {AXES}")
        return cls(tuple(int(sizes.get(a, 1)) for a in AXES),
                   torch.device(device))


def factor_mesh(n_devices: int,
                priority: Sequence[str] = ("dp", "tp", "sp", "pp", "ep"),
                caps: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Split ``n_devices`` over the five logical axes.

    Greedy: peel prime factors (largest first) onto axes in ``priority``
    round-robin, respecting per-axis ``caps``. Deterministic, total product
    == n_devices, unfilled axes get 1.
    """
    sizes = {a: 1 for a in AXES}
    caps = caps or {}
    rem = n_devices
    factors = []
    d = 2
    while d * d <= rem:
        while rem % d == 0:
            factors.append(d)
            rem //= d
        d += 1
    if rem > 1:
        factors.append(rem)
    factors.sort(reverse=True)
    i = 0
    for f in factors:
        for _ in range(len(priority)):
            a = priority[i % len(priority)]
            i += 1
            if sizes[a] * f <= caps.get(a, n_devices):
                sizes[a] *= f
                break
        else:  # no axis can take it (all capped) — dump on dp
            sizes["dp"] *= f
    return sizes


def build_mesh(n_devices: Optional[int] = None,
               sizes: Optional[Dict[str, int]] = None,
               device=None) -> Mesh:
    """An ``AXES``-named mesh of ``n_devices`` ranks (default 1) on
    ``device`` (resolved by :func:`~tpurpc_torch.utils.config.resolve_device`:
    a CUDA device with no card raises).

    ``sizes`` default to :func:`factor_mesh`'s; missing axes get 1, and a
    product other than ``n_devices`` raises ``ValueError``, as in the
    reference. More than one rank raises ``NotImplementedError`` (A6).
    """
    n = n_devices or 1
    sizes = dict(sizes) if sizes else factor_mesh(n)
    for a in AXES:
        sizes.setdefault(a, 1)
    shape = tuple(sizes[a] for a in AXES)
    if math.prod(shape) != n:
        raise ValueError(f"mesh sizes {sizes} != {n} devices")
    if n > 1:
        raise NotImplementedError(f"build_mesh({n}): {MULTI_RANK}")
    return Mesh.of(sizes, resolve_device(device))


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.sizes[axis]
