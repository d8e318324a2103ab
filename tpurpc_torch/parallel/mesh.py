"""Device mesh of the port: five logical axes over the ranks of a program.

The port of ``tpurpc/parallel/mesh.py``. The axes and their meaning are the
reference's:

=====  =====================================================================
axis   meaning
=====  =====================================================================
dp     data parallel — batch sharding, gradient psum
pp     pipeline parallel — layer stages, microbatch ring
sp     sequence parallel — ring attention (K/V rotate between ranks)
tp     tensor parallel — heads split, activation psum
ep     expert parallel — MoE all_to_all dispatch/return
=====  =====================================================================

A mesh of n ranks is one process per rank, joined by ``torch.distributed``
(:func:`tpurpc_torch.parallel.distributed.initialize_cluster`). Ranks map to
coordinates row-major in ``AXES`` order, as the reference reshapes its
device list, so rank r holds what reference device r holds. The mesh owns
one process group for every set of its axes of size above 1 (each axis, and
every tuple of them the model reduces over: ('dp', 'ep', 'sp') for the
loss, the replicated axes of each parameter for its gradient). A group's
ranks are in ``AXES`` row-major order, which for a single axis is its
coordinate order: ``all_to_all`` and ``shift`` rely on that.

``build_mesh(1)`` is one rank with every axis of size 1: it creates no group
and needs no ``torch.distributed``, and every collective is the identity.

A :class:`Mesh` is also a plain value (:meth:`Mesh.of`): with axes above 1
and no groups it serves the config's divisibility checks, and a collective
over such an axis raises.

:func:`shard` and :func:`replicated` take the place of the reference's
``NamedSharding``: a spec picks this rank's slice of a global tensor.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, FrozenSet, Mapping, Optional, Sequence, Tuple, Union

import torch

from tpurpc_torch.utils.config import resolve_device

AXES = ("dp", "pp", "sp", "tp", "ep")

#: an axis name or a tuple of them (the first one major)
AxisSpec = Union[str, Tuple[str, ...]]


def axes_of(axis: AxisSpec) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The five axis sizes (in ``AXES`` order), this rank's index and
    device, and the process groups of its axes (None for a plain value)."""

    shape: Tuple[int, ...]
    device: torch.device
    rank: int = 0
    groups: Optional[Mapping[FrozenSet[str], object]] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXES

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(AXES, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (row-major in ``AXES``)."""
        out, r = {}, self.rank
        for a, n in reversed(list(zip(AXES, self.shape))):
            r, out[a] = divmod(r, n)
        return {a: out[a] for a in AXES}

    @classmethod
    def of(cls, sizes: Dict[str, int], device) -> "Mesh":
        """A mesh value with ``sizes`` (missing axes 1) on ``device``, with
        no process groups."""
        unknown = set(sizes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"axes are {AXES}")
        return cls(tuple(int(sizes.get(a, 1)) for a in AXES),
                   torch.device(device))

    def group(self, axis: AxisSpec):
        """The process group over ``axis`` (a name or a tuple), or None
        where its size is 1. A plain value raises for an axis above 1."""
        key = frozenset(a for a in axes_of(axis) if self.sizes[a] > 1)
        if not key:
            return None
        if self.groups is None:
            raise ValueError(
                f"mesh axis {axis!r} has size {axis_size(self, axis)} but "
                "this mesh has no process groups: build it with "
                "build_mesh(n) after initialize_cluster()")
        return self.groups[key]


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


def _make_groups(shape: Tuple[int, ...], rank: int
                 ) -> Dict[FrozenSet[str], object]:
    """One process group per set of the axes of size above 1, this rank's
    of each. ``new_subgroups_by_enumeration`` is collective over the world:
    every rank enumerates the same sets in the same order."""
    import torch.distributed as dist

    big = [i for i, n in enumerate(shape) if n > 1]
    coords = [dict(zip(AXES, c)) for c in itertools.product(
        *(range(n) for n in shape))]          # rank r is coords[r]
    groups = {}
    for k in range(1, len(big) + 1):
        for combo in itertools.combinations(big, k):
            key = frozenset(AXES[i] for i in combo)
            members: Dict[tuple, list] = {}
            for r, c in enumerate(coords):
                rest = tuple(v for a, v in c.items() if a not in key)
                members.setdefault(rest, []).append(r)
            mine, _ = dist.new_subgroups_by_enumeration(
                list(members.values()))
            groups[key] = mine
    return groups


def build_mesh(n_devices: Optional[int] = None,
               sizes: Optional[Dict[str, int]] = None,
               device=None) -> Mesh:
    """An ``AXES``-named mesh of ``n_devices`` ranks (default 1) on
    ``device`` (resolved by :func:`~tpurpc_torch.utils.config.resolve_device`:
    a CUDA device with no card raises).

    ``sizes`` default to :func:`factor_mesh`'s; missing axes get 1, and a
    product other than ``n_devices`` raises ``ValueError``, as in the
    reference. More than one rank needs a process group of exactly that
    many ranks (:func:`~tpurpc_torch.parallel.distributed.initialize_cluster`)
    and raises ``ValueError`` without one; every rank calls this with the
    same arguments.
    """
    n = n_devices or 1
    sizes = dict(sizes) if sizes else factor_mesh(n)
    for a in AXES:
        sizes.setdefault(a, 1)
    shape = tuple(sizes[a] for a in AXES)
    if math.prod(shape) != n:
        raise ValueError(f"mesh sizes {sizes} != {n} devices")
    if n == 1:
        return Mesh.of(sizes, resolve_device(device))
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"build_mesh({n}) needs a process group of {n} ranks, and this "
            f"process is in one of {world}: call initialize_cluster() first "
            "(tpurpc_torch.parallel.distributed)")
    rank = dist.get_rank()
    return Mesh(shape, resolve_device(device), rank,
                _make_groups(shape, rank))


def axis_size(mesh: Mesh, axis: AxisSpec) -> int:
    """The ranks along ``axis``; for a tuple, the product of its sizes."""
    return math.prod(mesh.sizes[a] for a in axes_of(axis))


def shard(mesh: Mesh, x: torch.Tensor, *spec) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under a partition spec:
    entry i of ``spec`` names the axis (or tuple of axes, the first major)
    that dimension i is split over, or None; missing entries are None.
    A dimension must divide evenly (``ValueError`` otherwise)."""
    coords = mesh.coords
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = axes_of(entry)
        n = axis_size(mesh, names)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split {n} ways over {names}")
        idx = 0
        for a in names:
            idx = idx * mesh.sizes[a] + coords[a]
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The spec of no axes: every rank holds the whole of ``x``."""
    return shard(mesh, x)
