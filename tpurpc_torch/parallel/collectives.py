"""The collectives of the parallel modules, over ``torch.distributed``.

The reference's ``lax.ppermute``, ``lax.psum``, ``lax.pmean``,
``lax.all_to_all`` and ``lax.axis_index`` over a named mesh axis (or a tuple
of axes), each over the mesh's process group for that axis
(:meth:`~tpurpc_torch.parallel.mesh.Mesh.group`). Over an axis of size 1
each is the identity (the axis index is 0) and calls nothing of
``torch.distributed``, which is what XLA computes there.

Autodiff follows ``shard_map``'s transpose (``check_rep=False``), so that
the reference's per-rank programs differentiate as written:

* a value replicated over an axis carries a partial cotangent on each rank,
  whose sum over the axis is the true one. ``psum`` transposes to ``psum``;
  the caller seeds a loss that is replicated over n ranks with 1/n
  (:func:`tpurpc_torch.models.transformer.build_train_step`), and sums the
  gradient of a parameter over the axes it is replicated on;
* ``shift``'s transpose is the shift the other way, and ``all_to_all`` is
  its own.

Every rank must run the same sequence of collectives, backward included, so
the callers keep each rank's autograd graph the same shape: a rank-dependent
choice is a ``torch.where`` on a mask, never a Python branch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpurpc_torch.parallel.mesh import AxisSpec, Mesh, axes_of, axis_size


def axis_index(mesh: Mesh, axis: AxisSpec) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``); over a
    tuple, its linear index with the first axis major."""
    if mesh.group(axis) is None:
        return 0
    coords, idx = mesh.coords, 0
    for a in axes_of(axis):
        idx = idx * mesh.sizes[a] + coords[a]
    return idx


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x, group=group)
    return y


def _ring(xs, group, step: int):
    """Each of ``xs`` to the rank ``step`` further along the group's ring,
    and from the rank ``step`` before it: one batch of sends and receives."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    outs, ops = [], []
    for x in xs:
        x = x.contiguous()
        out = torch.empty_like(x)
        ops += [dist.P2POp(dist.isend, x, dst, group),
                dist.P2POp(dist.irecv, out, src, group)]
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(outs)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return _ring(xs, group, 1)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_ring(gs, ctx.group, -1))


def shift(mesh: Mesh, axis: str,
          *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Ring shift by +1 (``lax.ppermute`` with ``[(i, (i + 1) % n)]``):
    rank i's tensors go to rank i + 1. Ring attention rotates K/V with it,
    the pipeline hands activations to the next stage."""
    group = mesh.group(axis)
    if group is None:
        return xs
    return _Shift.apply(group, *xs)


def psum(x: torch.Tensor, mesh: Mesh, axis: AxisSpec) -> torch.Tensor:
    """Sum over the ranks of ``axis`` (``lax.psum``)."""
    group = mesh.group(axis)
    return x if group is None else _Psum.apply(x, group)


def pmean(x: torch.Tensor, mesh: Mesh, axis: AxisSpec) -> torch.Tensor:
    """Mean over the ranks of ``axis`` (``lax.pmean``)."""
    group = mesh.group(axis)
    return x if group is None else _Psum.apply(x, group) / axis_size(
        mesh, axis)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=True)``:
    block j of the leading axis goes to rank j, and the blocks received are
    stacked in the order of the ranks that sent them."""
    group = mesh.group(axis)
    return x if group is None else _AllToAll.apply(x, group)
