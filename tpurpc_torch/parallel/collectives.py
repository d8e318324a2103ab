"""The collectives of the parallel modules, on a one-rank mesh.

The reference's ``lax.ppermute``, ``lax.psum``, ``lax.pmean``,
``lax.all_to_all`` and ``lax.axis_index`` over a named mesh axis. Over an
axis of size 1 each is the identity (the axis index is 0), which is what XLA
computes for them there. Over a larger axis each raises
``NotImplementedError``: those need ``torch.distributed`` process groups
(ROADMAP A6), and this module is the one place A6 changes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpurpc_torch.parallel.mesh import MULTI_RANK, Mesh, axis_size


def _one_rank(mesh: Mesh, axis: str, op: str) -> None:
    n = axis_size(mesh, axis)
    if n != 1:
        raise NotImplementedError(f"{op} over mesh axis {axis!r} of size "
                                  f"{n}: {MULTI_RANK}")


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    _one_rank(mesh, axis, "axis_index")
    return 0


def shift(mesh: Mesh, axis: str,
          *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Ring shift by +1 (``lax.ppermute`` with ``[(i, (i + 1) % n)]``):
    rank i's tensors go to rank i + 1. Ring attention rotates K/V with it,
    the pipeline hands activations to the next stage."""
    _one_rank(mesh, axis, "shift")
    return xs


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over the ranks of ``axis`` (``lax.psum``)."""
    _one_rank(mesh, axis, "psum")
    return x


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Mean over the ranks of ``axis`` (``lax.pmean``)."""
    _one_rank(mesh, axis, "pmean")
    return x


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=True)``:
    block j of the leading axis goes to rank j, and the blocks received are
    stacked in the order of the ranks that sent them."""
    _one_rank(mesh, axis, "all_to_all")
    return x
