"""Pipeline parallelism: GPipe-style microbatch ring over the 'pp' axis.

The port of ``tpurpc/parallel/pipeline.py``. Stage s holds its slice of the
layers; activations hop stage → stage
(:func:`~tpurpc_torch.parallel.collectives.shift`) while M + P − 1 ticks walk
M microbatches through P stages. Every stage runs its compute every tick, as
in the reference (the bubble burns compute instead of branching on data),
and the last stage's outputs are summed over 'pp' so every stage holds them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tpurpc_torch.parallel.collectives import axis_index, psum, shift
from tpurpc_torch.parallel.mesh import Mesh, axis_size


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, mesh: Mesh,
                   axis: str = "pp") -> torch.Tensor:
    """Run microbatches x_micro [M, mb, ...] through the stage ring.

    ``stage_fn(params, h) -> h'`` is one stage's compute and must keep h's
    shape and dtype (checked on the first call, ``ValueError`` otherwise).
    Returns the [M, mb, ...] outputs of the last stage.
    """
    P = axis_size(mesh, axis)
    stage = axis_index(mesh, axis)
    M = x_micro.shape[0]
    want = (tuple(x_micro.shape[1:]), x_micro.dtype)
    if P > 1:
        first, last = (torch.tensor(c, device=x_micro.device)
                       for c in (stage == 0, stage == P - 1))

    recv = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(M + P - 1):
        xm = x_micro[min(t, M - 1)]
        # a mask, not a branch: every stage's autograd graph has the same
        # shape, so their backward collectives pair up
        h = xm if P == 1 else torch.where(first, xm, recv)
        y = stage_fn(stage_params, h)
        if t == 0 and (tuple(y.shape), y.dtype) != want:
            raise ValueError(
                "pipeline stages must preserve activation shape/dtype "
                f"({want[0]}/{_dtype_name(want[1])} -> "
                f"{tuple(y.shape)}/{_dtype_name(y.dtype)})")
        (recv,) = shift(mesh, axis, y)
        # the last stage commits microbatch t - (P - 1) when it is in range
        if t >= P - 1:
            outs.append(y)
    out = torch.stack(outs)
    if P == 1:
        return out
    # every stage but the last contributes zeros
    return psum(torch.where(last, out, torch.zeros_like(out)), mesh, axis)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]; B must divide evenly."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    return x.reshape(n_micro, B // n_micro, *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
