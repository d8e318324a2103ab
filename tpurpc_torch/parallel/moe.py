"""Expert parallelism: switch-style top-1 MoE with all_to_all dispatch.

The port of ``tpurpc/parallel/moe.py``. Tokens are routed top-1 by a
float32 router softmax, packed into per-expert capacity slots by the cumsum
position trick (dense one-hot dispatch, no data-dependent shapes), exchanged
with two all_to_alls over 'ep' (dispatch and return), run through their
expert's FFN and combined, weighted by the router's gate. A token past its
expert's capacity is dropped: its output row is 0.

Two points where torch's defaults differ from JAX's:

* ``jax.nn.gelu`` is the tanh approximation by default; the port asks for
  it (``approximate="tanh"``).
* one-hot codes are built by comparison, as ``jax.nn.one_hot`` does:
  ``F.one_hot`` checks its indices' range on the host, which on a card
  waits for the device.

``torch.argmax`` returns the first of tied maxima, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from tpurpc_torch.parallel.collectives import all_to_all, pmean
from tpurpc_torch.parallel.mesh import Mesh, axis_size
from tpurpc_torch.utils.config import resolve_device


class MoEParams(NamedTuple):
    router: torch.Tensor   # [d_model, n_experts]
    w_in: torch.Tensor     # [local experts, d_model, d_ff]
    w_out: torch.Tensor    # [local experts, d_ff, d_model]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype: torch.dtype = torch.float32,
             device=None) -> MoEParams:
    """Global-view parameters at the reference's scales, drawn on the CPU
    from ``generator`` (so a seed gives the same weights on every device)
    and moved to ``device`` (resolved by ``resolve_device``)."""
    device = resolve_device(device)
    s = d_model ** -0.5

    def normal(*shape, scale):
        x = torch.randn(shape, generator=generator) * scale
        return x.to(dtype).to(device)

    return MoEParams(router=normal(d_model, n_experts, scale=s),
                     w_in=normal(n_experts, d_model, d_ff, scale=s),
                     w_out=normal(n_experts, d_ff, d_model,
                                  scale=d_ff ** -0.5))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def capacity(capacity_factor: float, tokens: int, experts: int) -> int:
    """Slots per expert, in the reference's Python float arithmetic."""
    return max(1, int(capacity_factor * tokens / experts))


def moe_block(params: MoEParams, x: torch.Tensor, mesh: Mesh,
              axis: str = "ep", capacity_factor: float = 2.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's tokens x [T, d] → (y [T, d] in ``x.dtype``, aux loss).

    ``params.w_in``/``w_out`` are this rank's expert slice [E_loc, d, f];
    the router is replicated. The aux loss is the switch load-balance term
    (mean fraction × mean router probability per expert, times E).
    """
    ep = axis_size(mesh, axis)
    T, d = x.shape
    e_loc = params.w_in.shape[0]
    E = ep * e_loc
    cap = capacity(capacity_factor, T, E)

    xf = x.float()
    logits = torch.einsum("td,de->te", xf, params.router.float())
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                       # [T]
    gate = probs.amax(dim=-1)                                  # [T]
    onehot = _one_hot(expert, E)                               # [T, E]

    frac = pmean(onehot.mean(dim=0), mesh, axis)
    mean_prob = pmean(probs.mean(dim=0), mesh, axis)
    aux = (frac * mean_prob).sum() * E

    # position of each token within its expert's capacity
    pos = torch.cumsum(onehot, dim=0) - 1.0                    # [T, E]
    keep = (pos < cap).float() * onehot
    slot = _one_hot(pos.clamp(0, cap - 1).long(), cap)         # [T, E, C]
    dispatch = slot * keep[..., None]                          # [T, E, C]
    combine = dispatch * gate[:, None, None]

    packed = torch.einsum("tec,td->ecd", dispatch, xf)
    recv = all_to_all(packed.reshape(ep, e_loc, cap, d), mesh, axis)
    h = torch.einsum("secd,edf->secf", recv, params.w_in.float())
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("secf,efd->secd", h, params.w_out.float())
    back = all_to_all(y, mesh, axis)                    # [ep, e_loc, C, d]
    out = torch.einsum("tec,ecd->td", combine, back.reshape(E, cap, d))
    return out.to(x.dtype), aux.float()
