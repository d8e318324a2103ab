"""Ring attention: exact attention with the sequence sharded over 'sp'.

The port of ``tpurpc/parallel/ring_attention.py``. Each rank holds one
sequence block of Q, K and V. K/V blocks rotate around the 'sp' ring
(:func:`~tpurpc_torch.parallel.collectives.shift`) while a flash-style
accumulator (running row max, rescaled numerator and denominator, all
float32) folds in one block per step, so after ``sp`` steps every Q block
has attended to the whole sequence and no rank holds the (S, S) scores of
more than one block pair.

The reference computes this in XLA ops, not in a Pallas kernel; the port
computes the same arithmetic in torch ops (``einsum``, ``where``), step for
step, NaN and ``-inf`` guards included, so that a NaN input spreads as it
does in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpurpc_torch.parallel.collectives import axis_index, shift
from tpurpc_torch.parallel.mesh import Mesh, axis_size

_NEG_INF = float("-inf")


def ring_attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: Mesh, axis: str = "sp", causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """This rank's blocks q, k, v: [B, H, S_blk, D] → its output block
    [B, H, S_blk, D] in ``q.dtype``; softmax statistics accumulate in
    float32 whatever the input dtype."""
    sp = axis_size(mesh, axis)
    idx = axis_index(mesh, axis)
    B, H, S, D = q.shape
    if scale is None:
        scale = D ** -0.5
    qf = q.float() * scale
    pos = torch.arange(S, device=q.device)

    m = torch.full((B, H, S), _NEG_INF, dtype=torch.float32, device=q.device)
    num = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(sp):
        # the block we now hold was first owned by rank (idx - s) mod sp
        src = (idx - s) % sp
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float())
        if causal:
            q_pos = idx * S + pos[:, None]          # [S,1] global q
            k_pos = src * S + pos[None, :]          # [1,S] global k
            scores = torch.where(k_pos > q_pos, _NEG_INF, scores)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # rescale the old accumulators; exp(-inf - -inf) guarded by where
        alpha = torch.exp(torch.where(torch.isneginf(m), _NEG_INF, m - m_new))
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(torch.isneginf(scores), 0.0, p)
        num = num * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, v_cur.float())
        den = den * alpha + p.sum(dim=-1)
        m = m_new
        k_cur, v_cur = shift(mesh, axis, k_cur, v_cur)
    # fully-masked rows cannot happen for causal attention; keep them finite
    out = num / torch.maximum(den, den.new_tensor(1e-30))[..., None]
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, causal: bool = False,
                   axis: str = "sp") -> torch.Tensor:
    """Whole-array form: q, k, v [B, H, S, D] with S split over ``axis``.
    On a one-rank mesh the whole array is this rank's block."""
    return ring_attention_block(q, k, v, mesh, axis=axis, causal=causal)
