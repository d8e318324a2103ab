"""Decoder-only MoE transformer over the five-axis mesh: the serving half.

The port of ``tpurpc/models/transformer.py``'s forward. One program runs
every parallelism family of the mesh — microbatches through the 'pp'
pipeline, ring attention over 'sp', heads over 'tp' with one psum per
block, switch MoE over 'ep' — here on a one-rank mesh, where each
collective is the identity (:mod:`tpurpc_torch.parallel.collectives`).

The parameters are the reference's dict entries under the same names, the
per-layer ones stacked on a leading layer axis, in the config's dtype.
Einsums run in that dtype; attention statistics, the router, the experts'
FFN, layer-norm statistics and the logits run in float32, as in the
reference.

The embedding gather follows ``jnp.take(embed, tokens, axis=0)``: a negative
token wraps once (−1 is the last row), and a token still outside
[0, vocab) gives a row of NaN. Indexing a CUDA tensor out of range would
instead fire a device-side assert and leave the process's CUDA context
unusable for every later request, so the port normalizes, clamps and masks.
A NaN row spreads as it does in the reference: through attention to its
whole sequence, and through the MoE's dense dispatch to its microbatch.

:func:`from_jax` carries the reference's ``init_params`` output across as
numpy arrays (bfloat16 ones included). The reference's training half (loss,
train step) and its sharding specs are not ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from tpurpc_torch.parallel.collectives import psum
from tpurpc_torch.parallel.mesh import Mesh, axis_size, build_mesh
from tpurpc_torch.parallel.moe import MoEParams, moe_block
from tpurpc_torch.parallel.pipeline import (microbatch, pipeline_apply,
                                            unmicrobatch)
from tpurpc_torch.parallel.ring_attention import ring_attention_block
from tpurpc_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    head_dim: int = 16
    d_ff: int = 256
    n_layers: int = 4
    n_experts: int = 2
    capacity_factor: float = 2.0
    n_micro: int = 2          # pipeline microbatches (must divide the batch)
    dtype: torch.dtype = torch.float32

    def validate(self, mesh: Mesh) -> None:
        """The reference's three divisibility checks against ``mesh``."""
        for ok, msg in ((self.n_heads % axis_size(mesh, "tp") == 0,
                         "heads % tp != 0"),
                        (self.n_experts % axis_size(mesh, "ep") == 0,
                         "experts % ep != 0"),
                        (self.n_layers % axis_size(mesh, "pp") == 0,
                         "layers % pp != 0")):
            if not ok:
                raise ValueError(f"{msg} (mesh {mesh.sizes})")


#: per-layer parameters, stacked on a leading layer axis
LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router", "w_in",
              "w_out")


def param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    L, d, H, Dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim
    E, f, V = cfg.n_experts, cfg.d_ff, cfg.vocab
    return {"embed": (V, d), "ln_f": (d,), "ln1": (L, d), "ln2": (L, d),
            "wq": (L, d, H, Dh), "wk": (L, d, H, Dh), "wv": (L, d, H, Dh),
            "wo": (L, H, Dh, d), "router": (L, d, E), "w_in": (L, E, d, f),
            "w_out": (L, E, f, d)}


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """The reference's initialization: the same shapes and scales (normal ×
    d^-0.5; ``wo`` × (H·Dh)^-0.5; ``w_out`` × d_ff^-0.5; layer norms 1),
    cast to ``cfg.dtype``. Drawn on the CPU from ``generator`` (torch's
    default when None), so one seed gives the same weights on every device,
    then moved to ``device`` (resolved by ``resolve_device``). JAX's PRNG is
    not reproduced: :func:`from_jax` carries the reference's weights."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    d, H, Dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    scales = {"embed": d ** -0.5, "wq": d ** -0.5, "wk": d ** -0.5,
              "wv": d ** -0.5, "wo": (H * Dh) ** -0.5, "router": d ** -0.5,
              "w_in": d ** -0.5, "w_out": f ** -0.5}
    out = {}
    for name, shape in shapes.items():
        if name in scales:
            x = torch.randn(shape, generator=generator) * scales[name]
        else:
            x = torch.ones(shape)
        out[name] = x.to(cfg.dtype).to(device)
    return out


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)``: negatives wrap once, indices
    left outside [0, V) give NaN rows; no index reaches the device out of
    range."""
    V = table.shape[0]
    idx = tokens.long()
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    rows = table[idx.clamp(0, V - 1)]
    return torch.where(valid[..., None], rows, float("nan"))


def _layer_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Scale-only layer norm, float32 statistics, eps 1e-6, cast back."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


def _block(lp: Dict[str, torch.Tensor], h: torch.Tensor,
           cfg: TransformerConfig, mesh: Mesh) -> torch.Tensor:
    """One transformer block on this rank's shards. h: [b, s, d]."""
    # attention: heads over tp, the sp ring over the sequence
    x = _layer_norm(h, lp["ln1"])
    q = torch.einsum("bsd,dhk->bhsk", x, lp["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, lp["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, lp["wv"])
    o = ring_attention_block(q, k, v, mesh, axis="sp", causal=True)
    attn = psum(torch.einsum("bhsk,hkd->bsd", o, lp["wo"]), mesh, "tp")
    h = h + attn
    # MoE FFN over ep
    x = _layer_norm(h, lp["ln2"])
    b, s, d = x.shape
    moe = MoEParams(router=lp["router"], w_in=lp["w_in"], w_out=lp["w_out"])
    y, _aux = moe_block(moe, x.reshape(b * s, d), mesh, axis="ep",
                        capacity_factor=cfg.capacity_factor)
    return h + y.reshape(b, s, d)


class Transformer(nn.Module):
    """The reference's ``build_forward`` on a one-rank mesh:
    tokens int [B, S] → float32 logits [B, S, vocab].

    ``mesh`` defaults to ``build_mesh(1)`` on the configured device (a CUDA
    device with no card raises). The parameters come from
    :func:`init_params` with ``generator``; load :func:`from_jax`'s state
    dict to run the reference's weights. B must divide into
    ``cfg.n_micro`` microbatches.
    """

    def __init__(self, cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mesh = mesh if mesh is not None else build_mesh(1)
        cfg.validate(mesh)
        self.cfg = cfg
        self.mesh = mesh
        for name, t in init_params(cfg, generator, mesh.device).items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        h = _embed(self.embed, tokens)                      # [b, s, d]
        stage_params = {k: getattr(self, k) for k in LAYER_KEYS}

        def stage_fn(params, hm):
            for layer in range(params["ln1"].shape[0]):
                hm = _block({k: v[layer] for k, v in params.items()}, hm,
                            cfg, mesh)
            return hm

        hm = pipeline_apply(stage_fn, stage_params,
                            microbatch(h, cfg.n_micro), mesh, axis="pp")
        h = _layer_norm(unmicrobatch(hm), self.ln_f)
        return torch.einsum("bsd,vd->bsv", h.float(), self.embed.float())


def make_serve_fn(model: Transformer) -> Callable[[Any], Dict[str, Any]]:
    """The serving handler: ``{"tokens": int32 [B, S]}`` →
    ``{"logits": float32 [B, S, vocab]}`` under ``torch.inference_mode``."""
    model.eval()
    device = model.mesh.device

    def serve(tree):
        with torch.inference_mode():
            tokens = torch.as_tensor(tree["tokens"]).to(device, torch.int32)
            return {"logits": model(tokens)}

    return serve


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's ``init_params`` output, as numpy arrays, →
    :class:`Transformer`'s state dict (same names, shapes and dtypes; the
    values bit for bit)."""
    return {name: _tensor(a) for name, a in params.items()}
