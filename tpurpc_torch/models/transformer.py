"""Decoder-only MoE transformer over the five-axis mesh: serving and
training.

The port of ``tpurpc/models/transformer.py``. One program runs every
parallelism family of the mesh — microbatches through the 'pp' pipeline,
ring attention over 'sp', heads over 'tp' with one psum per block, switch
MoE over 'ep', the batch over ('dp', 'ep') — with its collectives over
``torch.distributed`` (:mod:`tpurpc_torch.parallel.collectives`); on a
one-rank mesh each collective is the identity.

The parameters are the reference's dict entries under the same names, the
per-layer ones stacked on a leading layer axis, in the config's dtype. A
:class:`Transformer` on a mesh holds this rank's shards of them
(:func:`param_specs`, :func:`shard_params`) and takes this rank's block of
the tokens (:data:`DATA_SPEC`). Einsums run in the parameters' dtype;
attention statistics, the router, the experts' FFN, layer-norm statistics,
the logits and the loss run in float32, as in the reference.

Training (:func:`build_train_step`) is ``optax.adamw``'s step with
``torch.optim.AdamW``: the loss's gradient follows ``shard_map``'s
transpose, so every gradient, gathered from its shards, is the one-rank
gradient.

The embedding gather follows ``jnp.take(embed, tokens, axis=0)``: a negative
token wraps once (−1 is the last row), and a token still outside
[0, vocab) gives a row of NaN. Indexing a CUDA tensor out of range would
instead fire a device-side assert and leave the process's CUDA context
unusable for every later request, so the port normalizes, clamps and masks.
A NaN row spreads as it does in the reference: through attention to its
whole sequence, and through the MoE's dense dispatch to its microbatch.

:func:`from_jax` carries the reference's ``init_params`` output across as
numpy arrays (bfloat16 ones included).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tpurpc_torch.parallel.collectives import pmean, psum
from tpurpc_torch.parallel.mesh import (AXES, Mesh, axes_of, axis_size,
                                        build_mesh, shard)
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


#: how each parameter is split over the mesh, one entry per dimension (the
#: reference's ``PartitionSpec``s): layers over 'pp', heads over 'tp',
#: experts over 'ep'; the rest replicated
_SPECS = {
    "embed": (None, None),
    "ln_f": (None,),
    "ln1": ("pp", None),
    "ln2": ("pp", None),
    "wq": ("pp", None, "tp", None),
    "wk": ("pp", None, "tp", None),
    "wv": ("pp", None, "tp", None),
    "wo": ("pp", "tp", None, None),
    "router": ("pp", None, None),
    "w_in": ("pp", "ep", None, None),
    "w_out": ("pp", "ep", None, None),
}

#: tokens [B, S]: the batch over ('dp', 'ep'), dp major, the sequence over
#: 'sp' (the MoE's all_to_all then moves distinct tokens between ep ranks)
DATA_SPEC = (("dp", "ep"), "sp")
#: the axes the loss is averaged over: those that split the tokens
LOSS_AXES = ("dp", "ep", "sp")


def param_specs(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Each parameter's spec (see :func:`~tpurpc_torch.parallel.mesh.shard`);
    the same for every config, as in the reference."""
    return dict(_SPECS)


def shard_params(params: Dict[str, torch.Tensor], cfg: TransformerConfig,
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shards of the global parameters (``param_specs``); on a
    one-rank mesh the parameters themselves."""
    out = {}
    for name, spec in param_specs(cfg).items():
        t = shard(mesh, params[name], *spec)
        out[name] = t if t.shape == params[name].shape else t.clone()
    return out


def _replicated_axes(spec: tuple) -> Tuple[str, ...]:
    named = {a for entry in spec if entry is not None
             for a in axes_of(entry)}
    return tuple(a for a in AXES if a not in named)


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
    """The reference's ``_forward_local``: this rank's tokens int
    [b, s] → its float32 logits [b, s, vocab].

    ``mesh`` defaults to ``build_mesh(1)`` on the configured device (a CUDA
    device with no card raises); on one rank the tokens are the whole batch.
    The parameters are trainable, this rank's shards of :func:`init_params`
    with ``generator`` (the same seed on every rank gives one global set);
    load ``from_jax(params, mesh)`` to run the reference's weights. b must
    divide into ``cfg.n_micro`` microbatches.
    """

    def __init__(self, cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mesh = mesh if mesh is not None else build_mesh(1)
        cfg.validate(mesh)
        self.cfg = cfg
        self.mesh = mesh
        params = init_params(cfg, generator, mesh.device)
        for name, t in shard_params(params, cfg, mesh).items():
            self.register_parameter(name, nn.Parameter(t))

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


def _loss_local(model: Transformer, tokens: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of this rank's block (log-softmax of the float32
    logits, NLL by gather), averaged over ``LOSS_AXES``."""
    logp = torch.log_softmax(model(tokens), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return pmean(nll.mean(), model.mesh, LOSS_AXES)


def _shard_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global [B, S, ...] tensor (``DATA_SPEC``)."""
    return shard(mesh, x, *DATA_SPEC)


def build_loss_fn(cfg: TransformerConfig, mesh: Mesh):
    """``loss(model, tokens, targets)`` on the global int [B, S] tokens and
    targets: each rank takes its block, and every rank returns the loss
    over the whole batch (a float32 scalar)."""
    cfg.validate(mesh)

    def loss(model, tokens, targets):
        return _loss_local(model, _shard_data(mesh, tokens),
                           _shard_data(mesh, targets))

    return loss


def build_forward(cfg: TransformerConfig, mesh: Mesh):
    """``forward(model, tokens)`` on the global int [B, S] tokens → this
    rank's logits block in ``DATA_SPEC``'s layout [B/(dp·ep), S/sp,
    vocab] (on one rank, all of them)."""
    cfg.validate(mesh)

    def forward(model, tokens):
        return model(_shard_data(mesh, tokens))

    return forward


def _sum_replicated_grads(model: Transformer) -> None:
    """``shard_map``'s transpose: a parameter replicated over some axes has
    its gradient summed over them."""
    import torch.distributed as dist

    for name, p in model.named_parameters():
        group = model.mesh.group(_replicated_axes(_SPECS[name]))
        if group is not None:
            dist.all_reduce(p.grad, group=group)


def backward(model: Transformer, loss: torch.Tensor) -> None:
    """The gradient of a :func:`build_loss_fn` loss, as ``jax.grad`` of the
    reference's ``shard_map`` gives it: added to each parameter's
    ``.grad``, this rank's shard of the one-rank gradient."""
    # the loss is replicated over every rank: its cotangent is shared out
    # among them, and the psums of the backward add it up again
    loss.backward(torch.full_like(loss, 1.0 / model.mesh.size))
    _sum_replicated_grads(model)


def value_and_grad(loss_fn, model: Transformer, tokens: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """``jax.value_and_grad`` of a :func:`build_loss_fn` loss: returns the
    loss and adds its gradient to the parameters' ``.grad``
    (:func:`backward`)."""
    loss = loss_fn(model, tokens, targets)
    backward(model, loss)
    return loss.detach()


def build_train_step(cfg: TransformerConfig, mesh: Mesh, lr: float = 1e-3):
    """The reference's training step with ``optax.adamw(lr)``'s defaults.

    Returns ``(step, make_optimizer)``: ``make_optimizer(model)`` is
    ``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
    weight_decay=1e-4)`` over every parameter (optax masks none), its state
    beside each rank's shards; ``step(model, optimizer, tokens, targets)``
    takes the global tokens and targets, updates the model in place and
    returns the loss before the update.
    """
    cfg.validate(mesh)
    loss_fn = build_loss_fn(cfg, mesh)

    def make_optimizer(model):
        return torch.optim.AdamW(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    def step(model, optimizer, tokens, targets):
        optimizer.zero_grad()
        loss = value_and_grad(loss_fn, model, tokens, targets)
        optimizer.step()
        return loss

    return step, make_optimizer


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


def from_jax(params: Dict[str, Any],
             mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The reference's ``init_params`` output, as numpy arrays, →
    :class:`Transformer`'s state dict (same names, dtypes and values bit
    for bit): the global parameters, or with ``mesh`` this rank's shards of
    them (:func:`shard_params`)."""
    sd = {name: _tensor(a) for name, a in params.items()}
    return sd if mesh is None else shard_params(sd, None, mesh)
