"""Worker builds for the port's sharded-serving tests.

A shard worker starts by spawn and imports its ``build`` by module and
name, so every build the tests hand to ``ShardedServer`` or
``serve_torch_sharded`` lives here, at module level (tests/ is on the
worker's ``sys.path``: spawn passes the parent's). This module imports the
port, torch and numpy only, never JAX. Each build first lowers its worker's
priority, as ``torch_ranks``' ranks do, so that a fleet never starves the
suite's deadline-bound loopback tests.
"""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import torch

from torch_ranks import RANK_NICE
from tpurpc_torch.ops import ring_scatter as rs_mod
from tpurpc_torch.ops import ring_window as rw_mod
from tpurpc_torch.rpc.health import add_health_servicer
from tpurpc_torch.rpc.server import Server, unary_unary_rpc_method_handler
from tpurpc_torch.rpc.shard import shard_identity, shard_peers
from tpurpc_torch.torchshim.service import add_tensor_method

#: the stats method every build registers: JSON of the worker's identity
STATS = "/t.S/Stats"
#: calls of the kernels' plain versions in this worker (the CPU path)
plain_calls = {"ring_scatter": 0, "ring_window": 0}


def _stats_handler(req, ctx) -> bytes:
    shard_id, n_shards = shard_identity()
    return json.dumps({
        "pid": os.getpid(), "shard": shard_id, "n_shards": n_shards,
        "peers": shard_peers(), "jax": "jax" in sys.modules,
        "ring_buffer_size_kb": os.environ.get("TPURPC_RING_BUFFER_SIZE_KB"),
        "launches": {"ring_scatter": rs_mod.launches,
                     "ring_window": rw_mod.launches},
        "plain": dict(plain_calls),
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "cpu")}).encode()


def _base(max_workers: int = 8) -> Server:
    os.nice(RANK_NICE)
    srv = Server(max_workers=max_workers)
    srv.add_method(STATS, unary_unary_rpc_method_handler(_stats_handler))
    return srv


#: /t.S/Hold parks until /t.S/Release sets this (bounded by the request)
_release = threading.Event()


def who(shard_id: int) -> Server:
    """/t.S/Who answers the serving shard's id; /t.S/Hold parks until a
    /t.S/Release reaches the same worker (at most the request's seconds);
    the health service is attached."""
    srv = _base()
    srv.add_method("/t.S/Who", unary_unary_rpc_method_handler(
        lambda req, ctx: str(shard_id).encode()))

    def hold(req, ctx):
        _release.wait(float(bytes(req).decode()))
        return str(shard_id).encode()

    def release(req, ctx):
        _release.set()
        return b""

    srv.add_method("/t.S/Hold", unary_unary_rpc_method_handler(hold))
    srv.add_method("/t.S/Release", unary_unary_rpc_method_handler(release))
    add_health_servicer(srv)
    return srv


def broken(shard_id: int) -> Server:
    """A build that fails, as one without a card would."""
    raise RuntimeError("no card here")


def affine(tree):
    """The device-ring fleet's model: ``{"y": 2 x + 1}``."""
    return {"y": tree["x"] * 2.0 + 1.0}


def _counting(name, fn):
    def wrapped(*a, **kw):
        plain_calls[name] += 1
        return fn(*a, **kw)
    return wrapped


def ring(shard_id: int) -> Server:
    """:func:`affine` behind ``add_tensor_method(device=True)`` as "Call":
    on the ``TPU`` platform requests land in the connection's device ring.
    On the CPU the kernels' plain versions are counted."""
    if rs_mod.ring_scatter_plain.__name__ != "wrapped":
        rs_mod.ring_scatter_plain = _counting("ring_scatter",
                                              rs_mod.ring_scatter_plain)
        rw_mod.ring_window_plain = _counting("ring_window",
                                             rw_mod.ring_window_plain)
    srv = _base(max_workers=4)
    add_tensor_method(srv, "Call", affine, device=True)
    return srv


def transformer_fn(npz: str, cfg_json: str):
    """``serve_torch_sharded``'s build_fn for the transformer fleet: the
    port's model on the CPU from the reference's parameters (``from_jax``
    of the arrays in ``npz``). A batch is padded with zero rows to a
    multiple of ``n_micro`` (the batcher's power-of-two buckets start at
    1) and the reply cut back to the batch's rows."""
    from tpurpc_torch.models import transformer as ttfm
    from tpurpc_torch.parallel import build_mesh

    os.nice(RANK_NICE)
    cfg = ttfm.TransformerConfig(**json.loads(cfg_json))
    model = ttfm.Transformer(cfg, build_mesh(1, device="cpu"))
    with np.load(npz) as arrays:
        model.load_state_dict(ttfm.from_jax(dict(arrays)))
    serve = ttfm.make_serve_fn(model)
    return _padded(serve, cfg.n_micro)


def pad_rows(tokens: torch.Tensor, multiple: int) -> torch.Tensor:
    """``tokens`` with zero rows appended up to a multiple of ``multiple``."""
    b = tokens.shape[0]
    extra = -b % multiple
    if not extra:
        return tokens
    return torch.cat([tokens, tokens.new_zeros((extra,) + tokens.shape[1:])])


def _padded(serve, multiple: int):
    def fn(tree):
        tokens = torch.as_tensor(tree["tokens"])
        out = serve({"tokens": pad_rows(tokens, multiple)})
        return {"logits": out["logits"][:tokens.shape[0]]}
    return fn
