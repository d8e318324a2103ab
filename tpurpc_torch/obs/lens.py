"""Byte-flow waterfall: per-hop byte and busy-nanosecond attribution.

A copy of ``tpurpc/obs/lens.py``. Every hop of the data path carries a
pair of always-on registry counters, bytes moved and busy nanoseconds, and
the scrape-time division ``bytes / busy_ns`` is that hop's effective GB/s
(B/ns is GB/s). Under load the hop with the lowest effective rate is the
one to attack (:func:`slowest_hop`). A third counter per hop,
``copy_bytes``, folds the copy ledger in: a hop that is fast because it
aliases reads differently from one that is fast while copying.

The hops, in data-flow order (:data:`HOPS`): ``device`` (codec encode),
``send_ring`` (ring writer placement), ``wire`` (transport boundary),
``rendezvous`` (one-sided bulk write), ``ctrl`` (control plane), the three
``native_*`` hops of the C core, ``peer_ring`` (ring reader drain),
``decode`` (codec parse), ``hbm`` (device-ring landing) and ``jax_array``
(materialization as a device tensor; the reference's name, kept so both
packages' tables line up). Hops may nest, so the table is a waterfall of
per-hop rates, not a partition of wall time.

The counters are branch-free and always live; ``TPURPC_LENS=0`` turns
off the sampling profiler (:mod:`tpurpc_torch.obs.profiler`).

Left out: folding the C core's table into the native hops (the reference's
``obs/native_obs.py``, which ROADMAP A7 (b) brings). The transport's hop
hooks come with ROADMAP A4 (b); until then only callers bump them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from tpurpc_torch.obs import metrics as _metrics

__all__ = [
    "HOPS", "HOP_NAMES", "hop_counters", "enabled", "waterfall",
    "render_text", "slowest_hop",
]

#: the declared hop registry, in data-flow order: (name, accounting site /
#: what the hop means). Append-only — names land in scrape output and
#: bench artifacts.
HOPS: Tuple[Tuple[str, str], ...] = (
    ("device", "serialize: tensor bytes gathered into wire form "
               "(codec encode, the device→host leg)"),
    ("send_ring", "RingWriter placement into the peer's receive ring"),
    ("wire", "transport boundary: pair one-sided send / TCP socket write"),
    ("rendezvous", "one-sided bulk payload write into the peer-advertised "
                   "landing region"),
    ("ctrl", "control-plane work: descriptor-ring posts/drains and framed "
             "rendezvous control sends"),
    ("native_send", "native-plane rdv placement: the one-sided memcpy "
                    "into the peer-advertised landing region (tpr_rdv.cc)"),
    ("native_recv", "native-plane delivery: completed landing regions "
                    "handed to the stream layer (tpr_rdv.cc deliver)"),
    ("native_rdv", "native-plane claim wait: solicited offer -> claim "
                   "grant round trip (tpr_rdv.cc rdv_claim)"),
    ("peer_ring", "RingReader drain out of the local receive ring"),
    ("decode", "codec parse of wire bytes back into tensors"),
    ("hbm", "placement into the device-resident HBM landing ring"),
    ("jax_array", "materialization as a device tensor (dlpack alias or "
                  "staging copy; the reference's name)"),
)

HOP_NAMES: Tuple[str, ...] = tuple(name for name, _ in HOPS)

_BYTES: Dict[str, _metrics.Counter] = {}
_NS: Dict[str, _metrics.Counter] = {}
_COPY: Dict[str, _metrics.Counter] = {}
for _name, _desc in HOPS:
    _BYTES[_name] = _metrics.counter(f"lens_{_name}_bytes")
    _NS[_name] = _metrics.counter(f"lens_{_name}_busy_ns")
    _COPY[_name] = _metrics.counter(f"lens_{_name}_copy_bytes")


def hop_counters(name: str) -> Tuple[_metrics.Counter, _metrics.Counter,
                                     _metrics.Counter]:
    """The ``(bytes, busy_ns, copy_bytes)`` counter triple for one declared
    hop. Instrumented modules call this ONCE at import (module-level, a
    string-constant hop name) and cache the counters as globals; the
    per-op cost is then the bumps alone.
    """
    if name not in _BYTES:
        raise ValueError(f"unknown waterfall hop {name!r}; "
                         f"declared hops: {HOP_NAMES}")
    return _BYTES[name], _NS[name], _COPY[name]


def enabled() -> bool:
    """The lens master switch (``TPURPC_LENS=0`` off). Gates the sampling
    profiler and the scrape routes; the hop counters are branch-free
    always-on accounting and ignore it."""
    from tpurpc_torch.utils.config import _env

    return (_env("TPURPC_LENS") or "1").lower() not in ("0", "off", "false")


# -- scrape-time export -------------------------------------------------------

def waterfall() -> dict:
    """The per-hop effective-throughput table, sampled from the counters at
    call time. ``gbps`` is ``bytes / busy_ns`` (identical units); a hop
    that has seen no traffic reports zeros and is excluded from the
    bottleneck argmin."""
    rows: List[dict] = []
    for name, desc in HOPS:
        b = _BYTES[name].snapshot()
        ns = _NS[name].snapshot()
        cp = _COPY[name].snapshot()
        rows.append({
            "hop": name,
            "bytes": b,
            "busy_ms": round(ns / 1e6, 3),
            "gbps": round(b / ns, 3) if ns else 0.0,
            "copy_bytes": cp,
            "what": desc,
        })
    out = {"hops": rows, "slowest_hop": slowest_hop(rows)}
    try:
        from tpurpc_torch.tpu import ledger

        out["ledger"] = ledger.snapshot()
    except Exception:
        pass
    return out


def slowest_hop(rows: Optional[List[dict]] = None) -> Optional[str]:
    """The bottleneck hop: lowest effective GB/s among hops that actually
    moved bytes (and spent time doing it). None before any traffic.

    Hops that carried under 1% of the busiest hop's bytes are excluded:
    once the rendezvous plane carries the bulk payloads, the framed ``wire``
    hop sees only control frames — a few KB at small-message rates — and a
    control-only hop's low GB/s is not an upper bound on the BULK flow, so
    naming it the bottleneck would be the instrument lying."""
    if rows is None:
        rows = waterfall()["hops"]
    live = [r for r in rows if r["bytes"] > 0 and r["busy_ms"] > 0]
    if not live:
        return None
    bar = max(r["bytes"] for r in live) * 0.01
    bulk = [r for r in live if r["bytes"] >= bar]
    return min(bulk or live, key=lambda r: r["gbps"])["hop"]


def render_text(doc: Optional[dict] = None) -> str:
    """Human rendering of the waterfall table."""
    doc = doc if doc is not None else waterfall()
    rows = doc["hops"]
    lines = [f"{'hop':<10} {'GB/s':>8} {'MiB':>10} {'busy_ms':>10} "
             f"{'copy_MiB':>9}  what"]
    lines.append("-" * len(lines[0]))
    for r in rows:
        mark = " <-- slowest" if r["hop"] == doc.get("slowest_hop") else ""
        lines.append(
            f"{r['hop']:<10} {r['gbps']:>8.3f} "
            f"{r['bytes'] / (1 << 20):>10.1f} {r['busy_ms']:>10.1f} "
            f"{r['copy_bytes'] / (1 << 20):>9.1f}  {r['what'][:46]}{mark}")
    if doc.get("slowest_hop") is None:
        lines.append("(no traffic yet: every hop idle)")
    return "\n".join(lines) + "\n"
