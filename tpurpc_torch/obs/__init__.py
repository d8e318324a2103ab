"""The observability core: a copy of ``tpurpc/obs/``'s first layer.

* :mod:`~tpurpc_torch.obs.metrics` — the process-wide metrics registry
  (counters, gauges, histograms, labeled counters, fleet gauges).
* :mod:`~tpurpc_torch.obs.tracing` — per-RPC span timelines with a trace
  context carried in call metadata (``tpurpc-trace``), head sampling
  (``TPURPC_TRACE_SAMPLE``) and tail capture (``TPURPC_TRACE_TAIL``).
* :mod:`~tpurpc_torch.obs.flight` — the always-on binary ring of
  transport events.
* :mod:`~tpurpc_torch.obs.watchdog` — the stall sweeper over in-flight
  calls; its rolling p99 feeds the admission gate and the load report.
* :mod:`~tpurpc_torch.obs.profiler` and :mod:`~tpurpc_torch.obs.lens` —
  the stage-tagged sampling profiler and the per-hop byte waterfall.

Names, event codes, environment variables and defaults are the
reference's, so both packages' readings compare. The call plane
(``rpc/channel.py``, ``rpc/server.py``) carries the hooks; the other
planes' hooks are ROADMAP A4 (b). Left out: ``scrape``, ``tsdb``,
``slo``, ``collector``, ``bundle``, ``diagnose`` and ``shard`` (ROADMAP
A4 (c)), ``odyssey`` (A4 (d)) and ``native_obs`` (A7 (b)).
"""

from tpurpc_torch.obs import flight, lens, metrics, profiler, tracing  # noqa: F401

__all__ = ["flight", "lens", "metrics", "profiler", "tracing"]
