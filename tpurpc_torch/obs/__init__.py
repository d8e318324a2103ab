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
* :mod:`~tpurpc_torch.obs.tsdb`, :mod:`~tpurpc_torch.obs.slo`,
  :mod:`~tpurpc_torch.obs.bundle` and :mod:`~tpurpc_torch.obs.diagnose` —
  bounded metric history, SLO burn-rate alerting, automatic evidence
  capture and the causal diagnosis engine.
* :mod:`~tpurpc_torch.obs.scrape`, :mod:`~tpurpc_torch.obs.shard` and
  :mod:`~tpurpc_torch.obs.collector` — the plain-HTTP routes every serving
  port answers, their merge across shard workers, and the fleet
  collector.
* :mod:`~tpurpc_torch.obs.odyssey` — the generation plane's sequence
  journeys, token latency and per-sequence cost ledgers (``/debug/seq``,
  ``TPURPC_ODYSSEY``).

Names, event codes, environment variables and defaults are the
reference's, so both packages' readings compare. Left out, with its item:
``native_obs``, the fold of the C core's counters (ROADMAP A7 (b)).
"""

from tpurpc_torch.obs import flight, lens, metrics, profiler, tracing  # noqa: F401

__all__ = ["flight", "lens", "metrics", "profiler", "tracing"]
