"""Command-line tools: a copy of part of ``tpurpc/tools/``.

* :mod:`~tpurpc_torch.tools.bundle` renders an evidence bundle;
* :mod:`~tpurpc_torch.tools.diagnose` replays a bundle through the
  diagnosis engine;
* :mod:`~tpurpc_torch.tools.collector` serves the fleet collector.

The rest of the reference's ``tools/`` (``cli``, ``top``, ``timeline`` and
the smoke scripts) is ROADMAP A12.
"""
