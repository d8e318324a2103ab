"""Command-line tools: a copy of part of ``tpurpc/tools/``.

* :mod:`~tpurpc_torch.tools.bundle` renders an evidence bundle;
* :mod:`~tpurpc_torch.tools.diagnose` replays a bundle through the
  diagnosis engine;
* :mod:`~tpurpc_torch.tools.collector` serves the fleet collector;
* :mod:`~tpurpc_torch.tools.odyssey_smoke` drives one sequence's journey
  across a prefill child and two decode servers (``--prefill`` is the
  child alone).

The rest of the reference's ``tools/`` (``cli``, ``top``, ``timeline`` and
the other smoke scripts) is ROADMAP A12.
"""
