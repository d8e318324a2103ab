"""Generation serving: continuous batching and the paged KV plane.

* :mod:`tpurpc_torch.serving.scheduler` — :class:`DecodeScheduler`:
  sequences join and leave the device batch between decode steps, prefill
  rides a per-step token budget, SLO classes gate admission and
  preemption, shedding trips before collapse; with ``kv=`` it runs paged.
* :mod:`tpurpc_torch.serving.kv` — the block arena, block tables,
  copy-on-write prefix reuse, swap and quarantine.
* :mod:`tpurpc_torch.serving.api` — ``serve_generation`` and
  ``GenerationClient``: per-token streams over RPC.
* :mod:`tpurpc_torch.serving.disagg` — disaggregated prefill/decode: KV
  blocks ship over block grants, sequences hand off and migrate live
  between decode servers, clients re-attach.

The step model is :class:`tpurpc_torch.torchshim.generate.ToyDecodeModel`,
whose state lives on the card.

The three modules carry the reference's observability hooks: flight
edges, metrics and fleet gauges, the profiler's ``decode_step`` and
``kv_swap`` stages, ``/healthz`` lines, and the sequence journeys and cost
ledgers of :mod:`tpurpc_torch.obs.odyssey` (``trace=``/``account=`` at
submit, the ``tpurpc-account`` metadata key on the clients).
"""

from tpurpc_torch.serving.api import (GEN_SERVICE, GenerationClient,
                                      add_generation_method,
                                      serve_generation)
from tpurpc_torch.serving.disagg import (KV_SERVICE, DisaggClient,
                                         DisaggDecode, DisaggPrefill,
                                         MigrationFailed, SeqMigrated,
                                         migrate, serve_decode,
                                         serve_prefill)
from tpurpc_torch.serving.kv import (HostKv, KvArenaFull, KvBlockManager,
                                     SeqKv)
from tpurpc_torch.serving.scheduler import (SLO_BATCH, SLO_INTERACTIVE,
                                            DecodeScheduler, DrainingError,
                                            ShedError, TokenStream)

__all__ = [
    "DecodeScheduler", "TokenStream", "ShedError", "DrainingError",
    "SLO_INTERACTIVE", "SLO_BATCH",
    "GEN_SERVICE", "GenerationClient", "add_generation_method",
    "serve_generation",
    "KvBlockManager", "SeqKv", "HostKv", "KvArenaFull",
    "KV_SERVICE", "DisaggClient", "DisaggDecode", "DisaggPrefill",
    "SeqMigrated", "MigrationFailed", "migrate", "serve_decode",
    "serve_prefill",
]
