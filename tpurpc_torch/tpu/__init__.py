"""Device-side data plane: copy ledger, the device receive ring
(``hbm_ring``), device serialization (``serialize``), plus the device-ring
endpoint and decoder (``endpoint``).

``serialize`` is loaded lazily: it pulls in the torchshim codec package,
whose service module imports the rpc stack, whose transport reports into
the ledger here — an eager import would close that cycle.
"""

from tpurpc_torch.tpu import ledger
from tpurpc_torch.tpu.hbm_ring import HbmLease, HbmRegionLease, HbmRing

_SERIALIZE_NAMES = ("deserialize_to_device", "serialize_from_device",
                    "serialize_into", "serialize_tree_into",
                    "tree_from_device")

__all__ = ["ledger", "HbmLease", "HbmRegionLease", "HbmRing",
           *_SERIALIZE_NAMES]


def __getattr__(name):
    if name in _SERIALIZE_NAMES:
        from tpurpc_torch.tpu import serialize

        return getattr(serialize, name)
    raise AttributeError(f"module 'tpurpc_torch.tpu' has no attribute {name!r}")
