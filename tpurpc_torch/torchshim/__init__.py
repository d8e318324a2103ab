"""torch.Tensor in/out over tpurpc_torch.

* :mod:`tpurpc_torch.torchshim.codec` — tensor/pytree wire format,
  zero-copy decode.
* :mod:`tpurpc_torch.torchshim.service` — tensor services, fan-in
  batching, ``serve_torch`` and ``serve_torch_sharded``.
"""

from tpurpc_torch.torchshim.codec import (decode_tensor, decode_tree,
                                          encode_tensor, encode_tensor_bytes,
                                          encode_tree, encode_tree_bytes,
                                          to_torch, tree_deserializer,
                                          tree_serializer)
from tpurpc_torch.torchshim.service import (DeviceMerger, FanInBatcher,
                                            ShardedFanIn, TensorClient,
                                            add_tensor_method, serve_torch,
                                            serve_torch_sharded)

__all__ = [
    "decode_tensor", "decode_tree", "encode_tensor", "encode_tensor_bytes",
    "encode_tree", "encode_tree_bytes", "to_torch", "tree_deserializer",
    "tree_serializer",
    "FanInBatcher", "ShardedFanIn", "DeviceMerger", "TensorClient",
    "add_tensor_method", "serve_torch", "serve_torch_sharded",
]
