"""Parallel building blocks of the port: the mesh (``mesh``), ring
attention, the MoE layer and the microbatch pipeline, their collectives over
``torch.distributed`` (``collectives``), and multi-process bring-up
(``distributed``). One rank runs with no process group at all."""

from tpurpc_torch.parallel.distributed import (global_mesh, initialize_cluster,
                                               process_count)
from tpurpc_torch.parallel.mesh import build_mesh, factor_mesh

__all__ = ["build_mesh", "factor_mesh", "global_mesh",
           "initialize_cluster", "process_count"]
