"""Multi-process bring-up: join the ranks of one mesh over
``torch.distributed``.

The port of ``tpurpc/parallel/distributed.py``. One process per rank joins
a coordinator; after that the same mesh programs that run on one rank
(:mod:`tpurpc_torch.parallel.mesh`, :mod:`tpurpc_torch.models.transformer`)
run over all of them. The RPC plane is unchanged: it is how requests reach
a process; the mesh is how work spreads over the ranks once there.

Environment (the reference's): ``TPURPC_COORDINATOR`` (host:port),
``TPURPC_NUM_PROCESSES``, ``TPURPC_PROCESS_ID``. With none of them set the
call is a one-process no-op. ``TPURPC_AUTODETECT=1`` instead takes the
launcher's own variables, torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK`` (``init_method="env://"``), as the reference lets
JAX detect its cluster.

Backends: a CUDA tensor's collectives ride NCCL, a CPU tensor's
``TPURPC_CPU_COLLECTIVES`` (``gloo``, the default, or ``mpi`` where torch
was built with it; any other value raises). On a host with cards each
process takes card ``LOCAL_RANK`` (torchrun's), else its process id, modulo
the host's count, and NCCL needs one card per rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import torch

from tpurpc_torch.parallel.mesh import Mesh, build_mesh, factor_mesh

#: how long a rank waits for the others, in bring-up and in a collective
TIMEOUT = datetime.timedelta(seconds=60)
CPU_BACKENDS = ("gloo", "mpi")


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val else None


def _cpu_backend() -> str:
    import torch.distributed as dist

    name = os.environ.get("TPURPC_CPU_COLLECTIVES", "gloo").strip().lower()
    if name not in CPU_BACKENDS:
        raise ValueError(f"TPURPC_CPU_COLLECTIVES={name!r}: expected one of "
                         f"{CPU_BACKENDS}")
    if name == "mpi" and not dist.is_mpi_available():
        raise ValueError("TPURPC_CPU_COLLECTIVES=mpi but this torch build "
                         "has no MPI backend")
    return name


def initialize_cluster(coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> int:
    """Join (or stand alone as) a ``torch.distributed`` cluster; returns
    this process's rank. One process (``num_processes`` None or 1, no
    coordinator) is a no-op that returns 0, so the same program runs
    anywhere. A second call returns the rank and joins nothing."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    coordinator = coordinator or os.environ.get("TPURPC_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("TPURPC_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("TPURPC_PROCESS_ID")
    autodetect = os.environ.get("TPURPC_AUTODETECT") == "1"
    if (coordinator is None and not autodetect
            and (num_processes is None or num_processes == 1)):
        return 0
    backend = f"cpu:{_cpu_backend()}"
    if dist.is_nccl_available():   # absent from CPU-only builds
        backend += ",cuda:nccl"
    if autodetect and coordinator is None:
        kw = {"init_method": "env://"}
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError(
                "initialize_cluster needs a coordinator, a process count and "
                "a process id (TPURPC_COORDINATOR, TPURPC_NUM_PROCESSES, "
                "TPURPC_PROCESS_ID)")
        kw = {"init_method": f"tcp://{coordinator}",
              "world_size": num_processes, "rank": process_id}
        local = process_id
    if torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend, timeout=TIMEOUT, **kw)
    return dist.get_rank()


def process_count() -> int:
    """The processes in the cluster (1 before or without a join)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(sizes: Optional[Dict[str, int]] = None,
                device=None) -> Tuple[Mesh, Dict[str, int]]:
    """A five-axis mesh over every rank of the cluster, and its sizes.

    With ``sizes`` omitted, :func:`factor_mesh` factors the world size with
    dp outermost, so the axes most tolerant of slow links are the ones that
    cross hosts. Call after :func:`initialize_cluster`, on every rank."""
    n = process_count()
    sizes = sizes or factor_mesh(n)
    return build_mesh(n, sizes=sizes, device=device), sizes
