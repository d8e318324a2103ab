"""Parallel building blocks of the port over a one-rank mesh: the mesh
(``mesh``), ring attention, the MoE layer and the microbatch pipeline, with
their collectives in ``collectives`` (multi-rank ones are ROADMAP A6)."""

from tpurpc_torch.parallel.mesh import build_mesh, factor_mesh

__all__ = ["build_mesh", "factor_mesh"]
