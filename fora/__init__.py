"""fora: approximate Personalized-PageRank retrieval engine in JAX.

A from-scratch JAX re-design of the FORA system (KDD'17 / TODS'19):
forward-push propagation as masked SpMV supersteps, residue-weighted
refinement served from a multi-resolution precomputed walk index (FORA+),
top-k with iterative (eps, delta, p_f) guarantee refinement, sharded over
('graph', 'query') device meshes.  See ARCHITECTURE.md.
"""

__version__ = "0.1.0"

from .config import ForaConfig, ResolvedConfig

__all__ = ["ForaConfig", "ResolvedConfig", "__version__"]
