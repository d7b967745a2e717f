"""Sparse-engine facade of the gather engine (port of
``dal3d_tpu/ops/sparse_backend.py``): the dense-index-grid engine
(``ops/sparse_grid.py``) with the shared struct and compute of
``ops/sparse.py``, under BEVFusion's SparseEncoder and the CBGS backbone's
``impl="gather"`` and ``"hybrid"`` (L0). JAX's ``DAL3D_SPARSE_ENGINE``
switch to its searchsorted engine has no counterpart: the port has no
environment knobs, and that engine's functions are called by name from
``ops/sparse.py`` (``from_voxels``, ``subm_rulebook``, ``downsample_plan``,
``sparse_conv_downsample``)."""
from .sparse import SparseBatch, gather_gemm, to_dense
from .sparse_grid import (build_index_grid, downsample_plan, from_voxels,
                          sparse_conv_downsample, subm_conv, subm_rulebook, with_plan)

__all__ = [
    "SparseBatch", "gather_gemm", "to_dense", "from_voxels", "subm_rulebook",
    "subm_conv", "sparse_conv_downsample", "downsample_plan", "build_index_grid", "with_plan",
]
