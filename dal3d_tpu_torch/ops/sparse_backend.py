"""Sparse-engine facade of the gather engine (port of
``dal3d_tpu/ops/sparse_backend.py``): the dense-index-grid engine
(``ops/sparse_grid.py``) with the shared struct and compute of
``ops/sparse.py``. The JAX package's ``DAL3D_SPARSE_ENGINE`` switch to its
searchsorted engine is not ported: the port has no environment knobs, and
that engine waits for ROADMAP A9."""
from .sparse import SparseBatch, gather_gemm, to_dense
from .sparse_grid import (build_index_grid, downsample_plan, from_voxels,
                          sparse_conv_downsample, subm_conv, subm_rulebook, with_plan)

__all__ = [
    "SparseBatch", "gather_gemm", "to_dense", "from_voxels", "subm_rulebook",
    "subm_conv", "sparse_conv_downsample", "downsample_plan", "build_index_grid", "with_plan",
]
