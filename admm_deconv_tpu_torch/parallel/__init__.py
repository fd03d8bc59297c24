"""Multi-device parallelism: meshes of ranks, batch sharding, spatial tiling.

Counterpart of ``admm_deconv_tpu/parallel`` on ``torch.distributed``: named
meshes (``mesh.py``), process-group set-up (``distributed.py``) and the exact
H-tiled solvers (``tiling.py``) with a transpose-based distributed rFFT2,
halo-exchange stencils (kernel Q2-4 on the card) and all-reduced residual
norms for shared rho adaptation and, in the Anderson solver, an all-reduced
Gram for shared mixing coefficients.
"""

from admm_deconv_tpu_torch.parallel import distributed
from admm_deconv_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from admm_deconv_tpu_torch.parallel.tiling import (
    tiled_composite_tv_deconvolve,
    tiled_tv_deconvolve,
    tiled_tv_deconvolve_anderson,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "tiled_composite_tv_deconvolve",
    "tiled_tv_deconvolve",
    "tiled_tv_deconvolve_anderson",
    "distributed",
]
