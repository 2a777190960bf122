"""fea_large_tpu_torch: the PyTorch + CUDA port of `fea_large_tpu`.

Total-Lagrangian large-strain hyperelasticity on TET4/TET10 Kuhn lattices,
solved by the mixed-precision Newton method (f64 residual, f32 tangent and
PCG with block-Jacobi or two-level preconditioning). The four element
passes of the structured lattice run as CUDA kernels written for Hopper
(csrc/struct_kernels.cu); everything else is plain PyTorch.

The package imports torch and numpy and never the JAX package, which stays
the reference.
"""

from fea_large_tpu_torch import config as config  # noqa: F401  (TF32 off)
from fea_large_tpu_torch.materials import (  # noqa: F401
    Material,
    NeoHookean,
    NeoHookeanVolumetric,
    StVenantKirchhoff,
    make_material,
)
from fea_large_tpu_torch.mesh.core import Mesh, make_node_sets  # noqa: F401

__version__ = "0.1.0"
