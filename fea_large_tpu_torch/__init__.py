"""fea_large_tpu_torch: the PyTorch + CUDA port of `fea_large_tpu`.

Total-Lagrangian large-strain hyperelasticity on TET4/TET10 meshes (Kuhn
lattices and unstructured meshes), with closed-form materials and, on the
f64 paths, materials defined by their energy alone (autodiff), solved by
Newton's method: the mixed-precision path (f64 residual, f32 tangent and
PCG with block-Jacobi or two- or three-level preconditioning) and the f64
paths (BCSR stiffness or the matrix-free tangent with block-Jacobi PCG, or
the dense stiffness with a Cholesky solve). Task files run through
`python -m fea_large_tpu_torch run|info|bench` (cli.py), and the examples
through `python -m fea_large_tpu_torch.examples.<name>`. Every kernel the
reference wrote in Pallas runs here as a CUDA kernel written for Hopper
(csrc/*.cu), with a plain PyTorch version beside its wrapper; everything
else is plain PyTorch.

The package imports torch and numpy and never the JAX package, which stays
the reference.
"""

from fea_large_tpu_torch import config as config  # noqa: F401  (TF32 off)
from fea_large_tpu_torch.materials import (  # noqa: F401
    AutodiffMaterial,
    Material,
    MooneyRivlin,
    NeoHookean,
    NeoHookeanVolumetric,
    StVenantKirchhoff,
    lame_from_E_nu,
    make_material,
)
from fea_large_tpu_torch.mesh.core import Mesh, make_node_sets  # noqa: F401

__version__ = "0.1.0"
