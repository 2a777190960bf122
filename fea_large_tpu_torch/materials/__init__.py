from fea_large_tpu_torch.materials.base import (  # noqa: F401
    MATERIAL_REGISTRY,
    Material,
    lame_from_E_nu,
    make_material,
)
from fea_large_tpu_torch.materials.neo_hookean import (  # noqa: F401
    NeoHookean,
    NeoHookeanVolumetric,
)
from fea_large_tpu_torch.materials.svk import StVenantKirchhoff  # noqa: F401
