"""TET4 and TET10 reference elements and the element passes (counterpart
of `fea_large_tpu/elements/`)."""

from fea_large_tpu_torch.elements.reference import (  # noqa: F401
    TET4,
    TET10,
    ElementType,
    get_element,
)
