"""User-facing transform modules mirroring the reference module API."""
from pytorch_wavelets_tpu_torch.models.dtcwt import (  # noqa: F401
    DTCWTForward, DTCWTInverse,
)
from pytorch_wavelets_tpu_torch.models.dwt import (  # noqa: F401
    DWT1DForward, DWT1DInverse, DWTForward, DWTInverse, SWTForward,
    SWTInverse,
)
from pytorch_wavelets_tpu_torch.models.scatternet import (  # noqa: F401
    ScatLayer, ScatLayerj2,
)

__all__ = ["DWTForward", "DWTInverse", "DWT1DForward", "DWT1DInverse",
           "SWTForward", "SWTInverse", "DTCWTForward", "DTCWTInverse",
           "ScatLayer", "ScatLayerj2"]
