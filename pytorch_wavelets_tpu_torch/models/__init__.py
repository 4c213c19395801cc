"""User-facing transform modules mirroring the reference module API."""
from pytorch_wavelets_tpu_torch.models.dtcwt import (  # noqa: F401
    DTCWTForward, DTCWTInverse,
)
from pytorch_wavelets_tpu_torch.models.scatternet import (  # noqa: F401
    ScatLayer, ScatLayerj2,
)

__all__ = ["DTCWTForward", "DTCWTInverse", "ScatLayer", "ScatLayerj2"]
