"""User-facing transform modules mirroring the reference module API."""
from pytorch_wavelets_tpu_torch.models.dtcwt import (  # noqa: F401
    DTCWTForward, DTCWTInverse,
)

__all__ = ["DTCWTForward", "DTCWTInverse"]
