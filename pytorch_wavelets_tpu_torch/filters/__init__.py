"""Filter coefficient sourcing (host-side numpy)."""
from pytorch_wavelets_tpu_torch.filters.dtcwt_coeffs import (  # noqa: F401
    biort, qshift, level1,
)

__all__ = ["biort", "qshift", "level1"]
