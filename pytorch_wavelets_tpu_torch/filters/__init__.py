"""Filter coefficient sourcing (host-side numpy)."""
from pytorch_wavelets_tpu_torch.filters.dwt_coeffs import (  # noqa: F401
    Wavelet, wavelet, wavelist, qmf_from_lowpass,
)
from pytorch_wavelets_tpu_torch.filters.dtcwt_coeffs import (  # noqa: F401
    biort, qshift, level1,
)

__all__ = ["Wavelet", "wavelet", "wavelist", "qmf_from_lowpass",
           "biort", "qshift", "level1"]
