"""DWT modules (port of ``pytorch_wavelets_tpu/models/dwt.py``, the DWT
part; reference: pytorch_wavelets/dwt/transform2d.py, transform1d.py).

Each module holds its pywt-ordered filter taps as float64 buffers on
``device``: 'cuda' (default; raises without CUDA), where the transform and
its backward run kernels K6/K7, or 'cpu' for the plain PyTorch path.
Inputs must be on that device.  ``mesh`` is not ported yet and raises.
"""
from __future__ import annotations

from pytorch_wavelets_tpu_torch.models._base import (
    _TapsModule, canon_dtype, cast_bands, upcast_bands,
)
from pytorch_wavelets_tpu_torch.transforms.dwt import (
    dec_filters, dwt1d, dwt2d, idwt1d, idwt2d, rec_filters,
)

__all__ = ["DWTForward", "DWTInverse", "DWT1DForward", "DWT1DInverse"]

_DEC2 = ("h0_col", "h1_col", "h0_row", "h1_row")
_REC2 = ("g0_col", "g1_col", "g0_row", "g1_row")
_DEC1 = ("h0", "h1")
_REC1 = ("g0", "g1")


class _DWTModule(_TapsModule):
    def __init__(self, names, taps, mode, device, mesh):
        super().__init__(zip(names, taps), device, mesh, None)
        self.mode = mode

    @property
    def filters(self):
        """The taps as a tuple in the order of the buffers."""
        return tuple(self._filters.values())


class DWTForward(_DWTModule):
    """J-level 2-D DWT (reference DWTForward, dwt/transform2d.py:7-74).

    Args:
        J: number of decomposition levels.
        wave: pywt-style name, Wavelet, or (h0, h1) / 4-tuple of arrays.
        mode: 'zero' | 'symmetric' | 'reflect' | 'periodization' |
            'periodic'.
        coeff_dtype: optional storage dtype (e.g. 'bfloat16') for the
            detail bands; :class:`DWTInverse` upcasts automatically
            (the lowpass stays at the compute dtype).
        device, mesh: see the module docstring.
    Call: x (N, C, H, W) -> (yl, yh) with yh finest-first, each entry
    (N, C, 3, H', W') ordered (LH, HL, HH).
    """

    def __init__(self, J=1, wave="db1", mode="zero", coeff_dtype=None,
                 device="cuda", mesh=None):
        super().__init__(_DEC2, dec_filters(wave), mode, device, mesh)
        self.J = J
        self.coeff_dtype = canon_dtype(coeff_dtype)

    def forward(self, x):
        self._check_device(x)
        yl, yh = dwt2d(x, self.filters, J=self.J, mode=self.mode)
        if self.coeff_dtype is not None:
            yh = cast_bands(yh, self.coeff_dtype)
        return yl, yh


class DWTInverse(_DWTModule):
    """2-D inverse DWT (reference DWTInverse, dwt/transform2d.py:77-148).

    Call: (yl, yh) -> x.  Any yh entry may be None (treated as zeros).
    Dial-narrowed detail storage (:class:`DWTForward` ``coeff_dtype``,
    signalled by a wider yl) is upcast automatically; natively-narrow
    pipelines keep their dtype.
    """

    def __init__(self, wave="db1", mode="zero", device="cuda", mesh=None):
        super().__init__(_REC2, rec_filters(wave), mode, device, mesh)

    def forward(self, coeffs):
        yl, yh = coeffs
        self._check_device(yl, *(yh or ()))
        if yh is not None:
            coeffs = (yl, upcast_bands(yh, yl))
        return idwt2d(coeffs, self.filters, mode=self.mode)


class DWT1DForward(_DWTModule):
    """J-level 1-D DWT on (N, C, L) (reference DWT1DForward,
    dwt/transform1d.py:7-59).  ``coeff_dtype`` narrows detail-band
    storage as in :class:`DWTForward`."""

    def __init__(self, J=1, wave="db1", mode="zero", coeff_dtype=None,
                 device="cuda", mesh=None):
        super().__init__(_DEC1, dec_filters(wave)[:2], mode, device, mesh)
        self.J = J
        self.coeff_dtype = canon_dtype(coeff_dtype)

    def forward(self, x):
        self._check_device(x)
        yl, yh = dwt1d(x, self.filters, J=self.J, mode=self.mode)
        if self.coeff_dtype is not None:
            yh = cast_bands(yh, self.coeff_dtype)
        return yl, yh


class DWT1DInverse(_DWTModule):
    """1-D inverse DWT (reference DWT1DInverse, dwt/transform1d.py:62-115)."""

    def __init__(self, wave="db1", mode="zero", device="cuda", mesh=None):
        super().__init__(_REC1, rec_filters(wave)[:2], mode, device, mesh)

    def forward(self, coeffs):
        yl, yh = coeffs
        self._check_device(yl, *(yh or ()))
        if yh is not None:
            coeffs = (yl, upcast_bands(yh, yl))
        return idwt1d(coeffs, self.filters, mode=self.mode)
