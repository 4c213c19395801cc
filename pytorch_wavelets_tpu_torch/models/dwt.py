"""DWT and SWT modules (port of ``pytorch_wavelets_tpu/models/dwt.py``;
reference: pytorch_wavelets/dwt/transform2d.py, transform1d.py).

Each module holds its pywt-ordered filter taps as float64 buffers on
``device``: 'cuda' (default; raises without CUDA), where the transform and
its backward run the kernels (the DWT K6/K7; the SWT K12, and K1 with
K13 for its inverse), or 'cpu' for the plain PyTorch path.  Inputs must
be on that device.  ``mesh`` (a ``DeviceMesh``, ``parallel.make_mesh``)
runs the transform sharded on it (``parallel/sharded_dwt.py``: K19 and
K1 on the operator route, K19 with K6/K7 or K12/K16 on the conv halo
route); inputs and outputs are then DTensors, or full tensors on every
rank going in.
"""
from __future__ import annotations

import torch

from pytorch_wavelets_tpu_torch.filters import wavelet as _wavelet
from pytorch_wavelets_tpu_torch.models._base import (
    _TapsModule, canon_dtype, cast_bands, upcast_bands,
)
from pytorch_wavelets_tpu_torch.parallel.sharded_dwt import (
    sharded_dwt1d, sharded_dwt2d, sharded_idwt1d, sharded_idwt2d,
    sharded_iswt2d, sharded_swt2d,
)
from pytorch_wavelets_tpu_torch.transforms.dwt import (
    dec_filters, dwt1d, dwt2d, idwt1d, idwt2d, iswt2d, rec_filters, swt2d,
)

__all__ = ["DWTForward", "DWTInverse", "DWT1DForward", "DWT1DInverse",
           "SWTForward", "SWTInverse"]

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

    The input gradient depends on ``mesh`` in 'symmetric' and 'reflect':
    with a mesh it is the exact adjoint of the forward, as the JAX
    package's ``shard_map`` autodiff gives it; without one it is the
    reference's backward, the adjoint only in 'zero' and 'periodization'.
    Both are the JAX package's, and in 'zero' and 'periodization' the two
    agree (``tests/test_torch_signatures.py::
    test_dwt_mesh_input_gradient``).
    """

    def __init__(self, J=1, wave="db1", mode="zero", mesh=None,
                 coeff_dtype=None, device="cuda"):
        super().__init__(_DEC2, dec_filters(wave), mode, device, mesh)
        self.J = J
        self.coeff_dtype = canon_dtype(coeff_dtype)

    def forward(self, x):
        self._check_device(x)
        if self.mesh is not None:
            yl, yh = sharded_dwt2d(x, self.mesh, wave=self.filters, J=self.J,
                                   mode=self.mode)
        else:
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

    def __init__(self, wave="db1", mode="zero", mesh=None, device="cuda"):
        super().__init__(_REC2, rec_filters(wave), mode, device, mesh)

    def forward(self, coeffs):
        yl, yh = coeffs
        self._check_device(yl, *(yh or ()))
        if yh is not None:
            coeffs = (yl, upcast_bands(yh, yl))
        if self.mesh is not None:
            return sharded_idwt2d(coeffs, self.mesh, wave=self.filters,
                                  mode=self.mode)
        return idwt2d(coeffs, self.filters, mode=self.mode)


class DWT1DForward(_DWTModule):
    """J-level 1-D DWT on (N, C, L) (reference DWT1DForward,
    dwt/transform1d.py:7-59).  ``coeff_dtype`` narrows detail-band
    storage as in :class:`DWTForward`.

    As for :class:`DWTForward`, the input gradient in 'symmetric' and
    'reflect' is the exact adjoint of the forward with ``mesh`` (the JAX
    package's ``shard_map`` autodiff) and the reference's backward
    without it; the two agree in 'zero' and 'periodization'."""

    def __init__(self, J=1, wave="db1", mode="zero", mesh=None,
                 coeff_dtype=None, device="cuda"):
        super().__init__(_DEC1, dec_filters(wave)[:2], mode, device, mesh)
        self.J = J
        self.coeff_dtype = canon_dtype(coeff_dtype)

    def forward(self, x):
        self._check_device(x)
        if self.mesh is not None:
            yl, yh = sharded_dwt1d(x, self.mesh, wave=self.filters, J=self.J,
                                   mode=self.mode)
        else:
            yl, yh = dwt1d(x, self.filters, J=self.J, mode=self.mode)
        if self.coeff_dtype is not None:
            yh = cast_bands(yh, self.coeff_dtype)
        return yl, yh


class DWT1DInverse(_DWTModule):
    """1-D inverse DWT (reference DWT1DInverse, dwt/transform1d.py:62-115)."""

    def __init__(self, wave="db1", mode="zero", mesh=None, device="cuda"):
        super().__init__(_REC1, rec_filters(wave)[:2], mode, device, mesh)

    def forward(self, coeffs):
        yl, yh = coeffs
        self._check_device(yl, *(yh or ()))
        if yh is not None:
            coeffs = (yl, upcast_bands(yh, yl))
        if self.mesh is not None:
            return sharded_idwt1d(coeffs, self.mesh, wave=self.filters,
                                  mode=self.mode)
        return idwt1d(coeffs, self.filters, mode=self.mode)


class SWTForward(_DWTModule):
    """J-level stationary (undecimated) 2-D wavelet transform (reference
    SWTForward, dwt/transform2d.py:151-212).

    ``coeff_dtype``: optional storage dtype (e.g. 'bfloat16') for the
    returned stacks (the undecimated representation is 4J full-resolution
    bands); :class:`SWTInverse` upcasts them.  On CUDA each level is two
    K12 launches, forward and backward.

    Call: x (N, C, H, W) -> list of J tensors (N, C, 4, H, W) ordered
    (LL, LH, HL, HH)."""

    def __init__(self, J=1, wave="db1", mode="periodization", mesh=None,
                 coeff_dtype=None, device="cuda"):
        super().__init__(_DEC2, dec_filters(wave), mode, device, mesh)
        self.J = J
        self.coeff_dtype = canon_dtype(coeff_dtype)

    def forward(self, x):
        self._check_device(x)
        if self.mesh is not None:
            out = sharded_swt2d(x, self.mesh, wave=self.filters, J=self.J,
                                mode=self.mode)
        else:
            out = swt2d(x, self.filters, J=self.J, mode=self.mode)
        if self.coeff_dtype is not None:
            out = cast_bands(out, self.coeff_dtype)
        return out


class SWTInverse(_DWTModule):
    """Inverse SWT: the exact least-squares inverse of :class:`SWTForward`
    for every boundary mode (the reference ships only dead code for it,
    dwt/swt_inverse.py).  ``wave`` names the *analysis* wavelet of the
    SWTForward (tuples are dec filters), whose taps the module holds.

    ``upcast`` (default True) upcasts sub-fp32 stacks (the
    :class:`SWTForward` ``coeff_dtype`` dial) to fp32 before the merge;
    ``upcast=False`` keeps a narrow pipeline's dtype, which only the CPU
    path takes (the CUDA kernels take fp32 and raise on other dtypes).
    On CUDA each merge is K1 (dense pinv operator up to 2048 samples, and
    past it banded normal equations in the non-circular modes) or cuFFT
    with K13 (past 2048 in the circular modes)."""

    def __init__(self, wave="db1", mode="periodization", mesh=None,
                 upcast=True, device="cuda"):
        super().__init__(_DEC2, dec_filters(wave), mode, device, mesh)
        self.upcast = bool(upcast)
        # the name, kept where it resolves to these analysis taps: the
        # sharded circular merge needs the true synthesis bank, which only
        # a name (or an orthonormal tuple) recovers
        # (parallel/sharded_dwt.py:_iswt_synth_filters)
        name = wave if isinstance(wave, str) else getattr(wave, "name", None)
        if name is not None and not isinstance(wave, str):
            try:
                if dec_filters(_wavelet(name)) != self.filters:
                    name = None
            except ValueError:
                name = None
        self._wave = name if isinstance(name, str) else None

    def forward(self, coeffs):
        self._check_device(*coeffs)
        if self.upcast:
            coeffs = [c.to(torch.float32) if c.dtype.itemsize < 4 else c
                      for c in coeffs]
        if self.mesh is not None:
            # a loaded state dict may hold other taps than the name's
            wave = (self._wave if self._wave is not None
                    and dec_filters(self._wave) == self.filters
                    else self.filters)
            return sharded_iswt2d(coeffs, self.mesh, wave=wave,
                                  mode=self.mode)
        return iswt2d(coeffs, self.filters, mode=self.mode)
