"""The spectral body of the inverse SWT's least-squares merge, and kernel
K13 (``csrc/iswt_spec.cu``).

Port of the frequency-domain product of
``pytorch_wavelets_tpu/transforms/dwt.py:_fft_ls_merge`` (B10's FFT
branch, circular modes on axes past ``_ISWT_PINV_MAX_N``).  On complex
spectra of an (N, C, H, W)-shaped tensor along ``axis`` (2 or 3), with
filter vectors ``g0``/``g1`` indexed by the frequency along that axis:

- :func:`spec_merge`: ``Z = g0 * A + g1 * B``;
- :func:`spec_split`, its adjoint: ``(conj(g0) * Z, conj(g1) * Z)``,
  stacked as a (2, N, C, H, W) spectrum.

The FFTs around them stay ``torch.fft`` (cuFFT), as the JAX package
leaves them to XLA.  CPU tensors take :func:`spec_merge_plain` /
:func:`spec_split_plain`, the same expressions in PyTorch (any complex
dtype); CUDA tensors launch K13 (complex64) or raise.

The outputs' layout.  ``torch.fft.rfft`` returns its spectrum with the
frequency axis at stride 1, whichever axis it transforms.  The outputs
are written in their inputs' layout: where the inputs share an axis at
stride 1, that axis innermost (then the other axis, C and N), else
contiguous.  So K13 streams every rfft spectrum in 16-byte pairs, and an
``irfft`` over the last dimension of ``out.movedim(axis, -1)`` reads a
contiguous tensor (``transforms/dwt.py:_FFTMerge``: no layout copy but
the clone PyTorch's c2r path makes).  The C entries pick one of two walks
and return it, and each wrapper counts it in ``instantiations``:
``stream`` (every spectrum at stride 1 along one axis) or ``strided``
(any other view).
"""
from __future__ import annotations

import ctypes

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda

__all__ = ["spec_merge", "spec_split", "spec_merge_plain",
           "spec_split_plain", "SPEC_WALKS"]

# the C entries' walk codes (csrc/iswt_spec.cu:SpecWalk)
SPEC_WALKS = ("stream", "strided")


def _bcast(g, axis):
    shape = [1] * 4
    shape[axis] = -1
    return g.view(shape)


def spec_merge_plain(A, B, g0, g1, axis):
    """Plain PyTorch version of :func:`spec_merge`."""
    return _bcast(g0, axis) * A + _bcast(g1, axis) * B


def spec_split_plain(Z, g0, g1, axis):
    """Plain PyTorch version of :func:`spec_split`."""
    return torch.stack([_bcast(g0.conj(), axis) * Z,
                        _bcast(g1.conj(), axis) * Z])


def _check(kernel, t, g0, g1, axis):
    if axis not in (2, 3) or t.ndim != 4:
        raise ValueError(f"{kernel}: expected an (N, C, H, W) spectrum and "
                         f"axis 2 or 3, got {tuple(t.shape)}, axis {axis}")
    if (g0.shape != (t.shape[axis],) or g1.shape != g0.shape
            or not (g0.is_contiguous() and g1.is_contiguous())):
        raise ValueError(f"{kernel}: the filters must be contiguous vectors "
                         f"of {t.shape[axis]} frequencies, got "
                         f"{tuple(g0.shape)} and {tuple(g1.shape)}")


def _unit_axis(ins):
    """The axis (2 or 3) along which every tensor of ``ins`` has stride
    1, else 3 (the outputs' innermost axis)."""
    for u in (3, 2):
        if all(t.stride(u) == 1 for t in ins):
            return u
    return 3


def _empty(shape, u, lead=(), device=None):
    """A new complex64 spectrum of (N, C, H, W) ``shape`` (with ``lead``
    dimensions before it), stored with axis ``u`` innermost, then the
    other axis, C and N (contiguous when u is 3)."""
    if u == 3:
        return torch.empty((*lead, *shape), device=device,
                           dtype=torch.complex64)
    N, C, H, W = shape
    k = len(lead)
    return torch.empty((*lead, N, C, W, H), device=device,
                       dtype=torch.complex64).transpose(k + 2, k + 3)


def _launch(entry, ins, outs, g0, g1, axis):
    """Launch K13's ``entry`` on CUDA tensors and count the walk it took."""
    lib = _cuda.library("iswt_spec")
    walk = ctypes.c_int(-1)
    _cuda.check(lib, entry, getattr(lib, entry)(
        *(t.data_ptr() for t in ins + outs), g0.data_ptr(), g1.data_ptr(),
        *ins[0].shape, *(s for t in ins + outs for s in t.stride()), axis,
        ctypes.addressof(walk), _cuda.stream_of(ins[0])))
    wrapper = _K13M if entry == "spec_merge" else _K13S
    wrapper.launches += 1
    wrapper.instantiations[SPEC_WALKS[walk.value]] += 1


def spec_merge(A, B, g0, g1, axis):
    """``g0 * A + g1 * B`` with the filters along ``axis``: a new
    (N, C, H, W) spectrum in its inputs' layout (see the module
    docstring; CPU results take PyTorch's elementwise layout).  CPU
    tensors take :func:`spec_merge_plain`; CUDA tensors launch K13's
    ``spec_merge``, which reads ``A`` and ``B`` through their strides."""
    if A.device.type == "cpu":
        return spec_merge_plain(A, B, g0, g1, axis)
    _cuda.check_inputs("spec_merge", A, B, g0, g1,
                       dtypes=(torch.complex64,))
    _check("spec_merge", A, g0, g1, axis)
    if B.shape != A.shape:
        raise ValueError(f"spec_merge: A {tuple(A.shape)} and B "
                         f"{tuple(B.shape)} differ")
    Z = _empty(A.shape, _unit_axis([A, B]), device=A.device)
    if Z.numel():
        _launch("spec_merge", [A, B], [Z], g0, g1, axis)
    return Z


def spec_split(Z, g0, g1, axis):
    """``(conj(g0) * Z, conj(g1) * Z)`` with the filters along ``axis``,
    as one (2, N, C, H, W) spectrum, each band in ``Z``'s layout (as
    :func:`spec_merge`'s output).  CPU tensors take
    :func:`spec_split_plain`; CUDA tensors launch K13's ``spec_split``,
    which reads ``Z`` through its strides."""
    if Z.device.type == "cpu":
        return spec_split_plain(Z, g0, g1, axis)
    _cuda.check_inputs("spec_split", Z, g0, g1, dtypes=(torch.complex64,))
    _check("spec_split", Z, g0, g1, axis)
    out = _empty(Z.shape, _unit_axis([Z]), lead=(2,), device=Z.device)
    if out.numel():
        _launch("spec_split", [Z], [out[0], out[1]], g0, g1, axis)
    return out


# the counters live on the wrappers, reached through these names (as in
# ops/afb_sfb.py), so that a wrapper swapped in by a caller still counts
_K13M, _K13S = spec_merge, spec_split
_K13M.launches = 0
_K13S.launches = 0
_K13M.instantiations = dict.fromkeys(SPEC_WALKS, 0)
_K13S.instantiations = dict.fromkeys(SPEC_WALKS, 0)
