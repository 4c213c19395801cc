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
"""
from __future__ import annotations

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda

__all__ = ["spec_merge", "spec_split", "spec_merge_plain",
           "spec_split_plain"]


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


def spec_merge(A, B, g0, g1, axis):
    """``g0 * A + g1 * B`` with the filters along ``axis``: a new
    (N, C, H, W) spectrum.  CPU tensors take :func:`spec_merge_plain`;
    CUDA tensors launch K13's ``spec_merge``, which reads ``A`` and ``B``
    through their strides."""
    if A.device.type == "cpu":
        return spec_merge_plain(A, B, g0, g1, axis)
    _cuda.check_inputs("spec_merge", A, B, g0, g1, dtype=torch.complex64)
    _check("spec_merge", A, g0, g1, axis)
    if B.shape != A.shape:
        raise ValueError(f"spec_merge: A {tuple(A.shape)} and B "
                         f"{tuple(B.shape)} differ")
    Z = torch.empty(A.shape, device=A.device, dtype=torch.complex64)
    if Z.numel() == 0:
        return Z
    lib = _cuda.library("iswt_spec")
    _cuda.check(lib, "spec_merge", lib.spec_merge(
        A.data_ptr(), B.data_ptr(), Z.data_ptr(), g0.data_ptr(),
        g1.data_ptr(), *A.shape, *A.stride(), *B.stride(), *Z.stride(),
        axis, _cuda.stream_of(A)))
    _K13M.launches += 1
    return Z


def spec_split(Z, g0, g1, axis):
    """``(conj(g0) * Z, conj(g1) * Z)`` with the filters along ``axis``,
    as one (2, N, C, H, W) spectrum.  CPU tensors take
    :func:`spec_split_plain`; CUDA tensors launch K13's ``spec_split``,
    which reads ``Z`` through its strides."""
    if Z.device.type == "cpu":
        return spec_split_plain(Z, g0, g1, axis)
    _cuda.check_inputs("spec_split", Z, g0, g1, dtype=torch.complex64)
    _check("spec_split", Z, g0, g1, axis)
    out = torch.empty((2, *Z.shape), device=Z.device, dtype=torch.complex64)
    if out.numel() == 0:
        return out
    lib = _cuda.library("iswt_spec")
    _cuda.check(lib, "spec_split", lib.spec_split(
        Z.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), g0.data_ptr(),
        g1.data_ptr(), *Z.shape, *Z.stride(), *out[0].stride(),
        *out[1].stride(), axis, _cuda.stream_of(Z)))
    _K13S.launches += 1
    return out


# the counters live on the wrappers, reached through these names (as in
# ops/afb_sfb.py), so that a wrapper swapped in by a caller still counts
_K13M, _K13S = spec_merge, spec_split
_K13M.launches = 0
_K13S.launches = 0
