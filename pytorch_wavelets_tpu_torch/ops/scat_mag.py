"""Kernels K4 and K5: the scattering layers' smooth magnitude and its
backward (``csrc/scat_mag.cu``).  The autograd entry point over them is
``transforms/scatternet.py:smooth_mag``.

K4 :func:`scat_mag_fwd` replaces the JAX package's
``transforms/scatternet.py:smooth_mag`` and ``_combined_mag``; K5
:func:`scat_mag_bwd` replaces their JAX autodiff.  Both read a level's
bands as a (N, 6, C, h, w, 2) view through its strides (re/im adjacent
is the layout the scattering pyramids write), and both are bound by
bytes.  Each has its plain PyTorch version here, which CPU tensors take.
"""
from __future__ import annotations

import torch

from pytorch_wavelets_tpu_torch.ops import _cuda

__all__ = ["scat_mag_fwd", "scat_mag_fwd_plain", "scat_mag_bwd",
           "scat_mag_bwd_plain"]


def _sum_sq(h, combine):
    re, im = h[..., 0], h[..., 1]
    s = re * re + im * im
    return s.sum(dim=2, keepdim=True) if combine else s


def scat_mag_fwd_plain(h, bias, combine=False):
    """Plain PyTorch version of :func:`scat_mag_fwd` (the JAX formula)."""
    return torch.sqrt(_sum_sq(h, combine) + bias * bias) - bias


def scat_mag_bwd_plain(h, g, bias, combine=False):
    """Plain PyTorch version of :func:`scat_mag_bwd`."""
    den = torch.sqrt(_sum_sq(h, combine) + bias * bias)
    return torch.stack((g * h[..., 0] / den, g * h[..., 1] / den), dim=-1)


def _check_bands(kernel, h):
    if h.ndim != 6 or h.shape[1] != 6 or h.shape[5] != 2:
        raise ValueError(f"{kernel}: bands {tuple(h.shape)} are not "
                         f"(N, 6, C, h, w, 2)")


def scat_mag_fwd(h, bias, combine=False):
    """r = sqrt(re^2 + im^2 + bias^2) - bias of the (N, 6, C, h, w, 2)
    bands ``h``, as a contiguous (N, 6, C, h, w) tensor; with ``combine``
    re^2 + im^2 is summed over C first and r is (N, 6, 1, h, w).
    CPU tensors take :func:`scat_mag_fwd_plain`; CUDA tensors launch K4.
    """
    if h.device.type == "cpu":
        return scat_mag_fwd_plain(h, bias, combine)
    _cuda.check_inputs("scat_mag_fwd", h)
    _check_bands("scat_mag_fwd", h)
    N, _, C, hh, ww, _ = h.shape
    r = torch.empty((N, 6, 1 if combine else C, hh, ww), device=h.device,
                    dtype=torch.float32)
    lib = _cuda.library("scat_mag")
    _cuda.check(lib, "scat_mag_fwd", lib.scat_mag_fwd(
        h.data_ptr(), r.data_ptr(), N, C, hh, ww, int(combine), *h.stride(),
        bias * bias, bias, _cuda.stream_of(h)))
    scat_mag_fwd.launches += 1
    return r


def scat_mag_bwd(h, g, bias, combine=False):
    """The bands' gradient g * (re, im) / sqrt(re^2 + im^2 + bias^2) (the
    root summed over C with ``combine``, and g broadcast over C), for the
    output cotangent ``g`` (any strides), as a contiguous
    (N, 6, C, h, w, 2) tensor.  CPU tensors take
    :func:`scat_mag_bwd_plain`; CUDA tensors launch K5.
    """
    if h.device.type == "cpu":
        return scat_mag_bwd_plain(h, g, bias, combine)
    _cuda.check_inputs("scat_mag_bwd", h, g)
    _check_bands("scat_mag_bwd", h)
    N, _, C, hh, ww, _ = h.shape
    if tuple(g.shape) != (N, 6, 1 if combine else C, hh, ww):
        raise ValueError(f"scat_mag_bwd: cotangent {tuple(g.shape)} does "
                         f"not fit bands {tuple(h.shape)}")
    dh = torch.empty((N, 6, C, hh, ww, 2), device=h.device,
                     dtype=torch.float32)
    lib = _cuda.library("scat_mag")
    _cuda.check(lib, "scat_mag_bwd", lib.scat_mag_bwd(
        h.data_ptr(), g.data_ptr(), dh.data_ptr(), N, C, hh, ww,
        int(combine), *h.stride(), *g.stride(), bias * bias,
        _cuda.stream_of(h)))
    scat_mag_bwd.launches += 1
    return dh


scat_mag_fwd.launches = 0
scat_mag_bwd.launches = 0

