"""Multilevel 2-D and 1-D DWT/IDWT with the reference's backwards
(port of ``pytorch_wavelets_tpu/transforms/dwt.py``, the DWT part).

The backward of an analysis step is the synthesis step run with the
*time-reversed analysis* filters, and the backward of a synthesis step is
the analysis step with the synthesis filters as correlation taps, both
cropped to the shape of what they differentiate: the reference's
``AFB2D.backward`` / ``SFB2D.backward`` (dwt/lowlevel.py:349-365,
682-694), which the JAX package carries as ``jax.custom_vjp``s.  They
ignore the boundary fold, so they equal the true adjoint only in 'zero'
mode (and 'periodization' at even sizes): autograd of the forward would
give another gradient.  Here each step is a ``torch.autograd.Function``
that saves no activations; forward and backward call the same
dispatching wrappers (``ops/afb_sfb.py``: K6 and K7 on CUDA, their plain
versions on the CPU).  The backwards are ``once_differentiable``: double
backward is not ported (ROADMAP.md, "Still to port" 10).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from pytorch_wavelets_tpu_torch.filters import wavelet as _resolve_wavelet
from pytorch_wavelets_tpu_torch.ops.afb_sfb import (
    _afb2d_corr, _sfb2d_conv, afb1d_corr, as_taps, sfb1d_conv,
)

__all__ = ["dwt2d", "idwt2d", "dwt1d", "idwt1d", "dec_filters",
           "rec_filters"]


def _tup(h) -> tuple:
    return tuple(float(v) for v in as_taps(h))


def _filters(wave, lo, hi):
    """The (lo, hi, lo, hi) or 4-tuple of pywt-ordered tap tuples of
    ``wave``, reading the attributes ``lo``/``hi`` of a Wavelet."""
    if isinstance(wave, str):
        w = _resolve_wavelet(wave)
        f0, f1 = _tup(getattr(w, lo)), _tup(getattr(w, hi))
        return f0, f1, f0, f1
    if hasattr(wave, lo) and hasattr(wave, hi):
        f0, f1 = _tup(getattr(wave, lo)), _tup(getattr(wave, hi))
        return f0, f1, f0, f1
    if len(wave) == 2:
        f0, f1 = _tup(wave[0]), _tup(wave[1])
        return f0, f1, f0, f1
    if len(wave) == 4:
        return tuple(_tup(f) for f in wave)
    raise ValueError("wave must be a name, Wavelet, 2-tuple or 4-tuple")


def dec_filters(wave):
    """Resolve ``wave`` (name / Wavelet / 2-tuple / 4-tuple of arrays) to
    (h0_col, h1_col, h0_row, h1_row) analysis tap tuples, pywt order.

    Wavelet objects are duck-typed: anything exposing ``.dec_lo/.dec_hi``
    (this package's :class:`Wavelet` or a ``pywt.Wavelet``) is accepted,
    as the reference accepts a ``pywt.Wavelet``
    (pytorch_wavelets/dwt/transform2d.py:22-25)."""
    return _filters(wave, "dec_lo", "dec_hi")


def rec_filters(wave):
    """Synthesis twin of :func:`dec_filters` (duck-typed on
    ``.rec_lo/.rec_hi`` the same way)."""
    return _filters(wave, "rec_lo", "rec_hi")


def _rev(t: tuple) -> np.ndarray:
    return np.asarray(t, dtype=np.float64)[::-1]


def _fwdarr(t: tuple) -> np.ndarray:
    return np.asarray(t, dtype=np.float64)


# --------------------------------------------------------------------------
# One level as an autograd Function
# --------------------------------------------------------------------------

class _AFB2D(torch.autograd.Function):
    """One level of 2-D analysis: x -> (low, highs (N, C, 3, H', W')), with
    correlation-order taps (h0c, h1c, h0r, h1r).  Backward (the JAX
    ``_make_afb2d_op`` bwd): synthesis with the same taps as convolution
    taps, cropped to the input's shape."""

    @staticmethod
    def forward(ctx, x, taps, mode):
        ctx.taps, ctx.mode, ctx.in_shape = taps, mode, tuple(x.shape[-2:])
        y = _afb2d_corr(x, *taps, mode)
        return y[:, :, 0], y[:, :, 1:]

    @staticmethod
    @once_differentiable
    def backward(ctx, dlow, dhighs):
        rh0c, rh1c, rh0r, rh1r = ctx.taps
        H, W = ctx.in_shape
        # the columns cropped to H before the row merge, which works per
        # row: the same as cropping its output
        lo = sfb1d_conv(dlow, dhighs[:, :, 0], rh0c, rh1c, ctx.mode, 2, H)
        hi = sfb1d_conv(dhighs[:, :, 1], dhighs[:, :, 2], rh0c, rh1c,
                        ctx.mode, 2, H)
        return sfb1d_conv(lo, hi, rh0r, rh1r, ctx.mode, 3, W), None, None


class _SFB2D(torch.autograd.Function):
    """One level of 2-D synthesis: (low, highs) -> x, with convolution-order
    taps (g0c, g1c, g0r, g1r).  Backward (the JAX ``_make_sfb2d_op`` bwd):
    analysis with the synthesis taps as correlation taps, cropped to the
    coefficients' shape ``out_crop``."""

    @staticmethod
    def forward(ctx, low, highs, taps, mode, out_crop):
        ctx.taps, ctx.mode, ctx.out_crop = taps, mode, out_crop
        return _sfb2d_conv(low, highs[:, :, 0], highs[:, :, 1],
                           highs[:, :, 2], *taps, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        g0c, g1c, g0r, g1r = ctx.taps
        Hc, Wc = ctx.out_crop
        N, C = dy.shape[:2]
        # the rows cropped to Wc before the column split, which works per
        # column: the same as cropping its output
        lohi = afb1d_corr(dy, g0r, g1r, ctx.mode, 3, Wc)
        lohi = lohi.reshape(N, C * 2, *lohi.shape[3:])
        d4 = afb1d_corr(lohi, g0c, g1c, ctx.mode, 2, Hc)
        d4 = d4.reshape(N, C, 4, *d4.shape[3:])
        return d4[:, :, 0], d4[:, :, 1:], None, None, None


class _AFB1D(torch.autograd.Function):
    """1-D analysis on (N, C, L): x -> (x_lo, x_hi) (reference AFB1D,
    dwt/lowlevel.py:368-424), correlation-order taps (h0, h1)."""

    @staticmethod
    def forward(ctx, x, taps, mode):
        ctx.taps, ctx.mode, ctx.in_len = taps, mode, x.shape[-1]
        lohi = afb1d_corr(x[:, :, None, :], *taps, mode, 3)  # (N,C,2,1,L')
        return lohi[:, :, 0, 0], lohi[:, :, 1, 0]

    @staticmethod
    @once_differentiable
    def backward(ctx, d0, d1):
        dx = sfb1d_conv(d0[:, :, None, :], d1[:, :, None, :], *ctx.taps,
                        ctx.mode, 3, ctx.in_len)
        return dx[:, :, 0], None, None


class _SFB1D(torch.autograd.Function):
    """1-D synthesis on (N, C, L) pairs, convolution-order taps (g0, g1);
    backward cropped to ``out_crop``."""

    @staticmethod
    def forward(ctx, lo, hi, taps, mode, out_crop):
        ctx.taps, ctx.mode, ctx.out_crop = taps, mode, out_crop
        return sfb1d_conv(lo[:, :, None, :], hi[:, :, None, :], *taps, mode,
                          3)[:, :, 0]

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        lohi = afb1d_corr(dy[:, :, None, :], *ctx.taps, ctx.mode, 3,
                          ctx.out_crop)
        return lohi[:, :, 0, 0], lohi[:, :, 1, 0], None, None, None


# --------------------------------------------------------------------------
# Multilevel functional transforms
# --------------------------------------------------------------------------

def dwt2d(x, wave="db1", J=1, mode="zero"):
    """J-level 2-D DWT of an NCHW tensor.

    Returns ``(yl, yh)`` with ``yh`` a finest-first list of (N, C, 3, H, W)
    stacks ordered (LH, HL, HH) — same pyramid as reference DWTForward
    (dwt/transform2d.py:44-74).  Each level's lowpass and highs are views
    of one (N, C, 4, H', W') tensor; the next level reads the lowpass in
    place."""
    h0c, h1c, h0r, h1r = dec_filters(wave)
    # The reference feeds its "col" buffers into AFB2D's *row* argument
    # slots (dwt/transform2d.py:70-71 vs dwt/lowlevel.py:336), so the first
    # pair of a 4-tuple wave filters along W.  Replicated here by swapping
    # the pairs (invisible when col == row filters).
    taps = (_rev(h0r), _rev(h1r), _rev(h0c), _rev(h1c))
    yh = []
    ll = x
    for _ in range(J):
        ll, high = _AFB2D.apply(ll, taps, mode)
        yh.append(high)
    return ll, yh


def idwt2d(coeffs, wave="db1", mode="zero"):
    """Inverse of :func:`dwt2d`; accepts None highpasses as zeros and crops
    odd-size lowpasses like reference DWTInverse
    (dwt/transform2d.py:131-148)."""
    yl, yh = coeffs
    g0c, g1c, g0r, g1r = rec_filters(wave)
    # pair swap mirroring the reference's SFB2D argument-order quirk
    # (dwt/transform2d.py:146-147 vs dwt/lowlevel.py:671)
    taps = (_fwdarr(g0r), _fwdarr(g1r), _fwdarr(g0c), _fwdarr(g1c))
    ll = yl
    for h in yh[::-1]:
        if h is None:
            h = ll.new_zeros((ll.shape[0], ll.shape[1], 3, ll.shape[-2],
                              ll.shape[-1]))
        if ll.shape[-2] > h.shape[-2]:
            ll = ll[..., :-1, :]
        if ll.shape[-1] > h.shape[-1]:
            ll = ll[..., :-1]
        ll = _SFB2D.apply(ll, h, taps, mode, (h.shape[-2], h.shape[-1]))
    return ll


def dwt1d(x, wave="db1", J=1, mode="zero"):
    """J-level 1-D DWT of an (N, C, L) tensor; returns (x0, [x1 ...])
    finest-first (reference DWT1DForward, dwt/transform1d.py:7-59)."""
    if x.ndim != 3:
        raise ValueError("dwt1d expects a 3-D (N, C, L) input")
    h0, h1, _, _ = dec_filters(wave)
    taps = (_rev(h0), _rev(h1))
    highs = []
    x0 = x
    for _ in range(J):
        x0, x1 = _AFB1D.apply(x0, taps, mode)
        highs.append(x1)
    return x0, highs


def idwt1d(coeffs, wave="db1", mode="zero"):
    """Inverse of :func:`dwt1d`; None highpasses are zeros."""
    x0, highs = coeffs
    if x0.ndim != 3:
        raise ValueError("idwt1d expects 3-D (N, C, L) inputs")
    g0, g1, _, _ = rec_filters(wave)
    taps = (_fwdarr(g0), _fwdarr(g1))
    for x1 in highs[::-1]:
        if x1 is None:
            x1 = torch.zeros_like(x0)
        if x0.shape[-1] > x1.shape[-1]:
            x0 = x0[..., :-1]
        x0 = _SFB1D.apply(x0, x1, taps, mode, x1.shape[-1])
    return x0
