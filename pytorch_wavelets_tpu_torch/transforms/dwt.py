"""Multilevel 2-D and 1-D DWT/IDWT with the reference's backwards, and
the SWT with its exact least-squares inverse (port of
``pytorch_wavelets_tpu/transforms/dwt.py``).

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
backward is not ported (ROADMAP.md, A4).

The SWT (:func:`swt2d` / :func:`iswt2d`) is differentiated by autodiff in
the JAX package; here each level of the forward and each least-squares
merge of the inverse is an autograd Function whose backward is the true
transpose (see their docstrings).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from pytorch_wavelets_tpu_torch.filters import wavelet as _resolve_wavelet
from pytorch_wavelets_tpu_torch.ops import banded
from pytorch_wavelets_tpu_torch.ops.afb_sfb import (
    _AFB2DAtrous, _afb2d_corr, _afb_atrous_matrix, _sfb2d_conv,
    afb1d_corr, as_taps, sfb1d_conv,
)
from pytorch_wavelets_tpu_torch.ops.banded import apply_col, apply_row
from pytorch_wavelets_tpu_torch.ops.iswt_merge import spec_merge, spec_split
from pytorch_wavelets_tpu_torch.ops.precision import (
    get_matmul_precision, matmul_precision,
)
from pytorch_wavelets_tpu_torch.transforms.plan_cache import (
    budgeted_plan_cache,
)

__all__ = ["dwt2d", "idwt2d", "dwt1d", "idwt1d", "swt2d", "iswt2d",
           "dec_filters", "rec_filters"]


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


# --------------------------------------------------------------------------
# SWT: one level of the forward as an autograd Function
# --------------------------------------------------------------------------

def swt2d(x, wave="db1", J=1, mode="periodization"):
    """J-level stationary (undecimated) 2-D wavelet transform.

    Returns a list of per-scale (N, C, 4, H, W) stacks ordered
    (LL, LH, HL, HH) — reference SWTForward (dwt/transform2d.py:151-212).
    Level j + 1 reads level j's LL band in place (a view).  On CUDA every
    level is two K12 launches (the direct stencil, as the port's DWT);
    ``banded.set_operator_matmul`` does not change this route (the JAX
    package runs the forward as operator products on a device,
    ``afb2d_atrous`` l.436-441)."""
    h0c, h1c, h0r, h1r = dec_filters(wave)
    taps = (_rev(h0c), _rev(h1c), _rev(h0r), _rev(h1r))
    ll = x
    coeffs = []
    for j in range(J):
        y = _AFB2DAtrous.apply(ll, taps, mode, 2 ** j)
        coeffs.append(y)
        ll = y[:, :, 0]
    return coeffs


# --------------------------------------------------------------------------
# ISWT: the least-squares merge per axis (B10)
# --------------------------------------------------------------------------

# The JAX package's value, kept so that each axis length takes the same
# branch in both packages: the dense pinv operator up to this length;
# beyond it the FFT merge for circular modes and banded normal equations
# otherwise (whether another threshold suits the H100 is not measured).
_ISWT_PINV_MAX_N = 2048
_CIRCULAR = ("per", "periodization", "periodic")


def _atrous_impulse_response(taps, dilation, n):
    """First column of the circulant à trous analysis operator at length
    ``n`` (y[m] = sum_j taps[j] x[(m - (L2 - d) + j d) mod n])."""
    taps = np.asarray(taps, dtype=np.float64)
    L = len(taps)
    L2 = (L * dilation) // 2
    col = np.zeros(n)
    for j, t in enumerate(taps):
        col[(L2 - dilation - j * dilation) % n] += t
    return col


@lru_cache(maxsize=None)
def _iswt_fft_filters(rh0, rh1, dilation, n):
    """(conj(F0) / (|F0|^2 + |F1|^2), same for F1) at length ``n``, kept
    in complex128 and cast at use."""
    F0 = np.fft.fft(_atrous_impulse_response(rh0, dilation, n))
    F1 = np.fft.fft(_atrous_impulse_response(rh1, dilation, n))
    inv_denom = 1.0 / (np.abs(F0) ** 2 + np.abs(F1) ** 2)
    return np.conj(F0) * inv_denom, np.conj(F1) * inv_denom


@lru_cache(maxsize=None)
def _iswt_banded_ls(rh0, rh1, mode, dilation, n, x64):
    """(T^T, G^{-1}) for the least-squares merge of a non-circular à trous
    split at long axis lengths: the Gram G = T^T T of the banded (2n x n)
    analysis operator T, factored by scipy's banded Cholesky (O(n band^2)
    host work instead of the dense SVD's O(n^3)), and solved against the
    identity for the dense G^{-1}.  T^+ = G^{-1} T^T for full-column-rank
    T.  float64, cast at use."""
    from scipy.linalg import cho_solve_banded, cholesky_banded
    T = np.asarray(_afb_atrous_matrix(rh0, rh1, mode, dilation, n,
                                      "f8" if x64 else "f4"),
                   dtype=np.float64)
    G = banded.compose(T.T, T)
    nz = np.abs(G) > (np.abs(G).max() * 1e-14)
    ii, jj = np.nonzero(nz)
    b = int(np.max(jj - ii)) if ii.size else 0
    ab = np.zeros((b + 1, n))
    for k in range(b + 1):                       # upper banded storage
        ab[b - k, k:] = np.diagonal(G, k)
    cf = cholesky_banded(ab, lower=False)
    Ginv = cho_solve_banded((cf, False), np.eye(n))
    return np.ascontiguousarray(T.T), np.ascontiguousarray(Ginv)


@lru_cache(maxsize=None)
def _iswt_pinv(rh0, rh1, mode, dilation, n, x64):
    """The (n, 2n) float64 pseudo-inverse of the probed analysis operator
    (probed in float64 for float64 inputs: the pinv of an fp32-rounded
    probe caps round trips at ~1e-7)."""
    T = _afb_atrous_matrix(rh0, rh1, mode, dilation, n,
                           "f8" if x64 else "f4")
    return np.linalg.pinv(np.asarray(T, dtype=np.float64))


def _k1_ready(t, axis):
    """``t`` if K1 reads it in place along ``axis`` (unit stride along W;
    uniformly strided planes for the column entry, rows for the row
    entry), else a contiguous copy of it."""
    if not t.is_cuda:
        return t
    outer = 2 if axis == 2 else 3
    if ((t.shape[3] == 1 or t.stride(3) == 1) and banded._merged_stride(
            t.shape[:outer], t.stride()[:outer]) is not None):
        return t
    return t.contiguous()


class _OperatorMerge:
    """The pinv and banded-LS branches: z = B (A_lo lo + A_hi hi) along the
    axis, with A = [A_lo | A_hi] (n x 2m) and B (n x n) or none, all K1
    products (column entry along H, row entry along W; the hi product
    accumulates onto the lo one).  Its transpose: [dlo; dhi] = A^T (B^T g),
    one K1 product per operator, the result split in place."""

    def __init__(self, A, B, device, dtype):
        m = A.shape[1] // 2
        op = lambda T: banded.Operator(T, device, dtype)     # noqa: E731
        self.m = m
        self.A = (op(A[:, :m]), op(A[:, m:]))
        self.At = op(A.T)
        self.B = None if B is None else (op(B), op(B.T))
        self.nbytes = sum(o.nbytes for o in (*self.A, self.At,
                                             *(self.B or ())))

    def merge(self, lo, hi, axis):
        apply = apply_col if axis == 2 else apply_row
        z = apply(_k1_ready(lo, axis), self.A[0])
        z = apply(_k1_ready(hi, axis), self.A[1], z, True)
        return z if self.B is None else apply(z, self.B[0])

    def split(self, g, axis):
        apply = apply_col if axis == 2 else apply_row
        g = _k1_ready(g, axis)
        if self.B is not None:
            g = apply(g, self.B[1])
        d = apply(g, self.At)
        return d.narrow(axis, 0, self.m), d.narrow(axis, self.m, self.m)


class _FFTMerge:
    """The FFT branch (circular modes past ``_ISWT_PINV_MAX_N``): the
    circulant least-squares merge on the half spectrum, ``irfft(G0 A + G1
    B)`` with A, B the ``rfft`` of lo and hi (K13 ``spec_merge``); its
    transpose ``irfft(conj(G) rfft(g))`` per band (K13 ``spec_split``).
    The filters of real taps are Hermitian, so the half spectrum holds
    what the JAX ``ifft(...).real`` keeps."""

    def __init__(self, G0, G1, n, device, dtype):
        # complex128 for float64, else complex64 (sub-fp32 inputs merge in
        # fp32 and are cast back, as the JAX merge casts its result)
        x64 = dtype == torch.float64
        self.real = torch.float64 if x64 else torch.float32
        cdt = torch.complex128 if x64 else torch.complex64
        nf = n // 2 + 1
        self.n = n
        self.g = [torch.as_tensor(np.ascontiguousarray(G[:nf]), dtype=cdt,
                                  device=device) for G in (G0, G1)]
        self.nbytes = sum(g.nbytes for g in self.g)

    def _irfft(self, S, dim):
        # along the last dimension of a view: K13 writes the frequency
        # axis innermost, as rfft left it (ops/iswt_merge.py), so the
        # view is contiguous and PyTorch's c2r path copies it once (its
        # clone) instead of transposing it as well; the result has the
        # layout irfft(S, dim=dim) returns
        return torch.fft.irfft(S.movedim(dim, -1), n=self.n,
                               dim=-1).movedim(-1, dim)

    def merge(self, lo, hi, axis):
        A = torch.fft.rfft(lo.to(self.real), dim=axis)
        B = torch.fft.rfft(hi.to(self.real), dim=axis)
        z = self._irfft(spec_merge(A, B, *self.g, axis), axis)
        return z.to(lo.dtype)

    def split(self, g, axis):
        S = spec_split(torch.fft.rfft(g.to(self.real), dim=axis), *self.g,
                       axis)
        d = self._irfft(S, axis + 1).to(g.dtype)
        return d[0], d[1]


@budgeted_plan_cache   # entries hold an axis's operators on one device
def _merge_plan(taps, dilation, mode, n, device, dtype):
    """The merge of one axis length, branch and device (the host operators
    are cached apart, by their own arguments, as the JAX package caches
    them)."""
    x64 = dtype == torch.float64
    odt = np.float64 if x64 and device.type == "cpu" else np.float32
    if n <= _ISWT_PINV_MAX_N:
        return _OperatorMerge(_iswt_pinv(*taps, mode, dilation, n, x64),
                              None, device, odt)
    if mode in _CIRCULAR:
        return _FFTMerge(*_iswt_fft_filters(*taps, dilation, n), n, device,
                         dtype)
    Tt, Ginv = _iswt_banded_ls(*taps, mode, dilation, n, x64)
    return _OperatorMerge(Tt, Ginv, device, odt)


class _LSMerge(torch.autograd.Function):
    """The least-squares two-band merge along ``axis`` (the JAX
    ``_ls_merge``): lo, hi -> z with the merge ``plan``'s branch.
    Backward: the plan's exact transpose, at the matmul precision level
    of the forward."""

    @staticmethod
    def forward(ctx, lo, hi, plan, axis):
        ctx.plan, ctx.axis = plan, axis
        ctx.level = get_matmul_precision()
        return plan.merge(lo, hi, axis)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with matmul_precision(ctx.level):
            dlo, dhi = ctx.plan.split(g, ctx.axis)
        return dlo, dhi, None, None


def ls_merge(lo, hi, taps, dilation, axis, mode):
    """Least-squares merge of the à trous split ``taps`` (correlation-order
    (h0, h1) tuples) along ``axis`` of (N, C, H, W) ``lo`` and ``hi``: the
    dense pinv operator (K1) up to ``_ISWT_PINV_MAX_N`` samples, beyond it
    the FFT merge (cuFFT + K13) for circular modes and banded normal
    equations (K1 with T^T, then K1 with the dense G^{-1}) otherwise."""
    if lo.is_cuda and lo.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"iswt2d: the CUDA kernels take float32 or "
                        f"bfloat16, got {lo.dtype}")
    plan = _merge_plan(taps, dilation, mode, lo.shape[axis], lo.device,
                       lo.dtype)
    return _LSMerge.apply(lo, hi, plan, axis)


def iswt2d(coeffs, wave="db1", mode="periodization"):
    """Inverse SWT: the exact (least-squares) inverse of :func:`swt2d` for
    every boundary mode, per level from the coarsest: two column merges
    (LL with LH, HL with HH), then the row merge of their results.

    ``wave`` must resolve to the *analysis* filters used by swt2d.  The
    operators are built on the host at first use of an axis length (a
    float64 SVD up to 2048 samples, a banded Cholesky beyond) and cached
    per device."""
    h0c, h1c, h0r, h1r = dec_filters(wave)
    tc = (_tup(_rev(h0c)), _tup(_rev(h1c)))
    tr = (_tup(_rev(h0r)), _tup(_rev(h1r)))
    ll = coeffs[-1][:, :, 0]
    for j in range(len(coeffs) - 1, -1, -1):
        y = coeffs[j]
        d = 2 ** j
        lo_r = ls_merge(ll, y[:, :, 1], tc, d, 2, mode)
        hi_r = ls_merge(y[:, :, 2], y[:, :, 3], tc, d, 2, mode)
        ll = ls_merge(lo_r, hi_r, tr, d, 3, mode)
    return ll
