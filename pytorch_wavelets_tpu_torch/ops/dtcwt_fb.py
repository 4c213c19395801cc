"""DTCWT filters on the host: the conv path that defines the operator
matrices, and the quad<->complex corner maps.

Port of ``pytorch_wavelets_tpu/ops/dtcwt_fb.py`` (reference semantics:
pytorch_wavelets/dtcwt/lowlevel.py:70-295).  In this slice the conv path
runs only on the host CPU, as the probe source of ``_filter_matrix`` /
``_dfilt_matrix`` / ``_ifilt_matrix`` (``ops/banded.py:probe_op``); on the
device every filter is an operator-matrix product (``ops/banded.py``).
A direct-stencil device kernel (B7) is ROADMAP.md, "Still to port" 2.

Tap convention: functions here take taps in *application (correlation)
order*.  Use :func:`prep_taps` to go from bank arrays to application
order.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_wavelets_tpu_torch.ops import banded
from pytorch_wavelets_tpu_torch.ops.afb_sfb import _conv_axis, _ext_ns, as_taps
from pytorch_wavelets_tpu_torch.ops.pad import pad1d

__all__ = ["prep_taps", "q2c", "c2q"]


def prep_taps(h) -> np.ndarray:
    """Coefficient-bank column vector -> correlation-order tap vector
    (the reference's prep_filt reversal, dtcwt/lowlevel.py:58-67)."""
    return as_taps(h)[::-1].copy()


def _sl(x, start, stop, axis):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop, 2)
    return x[tuple(idx)]


@lru_cache(maxsize=None)
def _filter_matrix(taps, mode, n):
    return banded.synthesized_or_probe(
        lambda m: banded.probe_op(
            lambda I: _filter_axis_conv(I, np.asarray(taps), 2, mode), m),
        n, _ext_ns(len(taps)), 1, 1, (1, 1))


def _filter_axis_conv(x, taps, axis, mode):
    """Non-decimated filter along ``axis`` with symmetric or zero boundary:
    output length N (odd taps) or N + 1 (even taps)."""
    taps = np.asarray(taps, dtype=np.float64)
    L = len(taps)
    m = L // 2
    k = taps.reshape(1, L)
    xp = pad1d(x, m, m, axis, "symmetric" if mode == "symmetric" else "zero")
    return _conv_axis(xp, k, axis)[:, :, 0]


@lru_cache(maxsize=None)
def _dfilt_matrix(ha, hb, highpass, n):
    return banded.synthesized_or_probe(
        lambda m: banded.probe_op(
            lambda I: _dfilt_axis_conv(I, np.asarray(ha), np.asarray(hb),
                                       highpass, "symmetric", 2), m),
        n, _ext_ns(len(ha)), 1, 1, (2, 4))


def _dfilt_axis_conv(x, ha_taps, hb_taps, highpass, mode, axis):
    """Quarter-shift decimating filter along ``axis``: N -> N/2 (reference
    coldfilt/rowdfilt, dtcwt/lowlevel.py:97-151)."""
    axis = axis % 4
    n = x.shape[axis]
    ha = np.asarray(ha_taps, dtype=np.float64)
    hb = np.asarray(hb_taps, dtype=np.float64)
    m = len(ha)
    # pad symmetric by m; padded index i corresponds to reflect index i - m
    xp = pad1d(x, m, m, axis, "symmetric")
    P = xp.shape[axis]
    # stream "even": padded positions 2, 4, ...; stream "odd": 3, 5, ...
    streams = torch.stack([_sl(xp, 2, P - 1, axis), _sl(xp, 3, P, axis)],
                          dim=2)                       # (N, C, 2, H', W')
    N, C = x.shape[:2]
    streams = streams.reshape(N, C * 2, *streams.shape[3:])
    kernels = np.zeros((2, 2, m))
    kernels[0, 0] = ha
    kernels[1, 1] = hb
    y = _conv_grouped_pair(streams, kernels, axis, stride=2)
    ya, yb = y[:, :, 0], y[:, :, 1]
    first, second = (yb, ya) if highpass else (ya, yb)
    out = torch.stack([first, second], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = n // 2
    return out.reshape(shape)


def _conv_grouped_pair(x, kernels, axis, stride):
    """x: (N, 2C, H, W) where channels alternate (stream_e, stream_o) pairs;
    kernels: (2, 2, m) block-diagonal.  Returns (N, C, 2, H', W')."""
    N, C2 = x.shape[:2]
    C = C2 // 2
    xr = x.reshape(N * C, 2, *x.shape[2:])
    m = kernels.shape[-1]
    if axis == 2:
        w = kernels.reshape(2, 2, m, 1)
        strides = (stride, 1)
    else:
        w = kernels.reshape(2, 2, 1, m)
        strides = (1, stride)
    y = F.conv2d(xr, torch.as_tensor(w, dtype=x.dtype, device=x.device),
                 stride=strides)
    return y.reshape(N, C, 2, *y.shape[2:])


@lru_cache(maxsize=None)
def _ifilt_matrix(ha, hb, highpass, n):
    return banded.synthesized_or_probe(
        lambda m: banded.probe_op(
            lambda I: _ifilt_axis_conv(I, np.asarray(ha), np.asarray(hb),
                                       highpass, "symmetric", 2), m),
        n, _ext_ns(len(ha)), 1, 1, (4, 2))


def _ifilt_axis_conv(x, ha_taps, hb_taps, highpass, mode, axis):
    """Quarter-shift interpolating filter along ``axis``: N -> 2N (reference
    colifilt/rowifilt, dtcwt/lowlevel.py:154-239): four phase streams
    with odd and even taps, then a 4-way interleave."""
    axis = axis % 4
    n = x.shape[axis]
    ha = np.asarray(ha_taps, dtype=np.float64)
    hb = np.asarray(hb_taps, dtype=np.float64)
    m = len(ha)
    m2 = m // 2
    hao, hae = ha[1::2], ha[0::2]
    hbo, hbe = hb[1::2], hb[0::2]
    xp = pad1d(x, m2, m2, axis, "symmetric")  # index i -> reflect(i - m2)
    P = xp.shape[axis]

    def sl(start, stop_offset):
        return _sl(xp, start, P + stop_offset, axis)

    if m2 % 2 == 0:
        filts = (hae, hbe, hao, hbo)
        if highpass:
            phases = (sl(1, -2), sl(0, -2), sl(3, 0), sl(2, 0))
        else:
            phases = (sl(0, -2), sl(1, -2), sl(2, 0), sl(3, 0))
    else:
        filts = (hao, hbo, hae, hbe)
        if highpass:
            phases = (sl(2, -1), sl(1, -1), sl(2, -1), sl(1, -1))
        else:
            phases = (sl(1, -1), sl(2, -1), sl(1, -1), sl(2, -1))

    N, C = x.shape[:2]
    streams = torch.stack(phases, dim=2)  # (N, C, 4, H', W')
    streams = streams.reshape(N, C * 4, *streams.shape[3:])
    Lf = len(filts[0])
    kernels = np.zeros((4, 4, Lf))
    for i, f in enumerate(filts):
        kernels[i, i] = f
    y = _conv_quad(streams, kernels, axis)
    # interleave the 4 phase outputs -> length 2n
    y = torch.movedim(y, 2, axis + 1)  # (..., n2, 4, ...) along axis
    shape = list(x.shape)
    shape[axis] = 2 * n
    return y.reshape(shape)


def _conv_quad(x, kernels, axis):
    """x: (N, 4C, H, W) with per-channel 4-phase groups; kernels (4, 4, L)
    block-diagonal.  Returns (N, C, 4, H', W')."""
    N, C4 = x.shape[:2]
    C = C4 // 4
    xr = x.reshape(N * C, 4, *x.shape[2:])
    L = kernels.shape[-1]
    if axis == 2:
        w = kernels.reshape(4, 4, L, 1)
    else:
        w = kernels.reshape(4, 4, 1, L)
    y = F.conv2d(xr, torch.as_tensor(w, dtype=x.dtype, device=x.device))
    return y.reshape(N, C, 4, *y.shape[2:])


_SQRT2 = math.sqrt(2.0)


def q2c(y):
    """Quad corners -> two complex subimages (reference:
    dtcwt/lowlevel.py:243-260).  Returns ((r1, i1), (r2, i2)) where
    (r1, i1) = (a - d, b + c)/sqrt2 and (r2, i2) = (a + d, b - c)/sqrt2."""
    y = y / _SQRT2
    a, b = y[:, :, 0::2, 0::2], y[:, :, 0::2, 1::2]
    c, d = y[:, :, 1::2, 0::2], y[:, :, 1::2, 1::2]
    return ((a - d, b + c), (a + d, b - c))


def c2q(w1, w2):
    """Inverse of :func:`q2c` (reference: dtcwt/lowlevel.py:263-295)."""
    w1r, w1i = w1
    w2r, w2i = w2
    x1 = (w1r + w2r) / _SQRT2
    x2 = (w1i + w2i) / _SQRT2
    x3 = (w1i - w2i) / _SQRT2
    x4 = (w2r - w1r) / _SQRT2
    # interleave 2x2: rows (x1 x2 / x3 x4)
    top = torch.stack([x1, x2], dim=-1)      # (..., r, c, 2)
    bot = torch.stack([x3, x4], dim=-1)
    rows = torch.stack([top, bot], dim=-2)   # (..., r, c, 2, 2)
    b, ch, r, c = w1r.shape
    return rows.permute(0, 1, 2, 4, 3, 5).reshape(b, ch, 2 * r, 2 * c)
