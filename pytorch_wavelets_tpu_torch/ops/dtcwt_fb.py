"""DTCWT filters along one axis, and kernels K8-K10 (B7).

Port of ``pytorch_wavelets_tpu/ops/dtcwt_fb.py`` (reference semantics:
pytorch_wavelets/dtcwt/lowlevel.py:70-295):

- the conv path (``_filter_axis_conv``, ``_dfilt_axis_conv``,
  ``_ifilt_axis_conv``): the JAX package's pad + strided correlations line
  by line.  It is the probe source of the composed path's operator
  matrices (``_filter_matrix`` / ``_dfilt_matrix`` / ``_ifilt_matrix``,
  ``ops/banded.py:probe_op``) and the plain version of each kernel;
- the kernels of the per-level path (``transforms/dtcwt.py``), direct
  stencils that evaluate the symmetric or zero boundary per tap
  (``csrc/dwt_index.cuh:pad_src``) and read and write through strides:
  K8 :func:`dtcwt_filt` (``csrc/dtcwt_filt.cu``, the non-decimated
  filter), K9 :func:`dtcwt_dfilt` (``csrc/dtcwt_dfilt.cu``, the q-shift
  decimation) and K10 :func:`dtcwt_ifilt` (``csrc/dtcwt_ifilt.cu``, the
  q-shift interpolation).  CPU tensors take the plain versions; CUDA
  tensors launch the kernels or raise;
- the JAX dispatchers ``colfilter`` / ``rowfilter``, ``coldfilt`` /
  ``rowdfilt``, ``colifilt`` / ``rowifilt`` with the JAX errors, and an
  ``out`` / ``accumulate`` option for writing into (or adding to) a slice;
- the per-level quad <-> complex maps :func:`q2c` / :func:`c2q`, the
  plain versions of K2/K3's per-level mode (``ops/quad.py``).

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

from pytorch_wavelets_tpu_torch.ops import _cuda, banded
from pytorch_wavelets_tpu_torch.ops.afb_sfb import (
    MAX_TAPS, _check_4d, _conv_axis, _ext_ns, _ptr, as_taps,
)
from pytorch_wavelets_tpu_torch.ops.pad import PAD_CODES, pad1d
from pytorch_wavelets_tpu_torch.ops.precision import plain_flags

__all__ = ["prep_taps", "colfilter", "rowfilter", "coldfilt", "rowdfilt",
           "colifilt", "rowifilt", "q2c", "c2q", "dtcwt_filt", "dtcwt_dfilt",
           "dtcwt_ifilt", "dtcwt_filt_plain", "dtcwt_dfilt_plain",
           "dtcwt_ifilt_plain", "ifilt_plan", "INV_SQRT2"]


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
    with plain_flags():     # IEEE fp32 on the card too (no TF32)
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
    with plain_flags():
        y = F.conv2d(xr, torch.as_tensor(w, dtype=x.dtype,
                                         device=x.device))
    return y.reshape(N, C, 4, *y.shape[2:])


# --------------------------------------------------------------------------
# The kernels K8-K10 and their plain versions
# --------------------------------------------------------------------------

def ifilt_plan(m, highpass):
    """K10's phase table for q-shift taps of even length ``m``: per output
    phase f = o % 4, (start, par): output o = 4q + f is
    sum_k h_f[2k + par] x[src(start + 2q + 2k - m // 2)] with h_f = ha
    for even f, hb for odd f (``_ifilt_axis_conv``'s two branches on the
    parity of m // 2)."""
    if m % 2 or m < 2:
        raise ValueError(f"q-shift filters have an even length, got {m}")
    if (m // 2) % 2 == 0:
        starts = (1, 0, 3, 2) if highpass else (0, 1, 2, 3)
        pars = (0, 0, 1, 1)
    else:
        starts = (2, 1, 2, 1) if highpass else (1, 2, 1, 2)
        pars = (1, 1, 0, 0)
    return tuple(zip(starts, pars))


def _into(y, out, accumulate):
    """The plain versions' result, returned or written into ``out``."""
    if out is None:
        return y
    if tuple(out.shape) != tuple(y.shape):
        raise ValueError(f"out {tuple(out.shape)} does not fit the result "
                         f"{tuple(y.shape)}")
    return out.add_(y) if accumulate else out.copy_(y)


def dtcwt_filt_plain(x, taps, axis, mode, out=None, accumulate=False):
    """Plain PyTorch version of :func:`dtcwt_filt`."""
    return _into(_filter_axis_conv(x, taps, axis, mode), out, accumulate)


def dtcwt_dfilt_plain(x, ha, hb, highpass, axis, out=None):
    """Plain PyTorch version of :func:`dtcwt_dfilt`."""
    return _into(_dfilt_axis_conv(x, ha, hb, highpass, "symmetric", axis),
                 out, False)


def dtcwt_ifilt_plain(x, ha, hb, highpass, axis, out=None,
                      accumulate=False):
    """Plain PyTorch version of :func:`dtcwt_ifilt`."""
    return _into(_ifilt_axis_conv(x, ha, hb, highpass, "symmetric", axis),
                 out, accumulate)


def _taps32(kernel, *taps):
    ts = [np.ascontiguousarray(np.asarray(t, dtype=np.float64).ravel(),
                               dtype=np.float32) for t in taps]
    if any(len(t) != len(ts[0]) for t in ts) or not 0 < len(ts[0]) <= \
            MAX_TAPS:
        raise ValueError(f"{kernel}: tap vectors of one length in "
                         f"1..{MAX_TAPS} expected, got "
                         f"{[len(t) for t in ts]}")
    return ts


def _out_for(kernel, x, shape, out):
    if out is None:
        return torch.empty(shape, device=x.device, dtype=torch.float32)
    _cuda.check_inputs(kernel, out)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"{kernel}: out {tuple(out.shape)} does not fit "
                         f"the result {tuple(shape)}")
    return out


def dtcwt_filt(x, taps, axis, mode, out=None, accumulate=False):
    """Non-decimated filter of (N, C, H, W) ``x`` along ``axis`` (2 or 3)
    with correlation-order taps, symmetric boundary for
    ``mode == "symmetric"`` and zero otherwise: n outputs along the axis
    (odd taps) or n + 1 (even).  With ``out`` the result is written into
    it (any strides), or added to it with ``accumulate``.  CPU tensors
    take :func:`dtcwt_filt_plain`; CUDA tensors launch K8, which reads
    ``x`` through its strides."""
    axis = axis % 4
    if x.device.type == "cpu":
        return dtcwt_filt_plain(x, taps, axis, mode, out, accumulate)
    _cuda.check_inputs("dtcwt_filt", x)
    _check_4d("dtcwt_filt", axis, x)
    t, = _taps32("dtcwt_filt", taps)
    L = len(t)
    shape = list(x.shape)
    shape[axis] += 1 - L % 2
    y = _out_for("dtcwt_filt", x, shape, out)
    if y.numel() == 0:
        return y
    code = PAD_CODES["symmetric" if mode == "symmetric" else "zero"]
    lib = _cuda.library("dtcwt_filt")
    _cuda.check(lib, "dtcwt_filt", lib.dtcwt_filt(
        x.data_ptr(), y.data_ptr(), _ptr(t), L, *x.shape, *x.stride(), axis,
        code, int(accumulate), *y.stride(), _cuda.stream_of(x)))
    _K8.launches += 1
    return y


def dtcwt_dfilt(x, ha, hb, highpass, axis, out=None):
    """Q-shift decimation of (N, C, H, W) ``x`` along ``axis`` (a multiple
    of 4 long) by the tap pair (ha, hb), symmetric boundary, (b, a)
    interleave with ``highpass``: n/2 outputs, into ``out`` if given.
    CPU tensors take :func:`dtcwt_dfilt_plain`; CUDA tensors launch K9."""
    axis = axis % 4
    if x.device.type == "cpu":
        return dtcwt_dfilt_plain(x, ha, hb, highpass, axis, out)
    _cuda.check_inputs("dtcwt_dfilt", x)
    _check_4d("dtcwt_dfilt", axis, x)
    a, b = _taps32("dtcwt_dfilt", ha, hb)
    n = x.shape[axis]
    if n % 4:
        raise ValueError(f"dtcwt_dfilt: axis length {n} is not a multiple "
                         f"of 4")
    shape = list(x.shape)
    shape[axis] = n // 2
    y = _out_for("dtcwt_dfilt", x, shape, out)
    if y.numel() == 0:
        return y
    lib = _cuda.library("dtcwt_dfilt")
    _cuda.check(lib, "dtcwt_dfilt", lib.dtcwt_dfilt(
        x.data_ptr(), y.data_ptr(), _ptr(a), _ptr(b), len(a), int(highpass),
        *x.shape, *x.stride(), axis, *y.stride(), _cuda.stream_of(x)))
    _K9.launches += 1
    return y


def dtcwt_ifilt(x, ha, hb, highpass, axis, out=None, accumulate=False):
    """Q-shift interpolation of (N, C, H, W) ``x`` along ``axis`` by the
    tap pair (ha, hb) (even length), symmetric boundary: 2n outputs,
    into ``out`` if given, added to it with ``accumulate``.  CPU tensors
    take :func:`dtcwt_ifilt_plain`; CUDA tensors launch K10."""
    axis = axis % 4
    if x.device.type == "cpu":
        return dtcwt_ifilt_plain(x, ha, hb, highpass, axis, out, accumulate)
    _cuda.check_inputs("dtcwt_ifilt", x)
    _check_4d("dtcwt_ifilt", axis, x)
    a, b = _taps32("dtcwt_ifilt", ha, hb)
    plan = 0
    for f, (start, par) in enumerate(ifilt_plan(len(a), highpass)):
        plan |= ((start << 1) | par) << (3 * f)
    shape = list(x.shape)
    shape[axis] *= 2
    y = _out_for("dtcwt_ifilt", x, shape, out)
    if y.numel() == 0:
        return y
    _check_4d("dtcwt_ifilt", axis, y)
    lib = _cuda.library("dtcwt_ifilt")
    _cuda.check(lib, "dtcwt_ifilt", lib.dtcwt_ifilt(
        x.data_ptr(), y.data_ptr(), _ptr(a), _ptr(b), len(a), plan,
        *x.shape, *x.stride(), axis, int(accumulate), *y.stride(),
        _cuda.stream_of(x)))
    _K10.launches += 1
    return y


# The launch counters live on the wrappers; the wrappers reach them
# through these names, so that a caller who swaps a module attribute for a
# wrapper of its own (chip_smoke.py records the calls of a run that way)
# still counts on them.
_K8, _K9, _K10 = dtcwt_filt, dtcwt_dfilt, dtcwt_ifilt
_K8.launches = _K9.launches = _K10.launches = 0


# --------------------------------------------------------------------------
# The JAX dispatchers
# --------------------------------------------------------------------------

def colfilter(x, h_taps, mode="symmetric", out=None, accumulate=False):
    return dtcwt_filt(x, h_taps, 2, mode, out, accumulate)


def rowfilter(x, h_taps, mode="symmetric", out=None, accumulate=False):
    return dtcwt_filt(x, h_taps, 3, mode, out, accumulate)


def _dfilt_axis(x, ha_taps, hb_taps, highpass, mode, axis, out=None):
    """Quarter-shift decimating filter along ``axis``: N -> N/2, with the
    JAX package's errors (``_dfilt_axis``)."""
    if mode != "symmetric":
        raise NotImplementedError(
            "q-shift decimating filters only support 'symmetric' mode")
    axis = axis % 4
    n = x.shape[axis]
    if n % 4 != 0:
        raise ValueError(
            f"Length of axis {axis} must be a multiple of 4, got {n}")
    return dtcwt_dfilt(x, ha_taps, hb_taps, highpass, axis, out)


def coldfilt(x, ha_taps, hb_taps, highpass=False, mode="symmetric",
             out=None):
    return _dfilt_axis(x, ha_taps, hb_taps, highpass, mode, 2, out)


def rowdfilt(x, ha_taps, hb_taps, highpass=False, mode="symmetric",
             out=None):
    return _dfilt_axis(x, ha_taps, hb_taps, highpass, mode, 3, out)


def _ifilt_axis(x, ha_taps, hb_taps, highpass, mode, axis, out=None,
                accumulate=False):
    """Quarter-shift interpolating filter along ``axis``: N -> 2N, with
    the JAX package's errors (``_ifilt_axis``)."""
    if mode != "symmetric":
        raise NotImplementedError(
            "q-shift interpolating filters only support 'symmetric' mode")
    axis = axis % 4
    n = x.shape[axis]
    if n % 2 != 0:
        raise ValueError(
            f"Length of axis {axis} must be a multiple of 2, got {n}")
    return dtcwt_ifilt(x, ha_taps, hb_taps, highpass, axis, out, accumulate)


def colifilt(x, ha_taps, hb_taps, highpass=False, mode="symmetric",
             out=None, accumulate=False):
    return _ifilt_axis(x, ha_taps, hb_taps, highpass, mode, 2, out,
                       accumulate)


def rowifilt(x, ha_taps, hb_taps, highpass=False, mode="symmetric",
             out=None, accumulate=False):
    return _ifilt_axis(x, ha_taps, hb_taps, highpass, mode, 3, out,
                       accumulate)


_SQRT2 = math.sqrt(2.0)
# The plain versions divide by sqrt2, as the JAX package does.  On the
# card PyTorch evaluates a division by a scalar as a multiplication by the
# scalar's fp32 reciprocal, fp32(1/sqrt2); K2/K3 multiply by the same
# constant, so the card's plain run and the kernels agree bit for bit.
INV_SQRT2 = 1.0 / _SQRT2


def q2c(y):
    """Quad corners -> two complex subimages (reference:
    dtcwt/lowlevel.py:243-260).  Returns ((r1, i1), (r2, i2)) where
    (r1, i1) = (a - d, b + c)/sqrt2 and (r2, i2) = (a + d, b - c)/sqrt2.
    The plain version of K2's per-level mode (``ops/quad.py``)."""
    if y.shape[-2] % 2 or y.shape[-1] % 2:
        raise ValueError(f"q2c: the corners of a {tuple(y.shape[-2:])} "
                         f"image are not defined (odd size: even-length "
                         f"level-1 filters give odd outputs)")
    y = y / _SQRT2
    a, b = y[:, :, 0::2, 0::2], y[:, :, 0::2, 1::2]
    c, d = y[:, :, 1::2, 0::2], y[:, :, 1::2, 1::2]
    return ((a - d, b + c), (a + d, b - c))


def c2q(w1, w2):
    """Inverse of :func:`q2c` (reference: dtcwt/lowlevel.py:263-295); the
    plain version of K3's per-level mode."""
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
