"""1-D analysis/synthesis filterbanks over one spatial axis of NCHW tensors
(port of ``pytorch_wavelets_tpu/ops/afb_sfb.py``), and kernels K6, K7 and
K12.

The DWT's split and merge along one axis:

- :func:`afb1d_corr` (K6, ``csrc/dwt_afb.cu``): the stride-2 correlation
  of every (N, C) plane with a lowpass and a highpass tap vector, every
  boundary mode folded into the index of each sample (B8a + B9), in
  polyphase windows by column and row tiles;
- :func:`sfb1d_conv` (K7, ``csrc/dwt_sfb.cu``): the transposed stride-2
  correlation of (lo, hi) summed, with the periodization wrap-add and
  roll as index math (B8b + B9), in polyphase output pairs by column and
  row tiles;
- :func:`afb1d_atrous_corr` (K12 ``swt_afb``, ``csrc/swt_atrous.cu``):
  the SWT's undecimated split, taps ``dilation`` samples apart, every
  boundary mode in the index (B8c + B9), and :func:`afb1d_atrous_adjoint`
  (K12 ``swt_afb_adjoint``), its exact transpose, as a gather;
- :func:`sfb1d_atrous_conv` (K16 ``swt_sfb``, ``csrc/swt_atrous.cu``):
  the classic shift-averaged ISWT step, half the sum of the correlations
  of (lo, hi) padded in the mode with the reversed synthesis taps
  ``dilation`` apart (B8c'), and :func:`sfb1d_atrous_adjoint` (K16
  ``swt_sfb_adjoint``), its exact transpose: one tile engine walking
  d-strided subsequences, the adjoint's pad images added from a host
  table (:func:`merge_band_images`).

The sharded conv route's windows (``parallel/sharded_dwt.py``) run the
same kernels through wrappers of their own: :func:`afb1d_window` (K6)
and :func:`sfb1d_window` (K7) with the window plans
:func:`afb_window_plan` / :func:`sfb_window_plan`,
:func:`afb1d_atrous_window` (K12) and :func:`sfb1d_atrous_window` (K16)
with :func:`atrous_window_plan`; their differentiable entries
(:func:`split_window`, :func:`merge_window`, :func:`atrous_split_window`,
:func:`atrous_merge_window`) have the exact adjoints as backwards.

The non-separable ``afb2d_nonsep`` / ``sfb2d_nonsep`` run K14/K15
(``ops/nonsep.py``).

CPU tensors take their plain PyTorch versions, :func:`afb1d_corr_plain`,
:func:`sfb1d_conv_plain`, :func:`afb1d_atrous_corr_plain`, :func:`sfb1d_atrous_conv_plain` and
the adjoints' :func:`afb1d_atrous_adjoint_plain` /
:func:`sfb1d_atrous_adjoint_plain`: the JAX package's conv path
(``_afb1d_corr_conv`` / ``_sfb1d_conv_conv`` /
``_afb1d_atrous_corr_conv`` / ``_sfb1d_atrous_conv_conv``) line by line,
pad and strided or dilated ``conv2d``, and autograd's transpose of the
à trous ones.  CUDA tensors launch
the kernels or raise.  :func:`afb_plan` / :func:`sfb_plan` /
:func:`atrous_plan` / :func:`atrous_merge_plan` give the index plan the
kernels evaluate, :func:`afb_row_outs` / :func:`afb_instantiation` K6's
row segment and tile, :func:`sfb_pairs` / :func:`sfb_row_pairs` /
:func:`sfb_instantiation` K7's output pairs, row segment and tile, and
:func:`merge_row_tile` / :func:`merge_band_images` K16's row tile and
its adjoint's edge table, so the tests can hold them against the plain
versions on the CPU.

Filter-tap convention: every function here takes taps "in application
order", i.e. the correlation kernel; the public :func:`afb1d` /
:func:`sfb1d` / :func:`afb2d` / :func:`sfb2d` take pywt-ordered filters.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_wavelets_tpu_torch.ops import _cuda
from pytorch_wavelets_tpu_torch.ops._linear import linear_backward
from pytorch_wavelets_tpu_torch.ops.pad import PAD_CODES, pad1d, pad_index
from pytorch_wavelets_tpu_torch.ops.precision import plain_flags
from pytorch_wavelets_tpu_torch.utils import dwt_coeff_len

__all__ = ["as_taps", "afb1d", "sfb1d", "afb2d", "sfb2d", "afb1d_atrous",
           "sfb1d_atrous", "afb2d_atrous", "sfb2d_atrous", "afb2d_nonsep",
           "sfb2d_nonsep", "afb1d_corr", "sfb1d_conv", "afb1d_atrous_corr",
           "afb1d_atrous_adjoint", "sfb1d_atrous_conv",
           "sfb1d_atrous_adjoint", "afb1d_corr_plain", "sfb1d_conv_plain",
           "afb1d_atrous_corr_plain", "afb1d_atrous_adjoint_plain",
           "sfb1d_atrous_conv_plain", "sfb1d_atrous_adjoint_plain",
           "afb_plan", "sfb_plan", "atrous_plan", "atrous_merge_plan",
           "merge_row_tile", "merge_band_images", "merge_instantiation",
           "afb_row_outs", "afb_instantiation", "sfb_pairs",
           "sfb_row_pairs", "sfb_instantiation",
           "rows_aligned", "unit_rows", "MAX_TAPS", "afb_window_plan",
           "sfb_window_plan", "atrous_window_plan", "afb1d_window",
           "sfb1d_window", "afb1d_atrous_window", "sfb1d_atrous_window",
           "afb1d_window_plain", "sfb1d_window_plain",
           "afb1d_atrous_window_plain", "sfb1d_atrous_window_plain",
           "split_window", "merge_window", "atrous_split_window",
           "atrous_merge_window"]

# the kernels keep both tap vectors in shared memory (csrc/dwt_*.cu)
MAX_TAPS = 128
# the kernels index along an axis in 32-bit integers (csrc/dwt_index.cuh)
MAX_AXIS = 2 ** 30


def as_taps(h) -> np.ndarray:
    """Flatten any array-like filter (numpy, list or tensor) to a 1-D
    float64 numpy tap vector."""
    if isinstance(h, torch.Tensor):
        h = h.detach().cpu().numpy()
    return np.asarray(h, dtype=np.float64).ravel()


def _conv_axis(x, kernels, axis, stride=1, lhs_dilation=1, padding=(0, 0),
               rhs_dilation=1):
    """Correlate each (N,C) plane of ``x`` (N,C,H,W) along ``axis`` with a
    stack of 1-D kernels.

    kernels: (n_out, L) array of taps in correlation order.  The input is
    first dilated by ``lhs_dilation`` (zeros between samples) and
    zero-padded by ``padding``, as ``lax.conv_general_dilated`` does; the
    taps are ``rhs_dilation`` samples apart.
    Returns (N, C, n_out, H', W').
    """
    N, C, H, W = x.shape
    n_out, L = np.shape(kernels)
    if axis in (2, -2):
        w = np.reshape(kernels, (n_out, 1, L, 1))
        ax, strides, dil = 2, (stride, 1), (rhs_dilation, 1)
    elif axis in (3, -1):
        w = np.reshape(kernels, (n_out, 1, 1, L))
        ax, strides, dil = 3, (1, stride), (1, rhs_dilation)
    else:
        raise ValueError(f"axis must be 2 or 3, got {axis}")
    xr = x.reshape(N * C, 1, H, W)
    if lhs_dilation > 1:
        n = xr.shape[ax]
        shape = list(xr.shape)
        shape[ax] = (n - 1) * lhs_dilation + 1
        up = xr.new_zeros(shape)
        if ax == 2:
            up[:, :, ::lhs_dilation] = xr
        else:
            up[..., ::lhs_dilation] = xr
        xr = up
    if padding != (0, 0):
        xr = F.pad(xr, (*padding, 0, 0) if ax == 3 else (0, 0, *padding))
    with plain_flags():
        y = F.conv2d(xr, torch.as_tensor(np.ascontiguousarray(w),
                                         dtype=x.dtype, device=x.device),
                     stride=strides, dilation=dil)
    return y.reshape(N, C, n_out, *y.shape[2:])


def _ext_ns(L, dilation=1):
    """Small-probe length for operator extension: large enough that the
    boundary regions separate cleanly."""
    ns = max(256, 16 * L * dilation)
    return ns + (-ns) % 8


def _is_per(mode):
    return mode in ("per", "periodization")


# --------------------------------------------------------------------------
# The kernels' index plans
# --------------------------------------------------------------------------

def afb_plan(n, L, mode):
    """Index plan of the analysis split of a length-``n`` axis by L taps:
    ``(out_len, front, ne, pad_mode, shift, fold)``.

    Output m is sum_k h[k] X(2m + k), plus sum_k h[k] X(2m + k + ne) when
    m < fold, where X(q) is x[min((p + shift) % ne, n - 1)] for
    p = pad_index(ne, front, ., pad_mode)[q] (zero where p is -1).  So
    'periodization' evens an odd axis by repeating its last sample
    (ne = n + 1) and, for L > ne, mirrors the reference's roll by L//2,
    zero pad and single fold (``_afb1d_corr_conv`` l.145-158)."""
    if _is_per(mode):
        ne = n + n % 2
        L2 = L // 2
        if L <= ne:
            return ne // 2, L - 1 - L2, ne, "periodic", 0, 0
        return ne // 2, L - 1, ne, "zero", L2 % ne, L2
    if mode not in ("zero", "symmetric", "reflect", "periodic"):
        raise ValueError(f"Unknown pad type: {mode}")
    out_len = dwt_coeff_len(n, L, mode)
    p = 2 * (out_len - 1) - n + L
    return out_len, p // 2, n, mode, 0, 0


def sfb_plan(nin, L, mode):
    """Index plan of the synthesis merge of two length-``nin`` inputs by
    L taps (convolution order g): ``(out_len, s, wrap, r0, fold)``.

    With Y(u) = sum_j lo[j] g0[u - 2j] + hi[j] g1[u - 2j], output n is
    Y(t + s) + (Y(t + s + wrap) if t < fold else 0), where t = n, or
    t = (n + r0) mod wrap for 'periodization' (its wrap-add of the tail
    onto the first L - 2 samples and its roll by 1 - L//2,
    ``_sfb1d_conv_conv`` l.271-291)."""
    if _is_per(mode):
        return 2 * nin, 0, 2 * nin, L // 2 - 1, max(L - 2, 0)
    if mode not in ("zero", "symmetric", "reflect", "periodic"):
        raise ValueError(f"Unknown pad type: {mode}")
    return 2 * nin - L + 2, L - 2, 0, 0, 0


def atrous_plan(n, L, d, mode):
    """Index plan of the à trous split of a length-``n`` axis by L taps
    ``d`` samples apart: ``(front, back, pad_code, out_len)``.

    Output m is sum_k h[k] X(m + k d - front), where X(q) is
    x[pad_index(n, front, back, mode)[q + front]] (zero where that is -1),
    for m < out_len = n + front + back - (L - 1) d (n for every wavelet:
    their L is even).  Unlike :func:`afb_plan`, 'periodization' is a
    plain wrap, with no evening of an odd axis (the JAX ``pad1d`` maps it
    to 'wrap' and ``_afb1d_atrous_corr_conv`` never evens).  A negative
    pad (L = 1) raises, as the JAX ``pad1d`` does."""
    Ld = L * d
    front, back = Ld // 2 - d, Ld // 2
    if front < 0 or back < 0:
        raise ValueError(f"negative pad ({front}, {back})")
    if mode not in PAD_CODES:
        raise ValueError(f"Unknown pad type: {mode}")
    return front, back, PAD_CODES[mode], n + front + back - (L - 1) * d


def atrous_merge_plan(n, L, d, mode):
    """Index plan of the à trous merge of two length-``n`` inputs by L taps
    ``d`` samples apart: ``(front, back, pad_code, out_len)``, as
    :func:`atrous_plan` but with the pads (L d // 2, L d - d - L d // 2)
    that put the two branches' sum at zero offset
    (``_sfb1d_atrous_conv_conv`` l.347-352); out_len is n."""
    Ld = L * d
    front, back = Ld // 2, Ld - d - Ld // 2
    if front < 0 or back < 0:
        raise ValueError(f"negative pad ({front}, {back})")
    if mode not in PAD_CODES:
        raise ValueError(f"Unknown pad type: {mode}")
    return front, back, PAD_CODES[mode], n + front + back - (L - 1) * d


# csrc/swt_atrous.cu's row tile: 32 rows a block, MR outputs a thread, about
# _MERGE_TILE_OUT outputs a row, within _MERGE_SMEM bytes of shared memory
_MR, _TR, _MERGE_TILE_OUT, _MERGE_SMEM = 8, 32, 64, 96 * 1024


def merge_row_smem(G, S, L, ni, no):
    """Bytes of shared memory of K16's row tile (G residues x S positions;
    ni inputs, no outputs): the taps, the staged rows and the output rows,
    each row padded to an odd pitch."""
    return 4 * (ni * no * L + ni * _TR * (G * (S + L - 1) | 1)
                + no * _TR * (G * S | 1))


def merge_row_tile(n, L, d, ni, no):
    """K16's row tile (G, S) on a length-``n`` axis, taps ``d`` apart: G
    residues (a power of two, d itself up to 16) x S positions (a multiple
    of MR) of each, about 64 outputs a row, fewer where the axis is
    short; S, then G, shrunk until the tile fits the shared memory
    budget (``csrc/swt_atrous.cu:merge_row_kernel``)."""
    G = 1 << min(min(d, n).bit_length() - 1, 4)
    npos = -(-n // d)
    S = min(max(_MR, -(-(_MERGE_TILE_OUT // G) // _MR) * _MR),
            -(-npos // _MR) * _MR)
    while merge_row_smem(G, S, L, ni, no) > _MERGE_SMEM and (S > _MR
                                                            or G > 1):
        if S > _MR:
            S -= _MR
        else:
            G //= 2
    return G, S


@lru_cache(maxsize=256)
def merge_band_images(n, L, d, mode, kind="merge"):
    """The images of an à trous adjoint beside each sample's direct one:
    the pad positions q outside [0, n) whose source (:func:`pad_index`)
    is sample t, for the merge (K16, ``kind`` "merge",
    :func:`atrous_merge_plan`) or the split (K12, "split",
    :func:`atrous_plan`) of a length-``n`` axis by L taps ``d`` apart.
    An int32 array with a row for each t that has any, ascending: t, then
    the padded positions q + front, ascending, -1 past the last; None in
    'zero' mode or without pads.  ``csrc/swt_atrous.cu:merge_band_kernel``
    adds their windows (reflected and wrapped images, the whole pad run
    in 'replicate', several periods of a pad longer than the axis)."""
    plan = {"merge": atrous_merge_plan, "split": atrous_plan}[kind]
    front, back, code, _ = plan(n, L, d, mode)
    if code == PAD_CODES["zero"] or front + back == 0:
        return None
    src = pad_index(n, front, back, mode)
    pos = np.r_[0:front, front + n:front + n + back]   # padded index q + front
    ts = np.unique(src[pos])
    lists = [pos[src[pos] == t] for t in ts]
    table = np.full((len(ts), 1 + max(map(len, lists))), -1, dtype=np.int32)
    table[:, 0] = ts
    for row, us in zip(table, lists):
        row[1:1 + len(us)] = us
    return table


@lru_cache(maxsize=64)
def _device_band(n, L, d, mode, device, kind="merge"):
    t = merge_band_images(n, L, d, mode, kind)
    return None if t is None else torch.as_tensor(t, device=device)


def _band_args(tab):
    """The C entries' (table, width, rows) of a band table (0s: none)."""
    return (0, 0, 0) if tab is None else (tab.data_ptr(), tab.shape[1],
                                          tab.shape[0])


def rows_aligned(t):
    """The view's rows are 16-byte aligned with stride 1 along W: its
    base pointer, and the stride of every leading dimension longer than
    1, are multiples of 16 bytes (the float4 instantiations of K8, K10 and
    K16; the C entries check the same)."""
    return (t.data_ptr() % 16 == 0
            and (t.shape[3] < 2 or t.stride(3) == 1)
            and all(s % 4 == 0 for s, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1))


def unit_rows(t):
    """The view's rows have stride 1 along W (or one column)."""
    return t.shape[3] < 2 or t.stride(3) == 1


def merge_instantiation(axis, contiguous, *inputs):
    """The instantiation of K16's and K12's tile engine along ``axis`` for
    its input views: the column
    tile with float4 loads (``col_float4``, every input's rows 16-byte
    aligned with stride 1 along W, :func:`rows_aligned`) or scalar ones
    (``col_scalar``); the row tile walking one run of samples a row
    (``row_run``: a ``contiguous`` tile, G = d in :func:`merge_row_tile`,
    and rows of stride 1, :func:`unit_rows`) or mapping each sample
    (``row_gather``)."""
    if axis == 3:
        return ("row_run" if contiguous and all(map(unit_rows, inputs))
                else "row_gather")
    return ("col_float4" if all(map(rows_aligned, inputs))
            else "col_scalar")


# the C entries' instantiation codes (csrc/swt_atrous.cu:MergeInst,
# csrc/dtcwt_ifilt.cu:IfiltInst)
INST_CODES = {"col_scalar": 0, "col_float4": 1, "row_run": 2,
              "row_gather": 3}


# --------------------------------------------------------------------------
# Plain versions (the JAX conv path)
# --------------------------------------------------------------------------

def afb1d_corr_plain(x, h0_taps, h1_taps, mode, axis):
    """Plain PyTorch version of :func:`afb1d_corr` (the JAX package's
    ``_afb1d_corr_conv``).  Returns (N, C, 2, H', W'), 0 = lowpass."""
    axis = axis % 4
    N = x.shape[axis]
    L = len(h0_taps)
    kernels = np.stack([h0_taps, h1_taps])

    if _is_per(mode):
        if N % 2 == 1:
            # repeat the final sample to make the axis even
            x = torch.cat([x, x.narrow(axis, N - 1, 1)], dim=axis)
            N += 1
        L2 = L // 2
        if L <= N:
            # circular convolution evaluated at even taps
            front, back = L - 1 - L2, max(L2 - 1, 0)
            xp = pad1d(x, front, back, axis, "periodic")
            return _conv_axis(xp, kernels, axis, stride=2)
        # Filter longer than the (evened) signal: the reference's wrap-add
        # only folds ONE period, which is not circular convolution — mirror
        # its literal roll + zero-pad + single fold behaviour.
        x = torch.roll(x, -L2, dims=axis)
        xp = pad1d(x, L - 1, L - 1, axis, "zero")
        y = _conv_axis(xp, kernels, axis, stride=2)
        ax = axis + 1  # spatial axes shift by 1 past the inserted band dim
        N2 = N // 2
        folded = y.narrow(ax, 0, L2) + y.narrow(ax, N2, L2)
        if L2 >= N2:
            return folded.narrow(ax, 0, N2)
        return torch.cat([folded, y.narrow(ax, L2, N2 - L2)], dim=ax)

    outsize = dwt_coeff_len(N, L, mode)
    p = 2 * (outsize - 1) - N + L
    if mode == "zero":
        front, back = p // 2, p - p // 2
        xp = pad1d(x, front, back, axis, "zero")
    elif mode in ("symmetric", "reflect", "periodic"):
        front, back = p // 2, (p + 1) // 2
        xp = pad1d(x, front, back, axis, mode)
    else:
        raise ValueError(f"Unknown pad type: {mode}")
    return _conv_axis(xp, kernels, axis, stride=2)


def sfb1d_conv_plain(lo, hi, g0_taps, g1_taps, mode, axis):
    """Plain PyTorch version of :func:`sfb1d_conv` (the JAX package's
    ``_sfb1d_conv_conv``).  lo/hi: (N, C, H, W).  Returns (N, C, H', W')."""
    axis = axis % 4
    L = len(g0_taps)
    Nin = lo.shape[axis]
    # transpose-conv(stride 2, pad p) == correlate(up2(x), rev(g), L-1-p)
    k0 = np.asarray(g0_taps)[::-1].reshape(1, L)
    k1 = np.asarray(g1_taps)[::-1].reshape(1, L)

    if _is_per(mode):
        pad = (L - 1, L - 1)
        y = (_conv_axis(lo, k0, axis, lhs_dilation=2, padding=pad) +
             _conv_axis(hi, k1, axis, lhs_dilation=2, padding=pad))
        y = y[:, :, 0]
        Nout = 2 * Nin
        if L > 2:
            # wrap-add the tail onto the first L-2 samples then crop
            # (reference dwt/lowlevel.py:256-260); when the filter is
            # longer than the signal (L-2 >= Nout) the cropped output
            # comes entirely from the folded head
            head = y.narrow(axis, 0, L - 2) + y.narrow(axis, Nout, L - 2)
            if L - 2 >= Nout:
                y = head.narrow(axis, 0, Nout)
            else:
                y = torch.cat([head, y.narrow(axis, L - 2, Nout - L + 2)],
                              dim=axis)
        else:
            y = y.narrow(axis, 0, Nout)
        return torch.roll(y, 1 - L // 2, dims=axis)

    if mode in ("zero", "symmetric", "reflect", "periodic"):
        pad = (1, 1)  # = L-1 - (L-2)
        y = (_conv_axis(lo, k0, axis, lhs_dilation=2, padding=pad) +
             _conv_axis(hi, k1, axis, lhs_dilation=2, padding=pad))
        return y[:, :, 0]
    raise ValueError(f"Unknown pad type: {mode}")


def afb1d_atrous_corr_plain(x, h0_taps, h1_taps, mode, axis, dilation):
    """Plain PyTorch version of :func:`afb1d_atrous_corr` (the JAX
    package's ``_afb1d_atrous_corr_conv``): pad by ((L d)//2 - d,
    (L d)//2), then the correlation with taps ``dilation`` apart.
    Returns (N, C, 2, H', W'), 0 = lowpass."""
    axis = axis % 4
    L = len(h0_taps)
    L2 = (L * dilation) // 2
    kernels = np.stack([h0_taps, h1_taps])
    xp = pad1d(x, L2 - dilation, L2, axis, mode)
    return _conv_axis(xp, kernels, axis, rhs_dilation=dilation)


def afb1d_atrous_adjoint_plain(dy, h0_taps, h1_taps, mode, axis, dilation,
                               n):
    """Plain PyTorch version of :func:`afb1d_atrous_adjoint`: autograd's
    transpose of :func:`afb1d_atrous_corr_plain` (the transposed
    convolution and the pad's index_select adjoint), applied to the
    (N, C, 2, H', W') cotangent ``dy``.  Returns (N, C, H, W) with ``n``
    samples along ``axis``."""
    axis = axis % 4
    shape = [dy.shape[0], dy.shape[1], dy.shape[3], dy.shape[4]]
    shape[axis] = n
    x = dy.new_zeros(shape, requires_grad=True)
    # the transposed convolution runs under the plain versions' TF32 flags
    # too (cuDNN's allow_tf32 is read when the backward is dispatched)
    with torch.enable_grad(), plain_flags():
        y = afb1d_atrous_corr_plain(x, h0_taps, h1_taps, mode, axis,
                                    dilation)
        return torch.autograd.grad(y, x, dy.detach())[0]


def sfb1d_atrous_conv_plain(lo, hi, g0_taps, g1_taps, mode, axis,
                            dilation):
    """Plain PyTorch version of :func:`sfb1d_atrous_conv` (the JAX
    package's ``_sfb1d_atrous_conv_conv``): lo and hi padded by
    (L d // 2, L d - d - L d // 2), each correlated with its reversed
    taps ``dilation`` apart, and half their sum.  Returns (N, C, H, W)."""
    L = len(g0_taps)
    axis = axis % 4
    k0 = np.asarray(g0_taps)[::-1].reshape(1, L)
    k1 = np.asarray(g1_taps)[::-1].reshape(1, L)
    front, back, _, _ = atrous_merge_plan(lo.shape[axis], L, dilation, mode)
    lo_p = pad1d(lo, front, back, axis, mode)
    hi_p = pad1d(hi, front, back, axis, mode)
    y = (_conv_axis(lo_p, k0, axis, rhs_dilation=dilation) +
         _conv_axis(hi_p, k1, axis, rhs_dilation=dilation))
    return 0.5 * y[:, :, 0]


def sfb1d_atrous_adjoint_plain(dy, g0_taps, g1_taps, mode, axis, dilation):
    """Plain PyTorch version of :func:`sfb1d_atrous_adjoint`: autograd's
    transpose of :func:`sfb1d_atrous_conv_plain`, applied to the
    (N, C, H, W) cotangent ``dy``.  Returns the (N, C, 2, H, W) stack of
    the lo and hi cotangents."""
    lo = dy.new_zeros(dy.shape, requires_grad=True)
    hi = dy.new_zeros(dy.shape, requires_grad=True)
    with torch.enable_grad(), plain_flags():
        y = sfb1d_atrous_conv_plain(lo, hi, g0_taps, g1_taps, mode, axis,
                                    dilation)
        return torch.stack(torch.autograd.grad(y, (lo, hi), dy.detach()),
                           dim=2)


# --------------------------------------------------------------------------
# The kernel wrappers
# --------------------------------------------------------------------------

def _taps_f32(kernel, h0, h1):
    h0 = np.ascontiguousarray(h0, dtype=np.float32)
    h1 = np.ascontiguousarray(h1, dtype=np.float32)
    if h0.ndim != 1 or h0.shape != h1.shape or not 0 < len(h0) <= MAX_TAPS:
        raise ValueError(f"{kernel}: the two tap vectors must have one "
                         f"length in 1..{MAX_TAPS}, got {h0.shape} and "
                         f"{h1.shape}")
    return h0, h1


def _check_4d(kernel, axis, t):
    """The kernels index along an axis with 32-bit integers (twice an
    axis length must fit them); a plane of 2^30 pixels or more takes
    their 64-bit pixel index (csrc/dwt_index.cuh:dwt_launch)."""
    if axis not in (2, 3):
        raise ValueError(f"{kernel}: axis must be 2 or 3, got {axis}")
    if t.ndim != 4 or max(t.shape[2], t.shape[3]) >= MAX_AXIS:
        raise ValueError(f"{kernel}: expected an (N, C, H, W) tensor with "
                         f"H and W below 2^30, got {tuple(t.shape)}")


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


# csrc/dwt_afb.cu's tiles: a column thread walks AFB_COL_OUTS[V] outputs
# (V columns); a row tile takes S <= AFB_ROW_OUTS outputs of each of 32
# rows (afb_row_outs), a lane walking AFB_ROW_STEP at a time.  Its
# instantiation codes are K7's (csrc/dwt_afb.cu:AfbInst, SFB_INSTS below).
AFB_COL_OUTS = {1: 8, 4: 4}
AFB_ROW_OUTS, AFB_ROW_STEP = 128, 8


def _even_segments(count, most, step):
    """A row tile's segment: ``count`` positions shared evenly by the
    fewest segments of at most ``most``, each a multiple of ``step`` (130
    positions at most 128: two of 72, not 128 and 2)."""
    nseg = -(-count // most)
    return -(-(-(-count // nseg)) // step) * step


def afb_row_outs(m_out):
    """K6's row segment: the outputs S of each row a row tile takes, a
    multiple of AFB_ROW_STEP up to AFB_ROW_OUTS, the row's ``m_out``
    shared evenly."""
    return _even_segments(m_out, AFB_ROW_OUTS, AFB_ROW_STEP)


def afb_instantiation(axis, n, L, mode, x):
    """K6's instantiation for its input view: ``long_fold`` (the
    per-output kernel) where :func:`afb_plan` folds ('periodization' with
    L longer than the evened axis); along H the column tile with float4
    loads (``col_float4``, the view's rows 16-byte aligned with stride 1
    along W, :func:`rows_aligned`) or scalar ones (``col_scalar``); along
    W the row tile walking each row's segment (``row_run``, rows of stride
    1, :func:`unit_rows`) or mapping each sample (``row_gather``)."""
    return _afb_inst(axis, afb_plan(n, L, mode)[5], x)


def _afb_inst(axis, fold, x):
    if fold:
        return "long_fold"
    if axis == 3:
        return "row_run" if unit_rows(x) else "row_gather"
    return "col_float4" if rows_aligned(x) else "col_scalar"


@_cuda.via_fp32
def afb1d_corr(x, h0_taps, h1_taps, mode, axis, out_len=None):
    """Analysis split of (N, C, H, W) ``x`` along ``axis`` (2 or 3, or -1)
    with correlation-order taps: (N, C, 2, H', W'), band 0 the lowpass.

    ``out_len`` keeps only the first outputs along the axis (the crop of
    the inverse's backward).  CPU tensors take :func:`afb1d_corr_plain`;
    CUDA tensors launch K6, which reads ``x`` through its strides (a
    band of a coarser level's output in place), in polyphase windows by
    the tile of :func:`afb_instantiation`, counted in ``instantiations``.
    """
    axis = axis % 4
    if x.device.type == "cpu":
        y = afb1d_corr_plain(x, h0_taps, h1_taps, mode, axis)
        return y if out_len is None else y.narrow(axis + 1, 0, out_len)
    _cuda.check_inputs("dwt_afb", x)
    _check_4d("dwt_afb", axis, x)
    h0, h1 = _taps_f32("dwt_afb", h0_taps, h1_taps)
    L = len(h0)
    n = x.shape[axis]
    full, front, ne, pmode, shift, fold = afb_plan(n, L, mode)
    m = full if out_len is None else out_len
    if not 0 <= m <= full:
        raise ValueError(f"dwt_afb: out_len {m} outside 0..{full}")
    return _afb_launch(_K6, x, h0, h1, axis, (front, ne, pmode, shift, fold),
                       m)


def _afb_launch(wrapper, x, h0, h1, axis, plan, m):
    """K6 on ``x`` with fp32 taps ``h0`` / ``h1`` under the index plan
    ``(front, ne, pad_mode, shift, fold)`` (:func:`afb_plan`'s tail, or
    :func:`afb_window_plan`'s), ``m`` outputs along ``axis``; counted on
    ``wrapper``."""
    front, ne, pmode, shift, fold = plan
    L = len(h0)
    N, C, H, W = x.shape
    shape = [N, C, 2, H, W]
    shape[axis + 1] = m
    y = torch.empty(shape, device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    inst = _afb_inst(axis, fold, x)
    S = afb_row_outs(m) if inst in ("row_run", "row_gather") else 0
    lib = _cuda.library("dwt_afb")
    _cuda.check(lib, "dwt_afb", lib.dwt_afb(
        x.data_ptr(), y.data_ptr(), _ptr(h0), _ptr(h1), L, N, C, H, W,
        *x.stride(), axis, ne, front, PAD_CODES[pmode], shift, fold, m,
        *y.stride(), SFB_INSTS[inst], S, _cuda.stream_of(x)))
    wrapper.launches += 1
    wrapper.instantiations[inst] += 1
    return y


# csrc/dwt_sfb.cu's pair tiles: a column thread walks SFB_COL_PAIRS[V]
# output pairs (V columns); a row tile takes S <= SFB_ROW_PAIRS pairs of
# each of 32 rows (sfb_row_pairs), a lane walking SFB_ROW_STEP at a time
SFB_COL_PAIRS = {1: 8, 4: 4}
SFB_ROW_PAIRS, SFB_ROW_STEP = 128, 8
# the C entries' instantiation codes (csrc/dwt_sfb.cu:SfbInst,
# csrc/dwt_afb.cu:AfbInst)
SFB_INSTS = {"col_scalar": 0, "col_float4": 1, "row_run": 2,
             "row_gather": 3, "long_fold": 4}


def sfb_pairs(nin, L, mode, m_out):
    """The output pairs K7's tiles compute for the merge of two
    length-``nin`` inputs by L taps into the first ``m_out`` outputs:
    ``(A, per, off, m_lo, npairs)``.  Pair m's outputs are positions u =
    2m and 2m + 1 of the full transposed convolution, each reading the A
    = ceil(L/2) samples X(m - A + 1 .. m) of lo and hi; output n = u - off,
    mod 2 nin where ``per`` ('periodization': the roll r0, every position
    of [0, 2 nin), the input read circularly), else the crop s of
    :func:`sfb_plan`, positions [s, s + m_out).  None where the reference
    folds a 'periodization' tail longer than the output (L - 2 > 2 nin:
    the per-output ``long_fold``)."""
    _, s, wrap, r0, _ = sfb_plan(nin, L, mode)
    A = (L + 1) // 2
    if wrap:
        return None if L - 2 > wrap else (A, True, r0, 0, nin)
    m_lo = s // 2
    return A, False, s, m_lo, (s + m_out - 1) // 2 + 1 - m_lo


def sfb_row_pairs(npairs):
    """K7's row segment: the pairs S of each row a row tile takes, a
    multiple of SFB_ROW_STEP up to SFB_ROW_PAIRS, the row's npairs shared
    evenly by the fewest segments (130 pairs: two of 72, not 128 and
    2)."""
    return _even_segments(npairs, SFB_ROW_PAIRS, SFB_ROW_STEP)


def sfb_instantiation(axis, nin, L, mode, lo, hi):
    """K7's instantiation for its input views: ``long_fold`` where
    :func:`sfb_pairs` is None; along H the column tile with float4 loads
    (``col_float4``, both inputs' rows 16-byte aligned with stride 1
    along W, :func:`rows_aligned`) or scalar ones (``col_scalar``); along
    W the row tile walking each row's segment (``row_run``, rows of stride
    1, :func:`unit_rows`) or mapping each sample (``row_gather``)."""
    if sfb_pairs(nin, L, mode, 0) is None:
        return "long_fold"
    return _sfb_inst(axis, lo, hi)


def _sfb_inst(axis, lo, hi):
    if axis == 3:
        return "row_run" if unit_rows(lo) and unit_rows(hi) else "row_gather"
    return ("col_float4" if rows_aligned(lo) and rows_aligned(hi)
            else "col_scalar")


@_cuda.via_fp32
def sfb1d_conv(lo, hi, g0_taps, g1_taps, mode, axis, out_len=None):
    """Synthesis merge of (N, C, H, W) ``lo`` and ``hi`` along ``axis``
    with convolution-order taps: (N, C, H', W').

    ``out_len`` keeps only the first outputs along the axis (the crop of
    the forward's backward).  CPU tensors take :func:`sfb1d_conv_plain`;
    CUDA tensors launch K7, which reads ``lo`` and ``hi`` each through its
    own strides (the bands of a level's (N, C, 3, H, W) stack in place),
    in output pairs (:func:`sfb_pairs`) by the tile of
    :func:`sfb_instantiation`, counted in ``instantiations``.
    """
    axis = axis % 4
    if lo.shape != hi.shape:
        raise ValueError(f"sfb1d_conv: lo {tuple(lo.shape)} and hi "
                         f"{tuple(hi.shape)} differ")
    if lo.device.type == "cpu":
        y = sfb1d_conv_plain(lo, hi, g0_taps, g1_taps, mode, axis)
        return y if out_len is None else y.narrow(axis, 0, out_len)
    _cuda.check_inputs("dwt_sfb", lo, hi)
    _check_4d("dwt_sfb", axis, lo)
    g0, g1 = _taps_f32("dwt_sfb", g0_taps, g1_taps)
    L = len(g0)
    nin = lo.shape[axis]
    full, s, wrap, r0, fold = sfb_plan(nin, L, mode)
    m = full if out_len is None else out_len
    if not 0 <= m <= full:
        raise ValueError(f"dwt_sfb: out_len {m} outside 0..{full}")
    inst = sfb_instantiation(axis, nin, L, mode, lo, hi)
    pairs = sfb_pairs(nin, L, mode, m)
    return _sfb_launch(_K7, lo, hi, g0, g1, axis, (s, wrap, r0, fold), m,
                       inst, sfb_row_pairs(pairs[4]) if pairs else 0)


def _sfb_launch(wrapper, lo, hi, g0, g1, axis, plan, m, inst, S):
    """K7 on ``lo`` / ``hi`` with fp32 taps ``g0`` / ``g1`` under the
    index plan ``(s, wrap, r0, fold)`` (:func:`sfb_plan`'s tail, or
    :func:`sfb_window_plan`'s), ``m`` outputs along ``axis``, in the
    instantiation ``inst`` with the row tile's S pairs; counted on
    ``wrapper``."""
    s, wrap, r0, fold = plan
    L = len(g0)
    shape = list(lo.shape)
    shape[axis] = m
    y = torch.empty(shape, device=lo.device, dtype=torch.float32)
    _check_4d("dwt_sfb", axis, y)
    if y.numel() == 0:
        return y
    lib = _cuda.library("dwt_sfb")
    _cuda.check(lib, "dwt_sfb", lib.dwt_sfb(
        lo.data_ptr(), hi.data_ptr(), y.data_ptr(), _ptr(g0), _ptr(g1), L,
        *lo.shape, *lo.stride(), *hi.stride(), axis, s, wrap, r0, fold, m,
        *y.stride(), SFB_INSTS[inst], S, _cuda.stream_of(lo)))
    wrapper.launches += 1
    wrapper.instantiations[inst] += 1
    return y


# The launch counters live on the two wrappers; the wrappers reach them
# through these names, so that a caller who swaps the module's
# ``afb1d_corr`` / ``sfb1d_conv`` for a wrapper of its own (chip_smoke.py
# records the calls of a run that way) still counts on them.
_K6, _K7 = afb1d_corr, sfb1d_conv
_K6.launches = 0
_K7.launches = 0
_K6.instantiations = dict.fromkeys(SFB_INSTS, 0)
_K7.instantiations = dict.fromkeys(SFB_INSTS, 0)


def _atrous_args(kernel, h0_taps, h1_taps, n, mode, dilation):
    h0, h1 = _taps_f32(kernel, h0_taps, h1_taps)
    L = len(h0)
    if not (0 < dilation and L * dilation < MAX_AXIS):
        raise ValueError(f"{kernel}: dilation {dilation} with {L} taps")
    return h0, h1, L, atrous_plan(n, L, dilation, mode)


@_cuda.via_fp32
def afb1d_atrous_corr(x, h0_taps, h1_taps, mode, axis, dilation):
    """À trous split of (N, C, H, W) ``x`` along ``axis`` (2 or 3, or -1)
    with correlation-order taps ``dilation`` samples apart:
    (N, C, 2, H', W'), band 0 the lowpass; H' = H, W' = W for even L d
    (one sample fewer along the axis for odd L d).

    CPU tensors take :func:`afb1d_atrous_corr_plain`; CUDA tensors launch
    K12's ``swt_afb``, K16's tile engine with one input and two outputs,
    which reads ``x`` through its strides (the LL band of the previous
    level's (N, C, 4, H, W) stack in place), in the instantiation
    :func:`merge_instantiation` picks (counted in ``instantiations``),
    with :func:`merge_row_tile`'s tile along W.
    """
    axis = axis % 4
    if x.device.type == "cpu":
        return afb1d_atrous_corr_plain(x, h0_taps, h1_taps, mode, axis,
                                       dilation)
    _cuda.check_inputs("swt_afb", x)
    _check_4d("swt_afb", axis, x)
    n = x.shape[axis]
    h0, h1, _, (front, _, code, m) = _atrous_args("swt_afb", h0_taps,
                                                  h1_taps, n, mode, dilation)
    return _atrous_launch(_K12, x, h0, h1, axis, dilation, front, code, m)


def _atrous_launch(wrapper, x, h0, h1, axis, dilation, front, code, m):
    """K12's ``swt_afb`` on ``x`` with fp32 taps under the plan (front,
    pad code, ``m`` outputs) of :func:`atrous_plan`; counted on
    ``wrapper``."""
    L = len(h0)
    N, C, H, W = x.shape
    shape = [N, C, 2, H, W]
    shape[axis + 1] = m
    y = torch.empty(shape, device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    G, S = merge_row_tile(m, L, dilation, 1, 2)
    inst = merge_instantiation(axis, G == dilation, x)
    lib = _cuda.library("swt_atrous")
    _cuda.check(lib, "swt_afb", lib.swt_afb(
        x.data_ptr(), y.data_ptr(), _ptr(h0), _ptr(h1), L, dilation, N, C,
        H, W, *x.stride(), axis, front, code, m, *y.stride(),
        INST_CODES[inst], G, S, _cuda.stream_of(x)))
    wrapper.launches += 1
    wrapper.instantiations[inst] += 1
    return y


@_cuda.via_fp32
def afb1d_atrous_adjoint(dy, h0_taps, h1_taps, mode, axis, dilation, n):
    """The transpose of :func:`afb1d_atrous_corr` on an input of ``n``
    samples along ``axis``: the (N, C, 2, H', W') cotangent ``dy`` (band 0
    the lowpass's) -> (N, C, H, W).

    CPU tensors take :func:`afb1d_atrous_adjoint_plain`; CUDA tensors
    launch K12's ``swt_afb_adjoint`` (no atomics), which reads ``dy``'s
    two bands through its five strides: K16's tile engine with two inputs
    and one output, on the reversed taps, writes each sample's direct
    image, then, outside 'zero' mode, a gather adds the images of
    :func:`merge_band_images` of the split's plan (counted as ``band`` in
    ``instantiations`` beside the tile's instantiation).
    """
    axis = axis % 4
    if dy.device.type == "cpu":
        return afb1d_atrous_adjoint_plain(dy, h0_taps, h1_taps, mode, axis,
                                          dilation, n)
    _cuda.check_inputs("swt_afb_adjoint", dy)
    if dy.ndim != 5 or dy.shape[2] != 2:
        raise ValueError(f"swt_afb_adjoint: expected an (N, C, 2, H, W) "
                         f"cotangent, got {tuple(dy.shape)}")
    h0, h1, L, (front, _, code, m) = _atrous_args(
        "swt_afb_adjoint", h0_taps, h1_taps, n, mode, dilation)
    if dy.shape[axis + 1] != m:
        raise ValueError(f"swt_afb_adjoint: the cotangent has "
                         f"{dy.shape[axis + 1]} samples along axis {axis}, "
                         f"the split of {n} gives {m}")
    N, C, H, W = dy.shape[0], dy.shape[1], dy.shape[3], dy.shape[4]
    shape = [N, C, H, W]
    shape[axis] = n
    dx = torch.empty(shape, device=dy.device, dtype=torch.float32)
    _check_4d("swt_afb_adjoint", axis, dx)
    if dx.numel() == 0:
        return dx
    if dy.numel() == 0:     # odd L d on one sample: no output reads it
        return dx.zero_()
    G, S = merge_row_tile(n, L, dilation, 2, 1)
    inst = merge_instantiation(axis, G == dilation, dy[:, :, 0], dy[:, :, 1])
    tab = _device_band(n, L, dilation, mode, dy.device, "split")
    lib = _cuda.library("swt_atrous")
    _cuda.check(lib, "swt_afb_adjoint", lib.swt_afb_adjoint(
        dy.data_ptr(), dx.data_ptr(), _ptr(h0), _ptr(h1), L, dilation, N,
        C, *shape[2:], *dy.stride(), axis, front, code, m, *dx.stride(),
        INST_CODES[inst], G, S, *_band_args(tab), _cuda.stream_of(dy)))
    _K12A.launches += 1
    _K12A.instantiations[inst] += 1
    if tab is not None:
        _K12A.instantiations["band"] += 1
    return dx


_K12, _K12A = afb1d_atrous_corr, afb1d_atrous_adjoint
_K12.launches = 0
_K12A.launches = 0
_K12.instantiations = dict.fromkeys(INST_CODES, 0)
_K12A.instantiations = dict.fromkeys((*INST_CODES, "band"), 0)


def _merge_args(kernel, g0_taps, g1_taps, n, mode, dilation):
    """The correlation-order taps of the merge, halved (the 0.5 of the
    shift average: a power of two, so exact), and its plan."""
    k0, k1 = _taps_f32(kernel, np.asarray(g0_taps)[::-1],
                       np.asarray(g1_taps)[::-1])
    L = len(k0)
    if not (0 < dilation and L * dilation < MAX_AXIS):
        raise ValueError(f"{kernel}: dilation {dilation} with {L} taps")
    return (0.5 * k0, 0.5 * k1, L,
            atrous_merge_plan(n, L, dilation, mode))


@_cuda.via_fp32
def sfb1d_atrous_conv(lo, hi, g0_taps, g1_taps, mode, axis, dilation):
    """À trous merge of (N, C, H, W) ``lo`` and ``hi`` along ``axis`` (2
    or 3, or -1) with convolution-order taps ``dilation`` samples apart:
    (N, C, H, W).

    CPU tensors take :func:`sfb1d_atrous_conv_plain`; CUDA tensors launch
    K16's ``swt_sfb``, which reads ``lo`` and ``hi`` each through its own
    strides (the bands of a level's (N, C, 4, H, W) stack in place), in
    the instantiation :func:`merge_instantiation` picks (counted in
    ``instantiations``), with :func:`merge_row_tile`'s tile along W."""
    axis = axis % 4
    if lo.shape != hi.shape:
        raise ValueError(f"sfb1d_atrous_conv: lo {tuple(lo.shape)} and hi "
                         f"{tuple(hi.shape)} differ")
    if lo.device.type == "cpu":
        return sfb1d_atrous_conv_plain(lo, hi, g0_taps, g1_taps, mode, axis,
                                       dilation)
    _cuda.check_inputs("swt_sfb", lo, hi)
    _check_4d("swt_sfb", axis, lo)
    n = lo.shape[axis]
    k0, k1, _, (front, _, code, m) = _merge_args(
        "swt_sfb", g0_taps, g1_taps, n, mode, dilation)
    return _merge_launch(_K16, lo, hi, k0, k1, axis, dilation, front, code,
                         m)


def _merge_launch(wrapper, lo, hi, k0, k1, axis, dilation, front, code, m):
    """K16's ``swt_sfb`` on ``lo`` / ``hi`` with the halved fp32
    correlation taps of :func:`_merge_args` under the plan (front, pad
    code, ``m`` = n outputs) of :func:`atrous_merge_plan`; counted on
    ``wrapper``."""
    L = len(k0)
    n = lo.shape[axis]
    y = torch.empty(lo.shape, device=lo.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    G, S = merge_row_tile(n, L, dilation, 2, 1)
    inst = merge_instantiation(axis, G == dilation, lo, hi)
    lib = _cuda.library("swt_atrous")
    _cuda.check(lib, "swt_sfb", lib.swt_sfb(
        lo.data_ptr(), hi.data_ptr(), y.data_ptr(), _ptr(k0), _ptr(k1), L,
        dilation, *lo.shape, *lo.stride(), *hi.stride(), axis, front, code,
        m, *y.stride(), INST_CODES[inst], G, S, _cuda.stream_of(lo)))
    wrapper.launches += 1
    wrapper.instantiations[inst] += 1
    return y


@_cuda.via_fp32
def sfb1d_atrous_adjoint(dy, g0_taps, g1_taps, mode, axis, dilation):
    """The transpose of :func:`sfb1d_atrous_conv`: the (N, C, H, W)
    cotangent ``dy`` -> the (N, C, 2, H, W) stack of the cotangents of
    lo (band 0) and hi.

    CPU tensors take :func:`sfb1d_atrous_adjoint_plain`; CUDA tensors
    launch K16's ``swt_sfb_adjoint`` (no atomics): the merge's tile engine
    on the reversed taps writes each sample's direct image, then, outside
    'zero' mode, a gather adds the images of :func:`merge_band_images`
    (counted as ``band`` in ``instantiations`` beside the tile's
    instantiation)."""
    axis = axis % 4
    if dy.device.type == "cpu":
        return sfb1d_atrous_adjoint_plain(dy, g0_taps, g1_taps, mode, axis,
                                          dilation)
    _cuda.check_inputs("swt_sfb_adjoint", dy)
    _check_4d("swt_sfb_adjoint", axis, dy)
    n = dy.shape[axis]
    k0, k1, L, (front, _, code, m) = _merge_args(
        "swt_sfb_adjoint", g0_taps, g1_taps, n, mode, dilation)
    N, C, H, W = dy.shape
    d2 = torch.empty((N, C, 2, H, W), device=dy.device, dtype=torch.float32)
    if d2.numel() == 0:
        return d2
    G, S = merge_row_tile(n, L, dilation, 1, 2)
    inst = merge_instantiation(axis, G == dilation, dy)
    tab = _device_band(n, L, dilation, mode, dy.device)
    lib = _cuda.library("swt_atrous")
    _cuda.check(lib, "swt_sfb_adjoint", lib.swt_sfb_adjoint(
        dy.data_ptr(), d2.data_ptr(), _ptr(k0), _ptr(k1), L, dilation, N, C,
        H, W, *dy.stride(), axis, front, code, m, *d2.stride(),
        INST_CODES[inst], G, S, *_band_args(tab), _cuda.stream_of(dy)))
    _K16A.launches += 1
    _K16A.instantiations[inst] += 1
    if tab is not None:
        _K16A.instantiations["band"] += 1
    return d2


_K16, _K16A = sfb1d_atrous_conv, sfb1d_atrous_adjoint
_K16.launches = 0
_K16A.launches = 0
_K16.instantiations = dict.fromkeys(INST_CODES, 0)
_K16A.instantiations = dict.fromkeys((*INST_CODES, "band"), 0)


class _SFB1DAtrous(torch.autograd.Function):
    """lo, hi -> the à trous merge along ``axis`` (:func:`sfb1d_atrous_conv`,
    convolution-order taps); backward :func:`sfb1d_atrous_adjoint`, the
    exact transpose (what ``jax.vjp`` of the JAX step gives)."""

    @staticmethod
    def forward(ctx, lo, hi, g0, g1, mode, axis, dilation):
        ctx.args = (g0, g1, mode, axis, dilation)
        return sfb1d_atrous_conv(lo, hi, g0, g1, mode, axis, dilation)

    @staticmethod
    def backward(ctx, dy):
        args = ctx.args

        def adjoint(g):
            d2 = sfb1d_atrous_adjoint(g, *args)
            return d2[:, :, 0], d2[:, :, 1]
        dlo, dhi = linear_backward(
            adjoint, lambda ulo, uhi: _SFB1DAtrous.apply(ulo, uhi, *args), dy)
        return dlo, dhi, None, None, None, None, None


@lru_cache(maxsize=None)
def _afb_atrous_matrix(h0, h1, mode, dilation, n, dtype_str="f4"):
    """The (2 out_len, n) operator of the à trous split of a length-``n``
    axis (correlation-order tap tuples), probed on the host from
    :func:`afb1d_atrous_corr_plain` in ``dtype_str`` precision, or
    synthesized from a small probe above ``banded.DIRECT_PROBE_N``."""
    from pytorch_wavelets_tpu_torch.ops import banded
    return banded.synthesized_or_probe(
        lambda m: banded.probe_op(
            lambda I: afb1d_atrous_corr_plain(
                I, np.asarray(h0), np.asarray(h1), mode, 2, dilation), m,
            dtype=np.dtype(dtype_str).type),
        n, _ext_ns(len(h0), dilation), 2, 1, (1, 1))


@lru_cache(maxsize=None)
def _afb_matrix(h0, h1, mode, n):
    """The (2 out_len, n) operator of the analysis split of a length-``n``
    axis (correlation-order tap tuples), probed on the host from
    :func:`afb1d_corr_plain` in fp32, or synthesized from a small probe
    above ``banded.DIRECT_PROBE_N`` (the JAX package's ``_afb_matrix``)."""
    from pytorch_wavelets_tpu_torch.ops import banded
    return banded.synthesized_or_probe(
        lambda m: banded.probe_op(
            lambda I: afb1d_corr_plain(I, np.asarray(h0), np.asarray(h1),
                                       mode, 2), m),
        n, _ext_ns(len(h0)), 2, 1, (1, 2))


@lru_cache(maxsize=None)
def _sfb_matrix(g0, g1, mode, n):
    """The (out_len, 2 n) operator of the synthesis merge of two
    length-``n`` inputs given side by side [lo | hi] (convolution-order
    tap tuples), probed from :func:`sfb1d_conv_plain` (the JAX package's
    ``_sfb_matrix``)."""
    from pytorch_wavelets_tpu_torch.ops import banded

    def direct(m):
        return banded.probe_op(
            lambda I: sfb1d_conv_plain(I[:, :, :m], I[:, :, m:],
                                       np.asarray(g0), np.asarray(g1), mode,
                                       2), 2 * m)
    return banded.synthesized_or_probe(direct, n, _ext_ns(len(g0)) // 2,
                                       1, 2, (2, 1))


@lru_cache(maxsize=None)
def _sfb_atrous_matrix(g0, g1, mode, dilation, n):
    """The (n, 2 n) operator of the à trous merge of [lo | hi]
    (convolution-order tap tuples ``dilation`` apart), probed from
    :func:`sfb1d_atrous_conv_plain` (the JAX package's
    ``_sfb_atrous_matrix``)."""
    from pytorch_wavelets_tpu_torch.ops import banded

    def direct(m):
        return banded.probe_op(
            lambda I: sfb1d_atrous_conv_plain(
                I[:, :, :m], I[:, :, m:], np.asarray(g0), np.asarray(g1),
                mode, 2, dilation), 2 * m)
    return banded.synthesized_or_probe(direct, n,
                                       _ext_ns(len(g0), dilation), 1, 2,
                                       (1, 1))


# --------------------------------------------------------------------------
# Window applies: the sharded conv route's filtering of a halo'd tile
# (parallel/sharded_dwt.py), valid correlations whose every tap reads a
# sample of the window
# --------------------------------------------------------------------------

def afb_window_plan(n, front):
    """K6's index plan tail ``(front, ne, pad_mode, shift, fold)`` for the
    split of a length-``n`` window with its first sample at position
    ``front`` of the taps' walk: output m is sum_k h[k] x[2m + k - front],
    zero outside [0, n).  ``front`` 0 is the valid stride-2 correlation
    of the JAX ``_afb1d_per_sharded``; a positive one is the adjoint of
    :func:`sfb1d_window` with its offset."""
    return front, n, "zero", 0, 0


def sfb_window_plan(s):
    """K7's index plan tail ``(s, wrap, r0, fold)`` for the merge of two
    windows: output t is Y(t + s), Y(u) = sum_j lo[j] g0[u - 2j] + hi[j]
    g1[u - 2j] the full transposed stride-2 convolution, no wrap.  The
    JAX ``_sfb1d_per_sharded``'s slice of the upsampled window starts at
    2 hl - L//2 and its correlation with the reversed taps adds L - 1:
    s = 2 hl - L//2 + L - 1.  ``s`` 0 is the adjoint of
    :func:`afb1d_window` with front 0."""
    return s, 0, 0, 0


def atrous_window_plan(n, L, d, kind):
    """The valid à trous split ('split', K12) or merge ('merge', K16) of a
    length-``n`` window: ``(front, m)``.  K12's and K16's C entries take
    only the pads of their modes' plans (``csrc/swt_atrous.cu:front_ok``),
    so the window runs their 'zero' plan (:func:`atrous_plan` /
    :func:`atrous_merge_plan`), whose outputs [front, front + m) read no
    pad: m = n - (L - 1) d of them, (L - 1) d outputs computed and
    dropped (the JAX ``_afb1d_atrous_sharded`` /
    ``_sfb1d_atrous_sharded``'s valid correlations)."""
    plan = atrous_plan if kind == "split" else atrous_merge_plan
    front, _, _, out_len = plan(n, L, d, "zero")
    m = n - (L - 1) * d
    if m < 1 or front + m > out_len:
        raise ValueError(f"no valid {kind} of a {n}-sample window by {L} "
                         f"taps {d} apart")
    return front, m


def afb1d_window_plain(x, h0_taps, h1_taps, axis, front, m):
    """Plain PyTorch version of :func:`afb1d_window`: ``x`` padded with
    ``front`` zeros (and zeros past its end), the stride-2 correlation,
    its first ``m`` outputs.  Returns (N, C, 2, H', W')."""
    axis = axis % 4
    L, n = len(h0_taps), x.shape[axis]
    back = max(0, 2 * (m - 1) + L - front - n)
    xp = pad1d(x, front, back, axis, "zero") if front or back else x
    y = _conv_axis(xp, np.stack([h0_taps, h1_taps]), axis, stride=2)
    return y.narrow(axis + 1, 0, m)


def sfb1d_window_plain(lo, hi, g0_taps, g1_taps, axis, s, m):
    """Plain PyTorch version of :func:`sfb1d_window`: the full transposed
    stride-2 convolution of (lo, hi) summed, outputs [s, s + m) (zeros
    past its end).  Returns (N, C, H', W')."""
    axis = axis % 4
    L = len(g0_taps)
    k0 = np.asarray(g0_taps)[::-1].reshape(1, L)
    k1 = np.asarray(g1_taps)[::-1].reshape(1, L)
    pad = (L - 1, L - 1)
    y = (_conv_axis(lo, k0, axis, lhs_dilation=2, padding=pad) +
         _conv_axis(hi, k1, axis, lhs_dilation=2, padding=pad))[:, :, 0]
    if s + m > y.shape[axis]:
        y = pad1d(y, 0, s + m - y.shape[axis], axis, "zero")
    return y.narrow(axis, s, m)


@_cuda.via_fp32
def afb1d_window(x, h0_taps, h1_taps, axis, front, m):
    """The split of a window (:func:`afb_window_plan`): (N, C, 2, H', W')
    with ``m`` outputs along ``axis``, correlation-order taps.  CPU
    tensors take :func:`afb1d_window_plain`; CUDA tensors launch K6 with
    the window's plan (counted on this wrapper)."""
    axis = axis % 4
    if x.device.type == "cpu":
        return afb1d_window_plain(x, h0_taps, h1_taps, axis, front, m)
    _cuda.check_inputs("dwt_afb", x)
    _check_4d("dwt_afb", axis, x)
    h0, h1 = _taps_f32("dwt_afb", h0_taps, h1_taps)
    return _afb_launch(_K6W, x, h0, h1, axis,
                       afb_window_plan(x.shape[axis], front), m)


@_cuda.via_fp32
def sfb1d_window(lo, hi, g0_taps, g1_taps, axis, s, m):
    """The merge of two windows (:func:`sfb_window_plan`): (N, C, H', W')
    with ``m`` outputs along ``axis``, convolution-order taps.  CPU
    tensors take :func:`sfb1d_window_plain`; CUDA tensors launch K7 with
    the window's plan (counted on this wrapper)."""
    axis = axis % 4
    if lo.shape != hi.shape:
        raise ValueError(f"sfb1d_window: lo {tuple(lo.shape)} and hi "
                         f"{tuple(hi.shape)} differ")
    if lo.device.type == "cpu":
        return sfb1d_window_plain(lo, hi, g0_taps, g1_taps, axis, s, m)
    _cuda.check_inputs("dwt_sfb", lo, hi)
    _check_4d("dwt_sfb", axis, lo)
    g0, g1 = _taps_f32("dwt_sfb", g0_taps, g1_taps)
    npairs = (s + m - 1) // 2 + 1 - s // 2
    return _sfb_launch(_K7W, lo, hi, g0, g1, axis,
                       sfb_window_plan(s), m, _sfb_inst(axis, lo, hi),
                       sfb_row_pairs(npairs))


def afb1d_atrous_window_plain(x, h0_taps, h1_taps, axis, dilation):
    """Plain PyTorch version of :func:`afb1d_atrous_window`: the valid
    correlation with taps ``dilation`` apart (the JAX
    ``_afb1d_atrous_sharded``'s, no pad).  Returns (N, C, 2, H', W')."""
    return _conv_axis(x, np.stack([h0_taps, h1_taps]), axis % 4,
                      rhs_dilation=dilation)


def sfb1d_atrous_window_plain(lo, hi, g0_taps, g1_taps, axis, dilation):
    """Plain PyTorch version of :func:`sfb1d_atrous_window`: half the sum
    of the valid correlations of lo and hi with their reversed taps
    ``dilation`` apart (the JAX ``_sfb1d_atrous_sharded``'s)."""
    axis = axis % 4
    L = len(g0_taps)
    y = (_conv_axis(lo, np.asarray(g0_taps)[::-1].reshape(1, L), axis,
                    rhs_dilation=dilation)
         + _conv_axis(hi, np.asarray(g1_taps)[::-1].reshape(1, L), axis,
                      rhs_dilation=dilation))
    return 0.5 * y[:, :, 0]


@_cuda.via_fp32
def afb1d_atrous_window(x, h0_taps, h1_taps, axis, dilation):
    """The valid à trous split of a window (:func:`atrous_window_plan`):
    (N, C, 2, H', W'), correlation-order taps.  CPU tensors take
    :func:`afb1d_atrous_window_plain`; CUDA tensors launch K12's
    ``swt_afb`` with the window's 'zero' plan and return the view of its
    valid outputs (counted on this wrapper)."""
    axis = axis % 4
    if x.device.type == "cpu":
        return afb1d_atrous_window_plain(x, h0_taps, h1_taps, axis, dilation)
    _cuda.check_inputs("swt_afb", x)
    _check_4d("swt_afb", axis, x)
    n = x.shape[axis]
    h0, h1, L, (front, _, code, m) = _atrous_args(
        "swt_afb", h0_taps, h1_taps, n, "zero", dilation)
    start, w = atrous_window_plan(n, L, dilation, "split")
    y = _atrous_launch(_K12W, x, h0, h1, axis, dilation, front, code, m)
    return y.narrow(axis + 1, start, w)


@_cuda.via_fp32
def sfb1d_atrous_window(lo, hi, g0_taps, g1_taps, axis, dilation):
    """The valid à trous merge of two windows (:func:`atrous_window_plan`,
    convolution-order taps).  CPU tensors take
    :func:`sfb1d_atrous_window_plain`; CUDA tensors launch K16's
    ``swt_sfb`` with the window's 'zero' plan and return the view of its
    valid outputs (counted on this wrapper)."""
    axis = axis % 4
    if lo.shape != hi.shape:
        raise ValueError(f"sfb1d_atrous_window: lo {tuple(lo.shape)} and hi "
                         f"{tuple(hi.shape)} differ")
    if lo.device.type == "cpu":
        return sfb1d_atrous_window_plain(lo, hi, g0_taps, g1_taps, axis,
                                         dilation)
    _cuda.check_inputs("swt_sfb", lo, hi)
    _check_4d("swt_sfb", axis, lo)
    n = lo.shape[axis]
    k0, k1, L, (front, _, code, m) = _merge_args(
        "swt_sfb", g0_taps, g1_taps, n, "zero", dilation)
    start, w = atrous_window_plan(n, L, dilation, "merge")
    y = _merge_launch(_K16W, lo, hi, k0, k1, axis, dilation, front, code, m)
    return y.narrow(axis, start, w)


_K6W, _K7W = afb1d_window, sfb1d_window
_K12W, _K16W = afb1d_atrous_window, sfb1d_atrous_window
for _k in (_K6W, _K7W):
    _k.launches = 0
    _k.instantiations = dict.fromkeys(SFB_INSTS, 0)
for _k in (_K12W, _K16W):
    _k.launches = 0
    _k.instantiations = dict.fromkeys(INST_CODES, 0)


def _pad_window(g, dim, start, n):
    """The cotangent ``g`` of a window's valid outputs placed at
    [start, start + len) of ``n`` zeros along ``dim`` (the view's
    adjoint)."""
    shape = list(g.shape)
    shape[dim] = n
    out = g.new_zeros(shape)
    out.narrow(dim, start, g.shape[dim]).copy_(g)
    return out


class _SplitWindow(torch.autograd.Function):
    """x -> :func:`afb1d_window` (K6); backward its adjoint, the merge
    :func:`sfb1d_window` with the same taps and offset ``front`` (K7),
    whose own backward is this Function again."""

    @staticmethod
    def forward(ctx, x, h0, h1, axis, front, m):
        ctx.args = (h0, h1, axis, front, m, x.shape[axis])
        return afb1d_window(x, h0, h1, axis, front, m)

    @staticmethod
    def backward(ctx, dy):
        h0, h1, axis, front, m, n = ctx.args
        dx = linear_backward(
            lambda g: _MergeWindow.apply(g[:, :, 0], g[:, :, 1], h0, h1,
                                         axis, front, n),
            lambda u: _SplitWindow.apply(u, h0, h1, axis, front, m), dy)
        return dx, None, None, None, None, None


class _MergeWindow(torch.autograd.Function):
    """lo, hi -> :func:`sfb1d_window` (K7); backward its adjoint, the
    split :func:`afb1d_window` with front ``s`` (K6)."""

    @staticmethod
    def forward(ctx, lo, hi, g0, g1, axis, s, m):
        ctx.args = (g0, g1, axis, s, m, lo.shape[axis])
        return sfb1d_window(lo, hi, g0, g1, axis, s, m)

    @staticmethod
    def backward(ctx, dy):
        g0, g1, axis, s, m, nin = ctx.args

        def adjoint(g):
            d = _SplitWindow.apply(g, g0, g1, axis, s, nin)
            return d[:, :, 0], d[:, :, 1]
        dlo, dhi = linear_backward(
            adjoint,
            lambda ulo, uhi: _MergeWindow.apply(ulo, uhi, g0, g1, axis, s,
                                                m), dy)
        return dlo, dhi, None, None, None, None, None


class _AtrousSplitWindow(torch.autograd.Function):
    """x -> :func:`afb1d_atrous_window` (K12); backward its adjoint, the
    cotangent placed at the valid outputs of the window's 'zero' split,
    then K12's adjoint entry on that plan (:func:`afb1d_atrous_adjoint`);
    the backward's backward is this Function again."""

    @staticmethod
    def forward(ctx, x, h0, h1, axis, dilation):
        ctx.args = (h0, h1, axis, dilation, x.shape[axis])
        return afb1d_atrous_window(x, h0, h1, axis, dilation)

    @staticmethod
    def backward(ctx, dy):
        h0, h1, axis, d, n = ctx.args
        start, _ = atrous_window_plan(n, len(h0), d, "split")
        m = atrous_plan(n, len(h0), d, "zero")[3]

        def adjoint(g):
            return afb1d_atrous_adjoint(_pad_window(g, axis + 1, start, m),
                                        h0, h1, "zero", axis, d, n)
        dx = linear_backward(
            adjoint, lambda u: _AtrousSplitWindow.apply(u, h0, h1, axis, d),
            dy)
        return dx, None, None, None, None


class _AtrousMergeWindow(torch.autograd.Function):
    """lo, hi -> :func:`sfb1d_atrous_window` (K16); backward its adjoint,
    the cotangent placed at the valid outputs of the windows' 'zero'
    merge, then K16's adjoint entry on that plan
    (:func:`sfb1d_atrous_adjoint`)."""

    @staticmethod
    def forward(ctx, lo, hi, g0, g1, axis, dilation):
        ctx.args = (g0, g1, axis, dilation, lo.shape[axis])
        return sfb1d_atrous_window(lo, hi, g0, g1, axis, dilation)

    @staticmethod
    def backward(ctx, dy):
        g0, g1, axis, d, n = ctx.args
        start, _ = atrous_window_plan(n, len(g0), d, "merge")

        def adjoint(g):
            d2 = sfb1d_atrous_adjoint(_pad_window(g, axis, start, n), g0, g1,
                                      "zero", axis, d)
            return d2[:, :, 0], d2[:, :, 1]
        dlo, dhi = linear_backward(
            adjoint,
            lambda ulo, uhi: _AtrousMergeWindow.apply(ulo, uhi, g0, g1, axis,
                                                      d), dy)
        return dlo, dhi, None, None, None, None


def split_window(x, h0, h1, axis, front, m):
    """Differentiable :func:`afb1d_window` (correlation-order taps)."""
    return _SplitWindow.apply(x, h0, h1, axis % 4, front, m)


def merge_window(lo, hi, g0, g1, axis, s, m):
    """Differentiable :func:`sfb1d_window` (convolution-order taps)."""
    return _MergeWindow.apply(lo, hi, g0, g1, axis % 4, s, m)


def atrous_split_window(x, h0, h1, axis, dilation):
    """Differentiable :func:`afb1d_atrous_window` (correlation-order
    taps)."""
    return _AtrousSplitWindow.apply(x, h0, h1, axis % 4, dilation)


def atrous_merge_window(lo, hi, g0, g1, axis, dilation):
    """Differentiable :func:`sfb1d_atrous_window` (convolution-order
    taps)."""
    return _AtrousMergeWindow.apply(lo, hi, g0, g1, axis % 4, dilation)


# --------------------------------------------------------------------------
# Public 1-D and separable 2-D filterbanks
# --------------------------------------------------------------------------

# The one-axis transposes run on K14's / K15's adjoints, which filter both
# axes at stride 2: the other axis is read as twice as long, with the
# one-tap filter e = (1, 0) on it.  Its even positions are the samples,
# its odd ones a dummy that e weights by 0; a window of e reads positions
# 2m and 2m + 1 only (no pad in any mode), so output m along that axis is
# sample m (analysis), and the synthesis puts sample j at position 2j.
_ONE_TAP = np.array([1.0, 0.0])


def _one_axis_psfs(taps, axis, k=None):
    """The PSFs outer(e, t) (``axis`` 3) or outer(t, e) (``axis`` 2) of
    each tap vector of ``taps``, padded with zero PSFs to ``k``."""
    f = [np.outer(_ONE_TAP, t) if axis == 3 else np.outer(t, _ONE_TAP)
         for t in taps]
    f += [np.zeros_like(f[0])] * ((k or len(f)) - len(f))
    return np.stack(f)


def _pad_to(t, dim, n):
    """``t`` with zeros appended along ``dim`` up to length ``n`` (the
    transpose of keeping its first entries)."""
    extra = n - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


class _AFB1D(torch.autograd.Function):
    """x (N, C, H, W) -> the (N, C, 2, ...) split along ``axis`` (K6
    ``afb1d_corr``; correlation-order taps), its first ``out_len`` outputs
    along the axis (all with None).  Backward: the exact transpose, the
    cotangent padded with zeros to the full split, then K14's adjoint on
    the separable split's plan with the PSFs of :func:`_one_axis_psfs` on
    an input twice as long across the axis (one launch), whose even
    positions are dx (what ``jax.vjp`` of the JAX ``afb1d`` gives, in
    every mode).  The backward's backward is this split again."""

    @staticmethod
    def forward(ctx, x, h0, h1, mode, axis, out_len=None):
        ctx.args = (h0, h1, mode, axis, out_len, tuple(x.shape[2:]))
        return afb1d_corr(x, h0, h1, mode, axis, out_len)

    @staticmethod
    def backward(ctx, dy):
        from pytorch_wavelets_tpu_torch.ops.nonsep import nonsep_afb_adjoint
        h0, h1, mode, axis, out_len, (H, W) = ctx.args
        f = _one_axis_psfs((h0, h1), axis)
        full = afb_plan((H, W)[axis - 2], len(h0), mode)[0]

        def adjoint(g):
            g = _pad_to(g, axis + 1, full)
            # positional separable=True: the launch recorders pass no
            # keywords
            if axis == 3:
                return nonsep_afb_adjoint(g, f, mode, 2 * H, W,
                                          True)[:, :, 0::2]
            return nonsep_afb_adjoint(g, f, mode, H, 2 * W, True)[..., 0::2]
        dx = linear_backward(
            adjoint, lambda u: _AFB1D.apply(u, h0, h1, mode, axis, out_len),
            dy)
        return dx, None, None, None, None, None


class _SFB1D(torch.autograd.Function):
    """lo, hi (N, C, H, W) -> the merge along ``axis`` (K7 ``sfb1d_conv``;
    convolution-order taps), its first ``out_len`` outputs along the axis
    (all with None).  Backward: the exact transpose, the cotangent padded
    with zeros to the full merge, then K15's adjoint on the separable plan
    with the PSFs of :func:`_one_axis_psfs` (two of them zero: K15 takes
    four bands) on a cotangent spread to the even positions of an axis
    twice as long (one launch).  The backward's backward is this merge
    again."""

    @staticmethod
    def forward(ctx, lo, hi, g0, g1, mode, axis, out_len=None):
        ctx.args = (g0, g1, mode, axis, out_len, tuple(lo.shape[2:]))
        return sfb1d_conv(lo, hi, g0, g1, mode, axis, out_len)

    @staticmethod
    def backward(ctx, dy):
        from pytorch_wavelets_tpu_torch.ops.nonsep import nonsep_sfb_adjoint
        g0, g1, mode, axis, out_len, (H, W) = ctx.args
        f = _one_axis_psfs((g0, g1), axis, 4)
        full = sfb_plan((H, W)[axis - 2], len(g0), mode)[0]

        def adjoint(g):
            g = _pad_to(g, axis, full)
            shape = list(g.shape)
            shape[2 if axis == 3 else 3] *= 2      # the other axis, doubled
            g2 = g.new_zeros(shape)
            if axis == 3:
                g2[:, :, 0::2] = g
            else:
                g2[..., 0::2] = g
            dc = nonsep_sfb_adjoint(g2, f, mode, H, W, True)
            return dc[:, :, 0], dc[:, :, 1]
        dlo, dhi = linear_backward(
            adjoint,
            lambda ulo, uhi: _SFB1D.apply(ulo, uhi, g0, g1, mode, axis,
                                          out_len), dy)
        return dlo, dhi, None, None, None, None, None


def afb1d(x, h0, h1, mode="zero", axis=-1):
    """Analysis filterbank with pywt-ordered dec_lo/dec_hi filters: one K6
    launch on CUDA; differentiable, backward the exact transpose (K14's
    adjoint)."""
    return _AFB1D.apply(x, np.ascontiguousarray(as_taps(h0)[::-1]),
                        np.ascontiguousarray(as_taps(h1)[::-1]), mode,
                        axis % 4)


def sfb1d(lo, hi, g0, g1, mode="zero", axis=-1):
    """Synthesis filterbank with pywt-ordered rec_lo/rec_hi filters: one K7
    launch on CUDA; differentiable, backward the exact transpose (K15's
    adjoint)."""
    return _SFB1D.apply(lo, hi, as_taps(g0), as_taps(g1), mode, axis % 4)


def _afb2d_corr(x, h0c, h1c, h0r, h1r, mode):
    """One level of 2-D analysis with correlation-order taps: the row
    split (N, C, 2, H, W'), read as (N, 2C, H, W') by the column split,
    whose (N, 2C, 2, H', W') output is (N, C, 4, H', W') in the band
    order (LL, LH, HL, HH).  Two launches on CUDA."""
    N, C = x.shape[:2]
    lohi = afb1d_corr(x, h0r, h1r, mode, axis=3)          # (N,C,2,H,W')
    lohi = lohi.reshape(N, C * 2, *lohi.shape[3:])
    y = afb1d_corr(lohi, h0c, h1c, mode, axis=2)          # (N,2C,2,H',W')
    # (N, C, w∈{lo,hi}, h∈{lo,hi}, H', W') -> 4 bands (LL, LH, HL, HH)
    return y.reshape(N, C, 4, *y.shape[3:])


def afb2d(x, h0_col, h1_col, h0_row, h1_row, mode="zero"):
    """One level of 2-D analysis. Returns (N, C, 4, H', W') ordered
    (LL, LH, HL, HH) — reference band packing (dwt/lowlevel.py:343-347).
    Two K6 launches on CUDA; differentiable, backward the exact transpose
    (K14's adjoint on the separable split's plan)."""
    from pytorch_wavelets_tpu_torch.ops.nonsep import (
        SeparableAFB, outer_filters,
    )
    taps = tuple(np.ascontiguousarray(as_taps(h)[::-1])
                 for h in (h0_col, h1_col, h0_row, h1_row))
    f = outer_filters(h0_col, h1_col, h0_row, h1_row)[:, ::-1, ::-1]
    return SeparableAFB.apply(x, (taps,), np.ascontiguousarray(f), mode)


def _sfb2d_conv(ll, lh, hl, hh, g0c, g1c, g0r, g1r, mode):
    """One level of 2-D synthesis with convolution-order taps: two column
    merges, then one row merge.  Three launches on CUDA."""
    lo = sfb1d_conv(ll, lh, g0c, g1c, mode, axis=2)
    hi = sfb1d_conv(hl, hh, g0c, g1c, mode, axis=2)
    return sfb1d_conv(lo, hi, g0r, g1r, mode, axis=3)


def sfb2d(ll, lh, hl, hh, g0_col, g1_col, g0_row, g1_row, mode="zero"):
    """One level of 2-D synthesis (reference: dwt/lowlevel.py:600-644).
    Three K7 launches on CUDA; differentiable, backward the exact
    transpose (K15's adjoint with the outer products, which raises where
    'periodization' wraps a filter's tail longer than the output, as
    ``sfb2d_nonsep`` does)."""
    from pytorch_wavelets_tpu_torch.ops.nonsep import (
        SeparableSFB, outer_filters,
    )
    taps = tuple(as_taps(g) for g in (g0_col, g1_col, g0_row, g1_row))
    return SeparableSFB.apply(ll, lh, hl, hh, taps,
                              outer_filters(g0_col, g1_col, g0_row, g1_row),
                              mode)


class _AFB1DAtrous(torch.autograd.Function):
    """x (N, C, H, W) -> the (N, C, 2, H, W) à trous split along ``axis``
    (K12 ``swt_afb``); backward its exact transpose (K12
    ``swt_afb_adjoint``)."""

    @staticmethod
    def forward(ctx, x, h0, h1, mode, axis, dilation):
        ctx.args = (h0, h1, mode, axis, dilation, x.shape[axis])
        return afb1d_atrous_corr(x, h0, h1, mode, axis, dilation)

    @staticmethod
    def backward(ctx, dy):
        args = ctx.args
        dx = linear_backward(
            lambda g: afb1d_atrous_adjoint(g, *args),
            lambda u: _AFB1DAtrous.apply(u, *args[:-1]), dy)
        return dx, None, None, None, None, None


def afb1d_atrous(x, h0, h1, mode="periodic", axis=-1, dilation=1):
    """À trous analysis filterbank with pywt-ordered dec_lo/dec_hi
    filters (differentiable: backward K12's adjoint)."""
    return _AFB1DAtrous.apply(x, np.ascontiguousarray(as_taps(h0)[::-1]),
                              np.ascontiguousarray(as_taps(h1)[::-1]), mode,
                              axis % 4, dilation)


def _afb2d_atrous_corr(x, h0c, h1c, h0r, h1r, mode, dilation):
    """One level of undecimated 2-D analysis with correlation-order taps:
    the row split (N, C, 2, H, W), read as (N, 2C, H, W) by the column
    split, whose (N, 2C, 2, H, W) output is (N, C, 4, H, W) in the band
    order (LL, LH, HL, HH).  Two launches on CUDA."""
    N, C = x.shape[:2]
    lohi = afb1d_atrous_corr(x, h0r, h1r, mode, 3, dilation)
    lohi = lohi.reshape(N, C * 2, *lohi.shape[3:])
    y = afb1d_atrous_corr(lohi, h0c, h1c, mode, 2, dilation)
    return y.reshape(N, C, 4, *y.shape[3:])


class _AFB2DAtrous(torch.autograd.Function):
    """One level of the undecimated 2-D analysis: x (N, C, H, W) -> the
    (N, C, 4, H, W) stack (LL, LH, HL, HH), correlation-order taps
    (h0c, h1c, h0r, h1r) ``dilation`` samples apart.  Forward: the row
    split, then the column split (K12 ``swt_afb`` twice on CUDA).
    Backward: the exact transpose, the column adjoint then the row
    adjoint (K12 ``swt_afb_adjoint`` twice), equal to ``jax.vjp`` of the
    JAX package's level; it saves no activations."""

    @staticmethod
    def forward(ctx, x, taps, mode, dilation):
        ctx.taps, ctx.mode, ctx.dilation = taps, mode, dilation
        ctx.in_shape = tuple(x.shape)
        return _afb2d_atrous_corr(x, *taps, mode, dilation)

    @staticmethod
    def backward(ctx, dy):
        taps, mode, d = ctx.taps, ctx.mode, ctx.dilation
        h0c, h1c, h0r, h1r = taps
        N, C, H, W = ctx.in_shape

        def adjoint(g):
            g = g.reshape(N, 2 * C, 2, *g.shape[3:])
            dlohi = afb1d_atrous_adjoint(g, h0c, h1c, mode, 2, d, H)
            dlohi = dlohi.reshape(N, C, 2, *dlohi.shape[2:])
            return afb1d_atrous_adjoint(dlohi, h0r, h1r, mode, 3, d, W)
        dx = linear_backward(
            adjoint, lambda u: _AFB2DAtrous.apply(u, taps, mode, d), dy)
        return dx, None, None, None


def afb2d_atrous(x, h0_col, h1_col, h0_row, h1_row, mode="periodization",
                 dilation=1):
    """One level of undecimated 2-D analysis (SWT forward step).
    Returns (N, C, 4, H, W) ordered (LL, LH, HL, HH)
    (reference: dwt/lowlevel.py:475-521); differentiable (backward K12's
    adjoint twice)."""
    taps = tuple(np.ascontiguousarray(as_taps(h)[::-1])
                 for h in (h0_col, h1_col, h0_row, h1_row))
    return _AFB2DAtrous.apply(x, taps, mode, dilation)


def sfb1d_atrous(lo, hi, g0, g1, mode="periodic", axis=-1, dilation=1):
    """À trous synthesis filterbank with pywt-ordered rec_lo/rec_hi
    filters: the shift-averaged ISWT step (differentiable)."""
    return _SFB1DAtrous.apply(lo, hi, as_taps(g0), as_taps(g1), mode,
                              axis % 4, dilation)


def sfb2d_atrous(coeffs, g0_col, g1_col, g0_row, g1_row,
                 mode="periodization", dilation=1):
    """One level of undecimated 2-D synthesis (ISWT step); inverse of
    afb2d_atrous in 'periodization'.  ``coeffs``: (N, C, 4, H, W).  Two
    column merges (LL with LH, HL with HH), then the row merge of their
    results: three K16 launches on CUDA."""
    g0c, g1c = as_taps(g0_col), as_taps(g1_col)
    g0r, g1r = as_taps(g0_row), as_taps(g1_row)
    ll, lh, hl, hh = (coeffs[:, :, i] for i in range(4))
    lo = _SFB1DAtrous.apply(ll, lh, g0c, g1c, mode, 2, dilation)
    hi = _SFB1DAtrous.apply(hl, hh, g0c, g1c, mode, 2, dilation)
    return _SFB1DAtrous.apply(lo, hi, g0r, g1r, mode, 3, dilation)


def afb2d_nonsep(x, h0_col, h1_col, h0_row=None, h1_row=None, mode="zero"):
    """1-level 2-D analysis as one filtering with the 4 outer-product PSFs
    (K14 on CUDA; differentiable, backward K14's adjoint).  Returns
    (N, C, 4, H', W') ordered (LL, LH, HL, HH)."""
    from pytorch_wavelets_tpu_torch.ops.nonsep import NonsepAFB, outer_filters
    if h0_row is None:
        h0_row, h1_row = h0_col, h1_col
    f = outer_filters(h0_col, h1_col, h0_row, h1_row)[:, ::-1, ::-1]
    return NonsepAFB.apply(x, np.ascontiguousarray(f), mode)


def sfb2d_nonsep(coeffs, g0_col, g1_col, g0_row=None, g1_row=None,
                 mode="zero"):
    """1-level 2-D synthesis from stacked (N, C, 4, H, W) coefficients as
    one transposed filtering (K15 on CUDA; differentiable, backward K15's
    adjoint; reference: dwt/lowlevel.py:746-798)."""
    from pytorch_wavelets_tpu_torch.ops.nonsep import NonsepSFB, outer_filters
    if g0_row is None:
        g0_row, g1_row = g0_col, g1_col
    return NonsepSFB.apply(coeffs, outer_filters(g0_col, g1_col, g0_row,
                                                 g1_row), mode)
