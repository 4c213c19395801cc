"""Non-separable 2-D filterbanks: one level of 2-D analysis or synthesis
as a single 2-D filtering with a stack of point-spread functions (PSFs),
and kernels K14 and K15 (port of the ``_outer_filters`` /
``_nonsep_conv`` / ``afb2d_nonsep`` / ``sfb2d_nonsep`` block of
``pytorch_wavelets_tpu/ops/afb_sfb.py``, l.470-561, B8d).

- :func:`nonsep_afb` (K14 ``nonsep_afb``, ``csrc/nonsep_afb.cu``): the
  stride-(2, 2) correlation of every (N, C) plane with K PSFs (K = 4 for
  ``afb2d_nonsep``, 16 for the quad analysis of
  ``transforms/dtcwt_alt.py``), every boundary mode folded into the
  index of each tap; :func:`nonsep_afb_adjoint` (K14
  ``nonsep_afb_adjoint``), its exact transpose, as a gather, or with
  ``separable=True`` the transpose of the separable split of the same
  outer products (the backward of ``quad_afb2d``).
- :func:`nonsep_sfb` (K15 ``nonsep_sfb``, ``csrc/nonsep_sfb.cu``): the
  lhs-dilated transposed 2-D convolution of the 4 bands, summed, with
  the 'periodization' wrap-add and roll folded into the output index:
  K14's polyphase tiles and an edge band; :func:`nonsep_sfb_adjoint`
  (K15 ``nonsep_sfb_adjoint``), its exact transpose, a strided
  correlation by K14's staged tiles (the backward of ``sfb2d`` and
  ``sfb1d`` too).

The public ``afb2d_nonsep`` / ``sfb2d_nonsep`` are in ``ops/afb_sfb.py``,
where the JAX package has them.

CPU tensors take the plain PyTorch versions (``*_plain``): the JAX
package's code line by line (pads, strided or lhs-dilated ``conv2d``,
the wrap-add and roll), and autograd's transpose of it for the adjoints.
CUDA tensors launch the kernels or raise.  :func:`afb_axis_src`,
:func:`sfb_axis_src` and the plans give the index maps the kernels
evaluate, and :func:`afb_tile`, :func:`adjoint_tile`, :func:`sfb_tile`,
:func:`sfb_quads` and the edge tables (:func:`band_images`,
:func:`sfb_band_images`) their tiles and bands, so that the tests can
hold them against the plain versions on the CPU.  :class:`NonsepAFB`
and :class:`NonsepSFB` are the autograd Functions: forward one entry,
backward the other, and the backward's own backward the forward again
(``ops/_linear.py``), so each differentiates to any order.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_wavelets_tpu_torch.ops import _cuda
from pytorch_wavelets_tpu_torch.ops._linear import linear_backward
from pytorch_wavelets_tpu_torch.ops.afb_sfb import (
    MAX_AXIS, _afb2d_corr, _is_per, _sfb2d_conv, as_taps, sfb_plan,
)
from pytorch_wavelets_tpu_torch.ops.pad import PAD_CODES, pad1d
from pytorch_wavelets_tpu_torch.ops.precision import plain_flags
from pytorch_wavelets_tpu_torch.utils import dwt_coeff_len

__all__ = ["outer_filters", "nonsep_afb",
           "nonsep_afb_adjoint", "nonsep_sfb", "nonsep_sfb_adjoint",
           "nonsep_afb_plain", "nonsep_afb_adjoint_plain",
           "nonsep_sfb_plain", "nonsep_sfb_adjoint_plain", "afb_axis_plan",
           "afb_axis_src", "sfb_axis_src", "NonsepAFB", "NonsepSFB",
           "SeparableAFB", "SeparableSFB", "adjoint_interior", "afb_tile",
           "adjoint_tile", "band_images", "sfb_quads", "sfb_tile",
           "sfb_interior", "sfb_band_images", "MAX_PSFS", "MAX_PSF_BYTES"]

# A thread keeps the K outputs of its positions in registers (csrc/
# nonsep_tile.cuh), and a block stages the whole PSF stack in shared
# memory: at most 232,448 bytes on the H100 (4 x 76 x 76 floats, db38's,
# take 92,416)
MAX_PSFS = 16
MAX_PSF_BYTES = 232448
# K14's tiles, which K15 runs too (csrc/nonsep_tile.cuh): PY output rows
# (staged) or quads (polyphase) a thread, blocks of BX x BY threads
_PY = 4
_TILE_BX = (32, 16, 8)
_TILE_BY = (1, 2, 4, 8, 16)
# the cost of staging one sample, in FMAs of one thread (a load, a store
# and their index math)
_STAGE_COST = 8
_AFB_MODES = ("zero", "symmetric", "reflect")
_SFB_MODES = ("zero", "symmetric", "reflect", "periodic")


def outer_filters(h0_col, h1_col, h0_row, h1_row) -> np.ndarray:
    """The (4, Ly, Lx) outer products (LL, LH, HL, HH) of column and row
    filters (the JAX ``_outer_filters``)."""
    h0c, h1c = as_taps(h0_col), as_taps(h1_col)
    h0r, h1r = as_taps(h0_row), as_taps(h1_row)
    return np.stack([np.outer(h0c, h0r), np.outer(h1c, h0r),
                     np.outer(h0c, h1r), np.outer(h1c, h1r)])


# --------------------------------------------------------------------------
# The kernels' index maps
# --------------------------------------------------------------------------

def _afb_modes(separable):
    """The pad modes of ``afb2d_nonsep`` (the JAX ``_nonsep_conv``), and
    'periodic' too on the separable split's plan (K6 takes it)."""
    return _AFB_MODES + (("periodic",) if separable else ())


def afb_axis_plan(n, L, mode, separable=False):
    """Index plan of the analysis along a length-``n`` axis with L taps:
    ``(out_len, front, pad_code, per, shift)``.  Window m reads padded
    positions u = 2m .. 2m + L - 1, sample :func:`afb_axis_src`
    (u - front).  'periodization' evens an odd axis by repeating its last
    sample, then wraps (pads (L - 1 - L//2, max(L//2 - 1, 0)) on the
    evened axis, per 1); the other modes pad by ``dwt_coeff_len``'s
    calculus (``_nonsep_conv`` l.488-505), per 0.

    ``separable``: the separable split's plan instead (K6's,
    :func:`~pytorch_wavelets_tpu_torch.ops.afb_sfb.afb_plan`), which
    differs only where 'periodization' meets a filter longer than the
    evened axis: there (per 2) the evened axis is rolled by ``shift``,
    read inside one period after L - 1 zeros, and output m adds window
    m + out_len (the reference's single fold)."""
    if _is_per(mode):
        ne = n + n % 2
        if separable and L > ne:
            return ne // 2, L - 1, PAD_CODES["zero"], 2, (L // 2) % ne
        front, back = L - 1 - L // 2, max(L // 2 - 1, 0)
        return (ne + front + back - L) // 2 + 1, front, PAD_CODES[
            "periodic"], 1, 0
    if mode not in _afb_modes(separable):
        raise ValueError(f"Unknown pad type: {mode}")
    out_len = dwt_coeff_len(n, L, mode)
    p = 2 * (out_len - 1) - n + L
    if p < 0:
        raise ValueError(f"negative pad {p}")
    return out_len, p // 2, PAD_CODES[mode], 0, 0


def afb_axis_src(n, front, code, per, shift, p):
    """The sample that padded position ``p`` (numpy int array, relative
    to the first sample) reads, -1 for a zero: the kernels' ``AfbAxis``
    map."""
    p = np.asarray(p, dtype=np.int64)
    ne = n + n % 2
    if per == 1:
        return np.minimum(p % ne, n - 1)
    if per == 2:
        return np.where((p >= 0) & (p < ne),
                        np.minimum((p + shift) % ne, n - 1), -1)
    if code == 0:
        return np.where((p >= 0) & (p < n), p, -1)
    if code == 1:
        r = p % (2 * n)
        return np.where(r < n, r, 2 * n - 1 - r)
    if code == 3:
        return p % n
    if n == 1:
        return np.zeros_like(p)
    r = p % (2 * n - 2)
    return np.where(r < n, r, 2 * n - 2 - r)


def _sfb_axis_plan(nin, L, mode, separable=False):
    """:func:`~pytorch_wavelets_tpu_torch.ops.afb_sfb.sfb_plan` (K7's
    plan: K15 merges each axis as K7 does) for the modes
    :func:`sfb2d_nonsep` takes, which raises where the filter's tail is
    longer than the output (its wrap-add slices fail); ``separable``
    (the separable merge, ``sfb2d``) folds such a tail once and cuts the
    rest, as K7 does."""
    if not (_is_per(mode) or mode in _SFB_MODES):
        raise ValueError(f"Unknown pad type: {mode}")
    if _is_per(mode) and L - 2 > 2 * nin and not separable:
        raise ValueError(f"sfb2d_nonsep: a filter of {L} taps is longer "
                         f"than the {2 * nin} samples it wraps onto")
    return sfb_plan(nin, L, mode)


def sfb_axis_src(plan, per, u):
    """The output sample that position ``u`` of the full transposed
    convolution lands on, -1 where it is cropped: the inverse of K7's
    plan, the kernels' ``SfbAxis`` map."""
    out_len, s, wrap, r0, fold = plan
    u = np.asarray(u, dtype=np.int64)
    if not per:
        v = u - s
        return np.where((v >= 0) & (v < out_len), v, -1)
    t = np.where(u < wrap, u, u - wrap)
    ok = (u < wrap) | ((t < fold) & (t < wrap))
    return np.where(ok, (t - r0) % wrap, -1)


def adjoint_interior(n, L, mode, separable=False):
    """The pixels ``[lo, hi)`` of a length-``n`` axis whose only image
    is their direct padded position (no pad position reads them): all of
    them in 'zero' mode, ``[edge, n - edge)`` in the others, where edge
    passes the longer pad; None on the separable split's single fold
    (per 2), where no pixel has a direct position.  K14's adjoint
    computes the direct positions' sums by its polyphase tiles and the
    other images of the pixels outside this range (:func:`band_images`)
    by the gather."""
    out, front, code, per, _ = afb_axis_plan(n, L, mode, separable)
    if per == 2:
        return None
    if per == 0 and code == PAD_CODES["zero"]:
        return 0, n
    umax = 2 * (out - 1) + L - 1
    edge = max(front, umax - front - n + 1, 0) + 1
    return (edge, n - edge) if 2 * edge < n else (0, 0)


@lru_cache(maxsize=256)
def band_images(n, L, mode, separable=False):
    """The images along a length-``n`` axis of the pixels outside
    :func:`adjoint_interior` (all of them on a per-2 axis): an int32
    array with a row for each such t in order (t, then ``lo + t - hi``
    past the interior), the positions u in [0, umax] whose sample
    :func:`afb_axis_src` is t, ascending, -1 past the last; None if every
    pixel is interior.  K14's adjoint band reads it instead of scanning
    the pads on the card."""
    out, front, code, per, shift = afb_axis_plan(n, L, mode, separable)
    lo, hi = adjoint_interior(n, L, mode, separable) or (0, 0)
    band = np.r_[0:lo, hi:n]
    if not len(band):
        return None
    umax = 2 * ((2 * out if per == 2 else out) - 1) + L - 1
    u = np.arange(umax + 1)
    src = afb_axis_src(n, front, code, per, shift, u - front)
    lists = [u[src == t] for t in band]
    table = np.full((len(band), max(map(len, lists))), -1, dtype=np.int32)
    for row, us in zip(table, lists):
        row[:len(us)] = us
    return table


@lru_cache(maxsize=64)
def _device_table(n, L, mode, separable, device):
    t = band_images(n, L, mode, separable)
    return None if t is None else torch.as_tensor(t, device=device)


def _kmax(K):
    """The PSFs K14's register arrays hold: 4 or 16 (K padded with
    zeros)."""
    return 4 if K <= 4 else 16


def _fwd_pitch(cols, bx):
    p = (cols + 1) // 2
    return p + (bx // 2 - p) % 16 if bx < 32 else p


def _fwd_window(Ly, Lx, bx, by):
    return 2 * _PY * by + Ly - 2, 2 * bx + Lx - 2


def _fwd_smem(kmax, Ly, Lx, bx, by):
    rows, cols = _fwd_window(Ly, Lx, bx, by)
    return 4 * (Ly * Lx * kmax + rows + cols
                + 2 * rows * _fwd_pitch(cols, bx))


def _adj_window(Ly, Lx, bx, by):
    return _PY * by + (Ly + 1) // 2 - 1, bx + (Lx + 1) // 2 - 1


def _adj_smem(kmax, Ly, Lx, bx, by):
    rows, cols = _adj_window(Ly, Lx, bx, by)
    return 4 * (Ly * Lx * kmax + kmax * rows * cols)


def _pick_tile(kernel, nx, ny, fmas, taps, samples, smem):
    """The block (BX, BY) of K14's tile kernels over an ny x nx grid of
    thread items (positions, or quads), PY rows of them a thread: the
    least FMAs (``fmas`` an item) plus staged samples (``samples(bx,
    by)`` and the ``taps`` a tile) over the tiles that cover the grid,
    among the blocks of 32 to 256 threads whose shared memory fits; ties
    to more threads, then wider blocks."""
    best = None
    for bx in _TILE_BX:
        for by in _TILE_BY:
            if not 32 <= bx * by <= 256 or smem(bx, by) > MAX_PSF_BYTES:
                continue
            tiles = -(-nx // bx) * -(-ny // (_PY * by))
            cost = tiles * (bx * _PY * by * fmas
                            + _STAGE_COST * (samples(bx, by) + taps))
            key = (cost, -bx * by, -bx)
            if best is None or key < best[0]:
                best = (key, (bx, by))
    if best is None:
        raise ValueError(f"{kernel}: the PSF stack and the smallest tile "
                         f"do not fit the {MAX_PSF_BYTES} bytes of shared "
                         f"memory a block has")
    return best[1]


def afb_tile(K, Ly, Lx, Ho, Wo):
    """K14's forward block (BX, BY) for (Ho, Wo) output positions: a tile
    of (PY BY) x BX positions (``csrc/nonsep_afb.cu:afb_tile_kernel``)."""
    kmax = _kmax(K)
    return _pick_tile(
        "nonsep_afb", Wo, Ho, Ly * Lx * kmax, Ly * Lx * kmax,
        lambda bx, by: np.prod(_fwd_window(Ly, Lx, bx, by)),
        lambda bx, by: _fwd_smem(kmax, Ly, Lx, bx, by))


def _quad_tile(kernel, K, Ly, Lx, nU, nV):
    """The polyphase tile's block (BX, BY) over nU x nV quads
    (``csrc/nonsep_tile.cuh:afb_adjoint_tile_kernel``)."""
    kmax = _kmax(K)
    return _pick_tile(
        kernel, nV, nU,
        4 * ((Ly + 1) // 2) * ((Lx + 1) // 2) * kmax, Ly * Lx * kmax,
        lambda bx, by: kmax * np.prod(_adj_window(Ly, Lx, bx, by)),
        lambda bx, by: _adj_smem(kmax, Ly, Lx, bx, by))


def adjoint_tile(K, Ly, Lx, H, W, fy, fx):
    """K14's polyphase adjoint block (BX, BY) for an (H, W) input whose
    pixels sit at padded positions (i + fy, j + fx): a tile of (PY BY) x
    BX quads of 2 x 2 pixels (``afb_adjoint_tile_kernel``)."""
    nU = (H - 1 + fy) // 2 - fy // 2 + 1
    nV = (W - 1 + fx) // 2 - fx // 2 + 1
    return _quad_tile("nonsep_afb_adjoint", K, Ly, Lx, nU, nV)


def sfb_quads(nin, L, mode):
    """The positions of the full transposed convolution along one axis
    that K15's forward tiles compute, as ``(f, U0, nU, rot)``: quads U0
    .. U0 + nU - 1 (positions u = 2U, 2U + 1), pixel u - f.  Outside
    'periodization' positions [s, s + out) (f = s); in it every position
    of [0, 2 nin) (f = r0, the pixel wrapped once into [0, 2 nin): rot)."""
    out, s, wrap, r0, _ = _sfb_axis_plan(nin, L, mode)
    if wrap:
        return r0, 0, nin, True
    return s, s // 2, (out - 1 + s) // 2 - s // 2 + 1, False


def sfb_tile(Ly, Lx, nU, nV):
    """K15's forward block (BX, BY) over nU x nV quads (:func:`sfb_quads`):
    K14's polyphase tile with the 4 bands as its planes."""
    return _quad_tile("nonsep_sfb", 4, Ly, Lx, nU, nV)


def _sfb_images(nin, L, mode):
    """Each output pixel's positions of the full transposed convolution
    along one axis, the direct one first (K7's plan inverted: t + s, or
    in 'periodization' t = (n + r0) mod wrap and t + wrap where t <
    fold)."""
    out, s, wrap, r0, fold = _sfb_axis_plan(nin, L, mode)
    if not wrap:
        return [[n + s] for n in range(out)]
    ts = (np.arange(out) + r0) % wrap
    return [[t] + ([t + wrap] if t < fold else []) for t in map(int, ts)]


def sfb_interior(nin, L, mode):
    """The pixels ``[lo, hi)`` of an output axis whose only position is
    their direct one: all of them outside 'periodization', else those
    whose t is past the wrap-add's fold; the others (at both ends, the
    roll splitting the fold's run) form K15's forward band."""
    imgs = _sfb_images(nin, L, mode)
    one = [len(u) == 1 for u in imgs]
    lo = one.index(True) if any(one) else len(one)
    hi = lo + (one[lo:] + [False]).index(False)
    assert all(one[lo:hi]) and not any(one[:lo] + one[hi:]), one
    return lo, hi


@lru_cache(maxsize=256)
def sfb_band_images(nin, L, mode):
    """The positions along an output axis of the pixels outside
    :func:`sfb_interior`: an int32 array with a row for each such pixel in
    order (t, then ``lo + t - hi`` past the interior), the direct
    position first, then the wrap-add's, -1 past the last; None if every
    pixel is interior.  K15's forward band reads it."""
    lo, hi = sfb_interior(nin, L, mode)
    imgs = _sfb_images(nin, L, mode)
    band = [imgs[t] for t in (*range(lo), *range(hi, len(imgs)))]
    if not band:
        return None
    table = np.full((len(band), max(map(len, band))), -1, dtype=np.int32)
    for row, us in zip(table, band):
        row[:len(us)] = us
    return table


@lru_cache(maxsize=64)
def _device_sfb_table(nin, L, mode, device):
    t = sfb_band_images(nin, L, mode)
    return None if t is None else torch.as_tensor(t, device=device)


# --------------------------------------------------------------------------
# Plain versions (the JAX code)
# --------------------------------------------------------------------------

def _f_tensor(f, x, flip=False):
    f = np.asarray(f, dtype=np.float64)
    if flip:
        f = f[:, ::-1, ::-1]
    return torch.as_tensor(np.ascontiguousarray(f), dtype=x.dtype,
                           device=x.device)


def nonsep_afb_plain(x, f, mode, separable=False):
    """Plain PyTorch version of :func:`nonsep_afb` (the JAX package's
    ``_nonsep_conv``): pad each axis, then one stride-(2, 2) ``conv2d``
    with the K PSFs as output channels.  ``separable``: the map whose
    transpose ``nonsep_afb_adjoint(separable=True)`` is, the separable
    split's (``_afb1d_corr_conv`` l.145-158 on each axis: in
    'periodization' with a filter longer than the evened axis, a roll, a
    zero pad and a single fold)."""
    N, C, H, W = x.shape
    K, Ly, Lx = np.shape(f)
    folds = []
    if _is_per(mode):
        xp = x
        for axis, L in ((2, Ly), (3, Lx)):
            n = xp.shape[axis]
            if n % 2:
                xp = torch.cat([xp, xp.narrow(axis, n - 1, 1)], dim=axis)
                n += 1
            if separable and L > n:
                xp = pad1d(torch.roll(xp, -(L // 2), dims=axis), L - 1,
                           L - 1, axis, "zero")
                folds.append((axis + 1, n // 2))
            else:
                xp = pad1d(xp, L - 1 - L // 2, max(L // 2 - 1, 0), axis,
                           "periodic")
    elif mode in _afb_modes(separable):
        out1 = dwt_coeff_len(H, Ly, mode)
        out2 = dwt_coeff_len(W, Lx, mode)
        p1 = 2 * (out1 - 1) - H + Ly
        p2 = 2 * (out2 - 1) - W + Lx
        xp = pad1d(x, p1 // 2, p1 - p1 // 2, 2, mode)
        xp = pad1d(xp, p2 // 2, p2 - p2 // 2, 3, mode)
    else:
        raise ValueError(f"Unknown pad type: {mode}")
    xr = xp.reshape(N * C, 1, *xp.shape[2:])
    with plain_flags():
        y = F.conv2d(xr, _f_tensor(f, x)[:, None], stride=2)
    y = y.reshape(N, C, K, *y.shape[2:])
    for axis, m in folds:
        y = y.narrow(axis, 0, m) + y.narrow(axis, m, m)
    return y


def nonsep_sfb_plain(coeffs, f, mode, separable=False):
    """Plain PyTorch version of :func:`nonsep_sfb` (the JAX package's
    ``sfb2d_nonsep`` after its filters): the (N, C, 4, Ny, Nx) bands
    dilated by 2, padded, correlated with the doubly reversed filters as
    4 input channels of one ``conv2d``; in 'periodization' the tail
    wrap-added onto the head and the result rolled by 1 - L//2.
    ``separable``: a tail longer than the output is folded once and cut
    (K7's ``_sfb1d_conv_conv`` l.271-291) instead of raising."""
    N, C = coeffs.shape[:2]
    Ny, Nx = coeffs.shape[-2:]
    Ly, Lx = np.shape(f)[1:]
    if _is_per(mode):
        py, px = Ly - 1, Lx - 1
    elif mode in _SFB_MODES:
        py = px = 1
    else:
        raise ValueError(f"Unknown pad type: {mode}")
    xr = coeffs.reshape(N * C, 4, Ny, Nx)
    up = xr.new_zeros((N * C, 4, 2 * Ny - 1, 2 * Nx - 1))
    up[:, :, ::2, ::2] = xr
    up = F.pad(up, (px, px, py, py))
    with plain_flags():
        y = F.conv2d(up, _f_tensor(f, coeffs, flip=True)[None])
    y = y.reshape(N, C, *y.shape[2:])
    if _is_per(mode):
        for axis, L, Nn in ((2, Ly, Ny), (3, Lx, Nx)):
            if L - 2 > 2 * Nn:
                if not separable:
                    raise ValueError(f"sfb2d_nonsep: a filter of {L} taps "
                                     f"is longer than the {2 * Nn} samples "
                                     f"it wraps onto")
                y = (y.narrow(axis, 0, 2 * Nn)
                     + y.narrow(axis, 2 * Nn, 2 * Nn))
            elif L > 2:
                head = y.narrow(axis, 0, L - 2)
                tail = y.narrow(axis, 2 * Nn, L - 2)
                body = y.narrow(axis, L - 2, 2 * Nn - L + 2)
                y = torch.cat([head + tail, body], dim=axis)
            else:
                y = y.narrow(axis, 0, 2 * Nn)
            y = torch.roll(y, 1 - L // 2, dims=axis)
    return y


def _transpose_of(fn, dy, shape):
    """Autograd's transpose of the linear map ``fn`` on an input of
    ``shape``, applied to the cotangent ``dy``."""
    x = dy.new_zeros(shape, requires_grad=True)
    # the transposed convolution runs under the plain versions' TF32 flags
    # too (cuDNN's allow_tf32 is read when the backward is dispatched)
    with torch.enable_grad(), plain_flags():
        return torch.autograd.grad(fn(x), x, dy.detach())[0]


def nonsep_afb_adjoint_plain(dy, f, mode, H, W, separable=False):
    """Plain PyTorch version of :func:`nonsep_afb_adjoint`: autograd's
    transpose of :func:`nonsep_afb_plain` on an (N, C, H, W) input."""
    return _transpose_of(lambda x: nonsep_afb_plain(x, f, mode, separable),
                         dy, (dy.shape[0], dy.shape[1], H, W))


def nonsep_sfb_adjoint_plain(dy, f, mode, Ny, Nx, separable=False):
    """Plain PyTorch version of :func:`nonsep_sfb_adjoint`: autograd's
    transpose of :func:`nonsep_sfb_plain` on (N, C, 4, Ny, Nx) bands."""
    return _transpose_of(lambda c: nonsep_sfb_plain(c, f, mode, separable),
                         dy, (dy.shape[0], dy.shape[1], 4, Ny, Nx))


# --------------------------------------------------------------------------
# The kernel wrappers
# --------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _device_taps(data: bytes, shape: tuple, device: torch.device):
    """The PSF stack as the kernels read it, (Ly, Lx, K) float32 on the
    card, built once per stack and device."""
    f = np.frombuffer(data, dtype=np.float64).reshape(shape)
    return torch.as_tensor(np.ascontiguousarray(
        np.transpose(f, (1, 2, 0)), dtype=np.float32), device=device)


def _psf_stack(kernel, f, t, K=None):
    f = np.ascontiguousarray(f, dtype=np.float64)
    if f.ndim != 3 or (K is not None and f.shape[0] != K) or not (
            0 < f.shape[0] <= MAX_PSFS) or min(f.shape) < 1:
        raise ValueError(f"{kernel}: expected a (K, Ly, Lx) stack of K in "
                         f"1..{MAX_PSFS} PSFs, got {f.shape}")
    if 4 * f.size > MAX_PSF_BYTES:
        raise ValueError(f"{kernel}: a {f.shape} PSF stack takes "
                         f"{4 * f.size} bytes of shared memory, more than "
                         f"the {MAX_PSF_BYTES} a block has")
    return f.shape, _device_taps(f.tobytes(), f.shape, t.device)


def _check_planes(kernel, *tensors):
    for t in tensors:
        if max(t.shape[-2:]) >= MAX_AXIS:
            raise ValueError(f"{kernel}: H and W must be below 2^30, got "
                             f"{tuple(t.shape)}")


@_cuda.via_fp32
def nonsep_afb(x, f, mode):
    """Stride-(2, 2) correlation of every (N, C) plane of ``x`` with the
    (K, Ly, Lx) PSF stack ``f`` (correlation order) after the pads of
    ``mode``: (N, C, K, H', W').

    CPU tensors take :func:`nonsep_afb_plain`; CUDA tensors launch K14's
    ``nonsep_afb``, which stages each tile's input window (the pads
    applied there) in shared memory and reads ``x`` through its strides,
    a thread computing PY positions x K PSFs; the instantiation (``k4`` /
    ``k16`` and the tile of :func:`afb_tile`) is counted in
    ``instantiations``."""
    if x.device.type == "cpu":
        return nonsep_afb_plain(x, f, mode)
    _cuda.check_inputs("nonsep_afb", x)
    if x.ndim != 4:
        raise ValueError(f"nonsep_afb: expected an (N, C, H, W) tensor, "
                         f"got {tuple(x.shape)}")
    _check_planes("nonsep_afb", x)
    (K, Ly, Lx), taps = _psf_stack("nonsep_afb", f, x)
    N, C, H, W = x.shape
    Ho, fy, code, per, _ = afb_axis_plan(H, Ly, mode)
    Wo, fx = afb_axis_plan(W, Lx, mode)[:2]
    bx, by = afb_tile(K, Ly, Lx, Ho, Wo)
    y = torch.empty((N, C, K, Ho, Wo), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    lib = _cuda.library("nonsep_afb")
    _cuda.check(lib, "nonsep_afb", lib.nonsep_afb(
        x.data_ptr(), y.data_ptr(), taps.data_ptr(), K, Ly, Lx, N, C, H, W,
        *x.stride(), Ho, Wo, fy, fx, code, int(per), bx, by, *y.stride(),
        _cuda.stream_of(x)))
    _K14.launches += 1
    _count(_K14, f"k{_kmax(K)} {bx}x{_PY * by}")
    return y


@_cuda.via_fp32
def nonsep_afb_adjoint(dy, f, mode, H, W, separable=False):
    """The transpose of :func:`nonsep_afb` on an (N, C, H, W) input: the
    (N, C, K, H', W') cotangent ``dy`` -> (N, C, H, W).  ``separable``:
    the transpose of the separable split of each axis instead (see
    :func:`afb_axis_plan`), which for a stack of outer products is the
    backward of the separable 2-D analysis in every mode.

    CPU tensors take :func:`nonsep_afb_adjoint_plain`; CUDA tensors launch
    K14's ``nonsep_afb_adjoint`` (no atomics): polyphase tiles write each
    pixel's direct-position sum, 2 x 2 pixels a quad from one staged
    window of the cotangent, then a gather adds, for the pixels outside
    :func:`adjoint_interior`, their padded images (and periodization's
    repeated last sample); where an axis takes the separable split's
    single fold, the gather computes every pixel (each cotangent row read
    for two windows).  Counted in ``instantiations``: ``poly k4`` /
    ``poly k16`` with the tile of :func:`adjoint_tile` in pixels,
    ``band`` (the gather adding the band's images) or ``gather`` (the
    whole plane)."""
    if dy.device.type == "cpu":
        return nonsep_afb_adjoint_plain(dy, f, mode, H, W, separable)
    _cuda.check_inputs("nonsep_afb_adjoint", dy)
    (K, Ly, Lx), taps = _psf_stack("nonsep_afb_adjoint", f, dy)
    Ho, fy, code, py, shy = afb_axis_plan(H, Ly, mode, separable)
    Wo, fx, _, px, shx = afb_axis_plan(W, Lx, mode, separable)
    if dy.ndim != 5 or tuple(dy.shape[2:]) != (K, Ho, Wo):
        raise ValueError(f"nonsep_afb_adjoint: expected an (N, C, {K}, "
                         f"{Ho}, {Wo}) cotangent, got {tuple(dy.shape)}")
    N, C = dy.shape[:2]
    dx = torch.empty((N, C, H, W), device=dy.device, dtype=torch.float32)
    _check_planes("nonsep_afb_adjoint", dx)
    if dx.numel() == 0:
        return dx
    iy = adjoint_interior(H, Ly, mode, separable)
    ix = adjoint_interior(W, Lx, mode, separable)
    poly = iy is not None and ix is not None
    bx, by = adjoint_tile(K, Ly, Lx, H, W, fy, fx) if poly else (0, 0)
    rect = (*(iy or (0, 0)), *(ix or (0, 0)))
    tabs = []
    for n, L in ((H, Ly), (W, Lx)):
        t = _device_table(n, L, mode, separable, dy.device)
        tabs += [0, 0] if t is None else [t.data_ptr(), t.shape[1]]
    lib = _cuda.library("nonsep_afb")
    _cuda.check(lib, "nonsep_afb_adjoint", lib.nonsep_afb_adjoint(
        dy.data_ptr(), dx.data_ptr(), taps.data_ptr(), K, Ly, Lx, N, C, Ho,
        Wo, *dy.stride(), H, W, fy, fx, code, py, px, shy, shx, *rect,
        *tabs, bx, by, *dx.stride(), _cuda.stream_of(dy)))
    _K14A.launches += 1
    if not poly:
        _count(_K14A, "gather")
        return dx
    _count(_K14A, f"poly k{_kmax(K)} {2 * bx}x{2 * _PY * by}")
    if (rect[1] - rect[0]) * (rect[3] - rect[2]) < H * W:
        _count(_K14A, "band")
    return dx


def _sfb_args(kernel, f, Ny, Nx, mode, t, separable=False):
    (_, Ly, Lx), taps = _psf_stack(kernel, f, t, K=4)
    py = _sfb_axis_plan(Ny, Ly, mode, separable)
    px = _sfb_axis_plan(Nx, Lx, mode, separable)
    return Ly, Lx, taps, py, px


@_cuda.via_fp32
def nonsep_sfb(coeffs, f, mode):
    """The 4-band synthesis of (N, C, 4, Ny, Nx) ``coeffs`` with the
    (4, Ly, Lx) filters ``f`` (convolution order): (N, C, H, W).

    CPU tensors take :func:`nonsep_sfb_plain`; CUDA tensors launch K15's
    ``nonsep_sfb`` (no atomics): K14's polyphase tiles over the bands
    write each pixel's direct position of the full transposed
    convolution (:func:`sfb_quads`; the 'periodization' roll wrapped at
    the store), then, in 'periodization', a gather adds the wrap-add's
    second positions of the pixels outside :func:`sfb_interior`, from
    :func:`sfb_band_images`.  Counted in ``instantiations``: ``poly`` with
    the tile of :func:`sfb_tile` in positions, and ``band``."""
    if coeffs.device.type == "cpu":
        return nonsep_sfb_plain(coeffs, f, mode)
    _cuda.check_inputs("nonsep_sfb", coeffs)
    if coeffs.ndim != 5 or coeffs.shape[2] != 4:
        raise ValueError(f"nonsep_sfb: expected (N, C, 4, H, W) bands, got "
                         f"{tuple(coeffs.shape)}")
    _check_planes("nonsep_sfb", coeffs)
    N, C, _, Ny, Nx = coeffs.shape
    Ly, Lx, taps, py, px = _sfb_args("nonsep_sfb", f, Ny, Nx, mode, coeffs)
    y = torch.empty((N, C, py[0], px[0]), device=coeffs.device,
                    dtype=torch.float32)
    if y.numel() == 0:
        return y
    nU, nV = sfb_quads(Ny, Ly, mode)[2], sfb_quads(Nx, Lx, mode)[2]
    bx, by = sfb_tile(Ly, Lx, nU, nV)
    band = []
    for n, L in ((Ny, Ly), (Nx, Lx)):
        t = _device_sfb_table(n, L, mode, coeffs.device)
        band += [*sfb_interior(n, L, mode),
                 *((0, 0) if t is None else (t.data_ptr(), t.shape[1]))]
    lib = _cuda.library("nonsep_sfb")
    _cuda.check(lib, "nonsep_sfb", lib.nonsep_sfb(
        coeffs.data_ptr(), y.data_ptr(), taps.data_ptr(), Ly, Lx, N, C, Ny,
        Nx, *coeffs.stride(), *py, *px, int(_is_per(mode)), *y.stride(),
        bx, by, *band, _cuda.stream_of(coeffs)))
    _K15.launches += 1
    _count(_K15, f"poly {2 * bx}x{2 * _PY * by}")
    if band[2] or band[6]:
        _count(_K15, "band")
    return y


@_cuda.via_fp32
def nonsep_sfb_adjoint(dy, f, mode, Ny, Nx, separable=False):
    """The transpose of :func:`nonsep_sfb` on (N, C, 4, Ny, Nx) bands: the
    (N, C, H, W) cotangent ``dy`` -> (N, C, 4, Ny, Nx).  ``separable``:
    that of the separable merge (``sfb2d``) where it differs, a
    'periodization' tail longer than the output (see
    :func:`_sfb_axis_plan`).

    CPU tensors take :func:`nonsep_sfb_adjoint_plain`; CUDA tensors launch
    K15's ``nonsep_sfb_adjoint``, the stride-(2, 2) correlation of ``dy``
    read through the inverse of the output index map: K14's staged
    forward tiles (:func:`afb_tile`), each tile's window of ``dy`` staged
    through :func:`sfb_axis_src`, all 4 bands from one read of it.
    Counted in ``instantiations`` as ``staged`` with the tile in
    positions."""
    if dy.device.type == "cpu":
        return nonsep_sfb_adjoint_plain(dy, f, mode, Ny, Nx, separable)
    _cuda.check_inputs("nonsep_sfb_adjoint", dy)
    Ly, Lx, taps, py, px = _sfb_args("nonsep_sfb_adjoint", f, Ny, Nx, mode,
                                     dy, separable)
    if dy.ndim != 4 or tuple(dy.shape[2:]) != (py[0], px[0]):
        raise ValueError(f"nonsep_sfb_adjoint: expected an (N, C, {py[0]}, "
                         f"{px[0]}) cotangent, got {tuple(dy.shape)}")
    _check_planes("nonsep_sfb_adjoint", dy)
    N, C = dy.shape[:2]
    dc = torch.empty((N, C, 4, Ny, Nx), device=dy.device,
                     dtype=torch.float32)
    if dc.numel() == 0:
        return dc
    bx, by = afb_tile(4, Ly, Lx, Ny, Nx)
    lib = _cuda.library("nonsep_sfb")
    _cuda.check(lib, "nonsep_sfb_adjoint", lib.nonsep_sfb_adjoint(
        dy.data_ptr(), dc.data_ptr(), taps.data_ptr(), Ly, Lx, N, C,
        *dy.shape[2:], *dy.stride(), Ny, Nx, *py, *px, int(_is_per(mode)),
        *dc.stride(), bx, by, _cuda.stream_of(dy)))
    _K15A.launches += 1
    _count(_K15A, f"staged {bx}x{_PY * by}")
    return dc


def _count(wrapper, inst):
    wrapper.instantiations[inst] = wrapper.instantiations.get(inst, 0) + 1


# The launch counters live on the wrappers, reached through these names
# (see ops/afb_sfb.py's _K6 / _K7); they also count their launches by
# instantiation (a key the first time it runs)
_K14, _K14A, _K15, _K15A = (nonsep_afb, nonsep_afb_adjoint, nonsep_sfb,
                            nonsep_sfb_adjoint)
for _k in (_K14, _K14A, _K15, _K15A):
    _k.launches = 0
    _k.instantiations = {}


# --------------------------------------------------------------------------
# Autograd Functions and the public filterbanks
# --------------------------------------------------------------------------

class NonsepAFB(torch.autograd.Function):
    """x (N, C, H, W) -> (N, C, K, H', W') by :func:`nonsep_afb`; backward
    :func:`nonsep_afb_adjoint`, the exact transpose (what ``jax.vjp`` of
    the JAX ``_nonsep_conv`` gives).  Saves no activations."""

    @staticmethod
    def forward(ctx, x, f, mode):
        ctx.f, ctx.mode, ctx.in_shape = f, mode, tuple(x.shape[-2:])
        return nonsep_afb(x, f, mode)

    @staticmethod
    def backward(ctx, dy):
        f, mode, (H, W) = ctx.f, ctx.mode, ctx.in_shape
        dx = linear_backward(
            lambda g: nonsep_afb_adjoint(g, f, mode, H, W),
            lambda u: NonsepAFB.apply(u, f, mode), dy)
        return dx, None, None


class SeparableAFB(torch.autograd.Function):
    """x (N, C, H, W) -> the (N, C, 4T, H', W') stack of T separable 2-D
    splits (``_afb2d_corr`` with the correlation-order taps (h0c, h1c,
    h0r, h1r) of each of ``trees``: two K6 launches a tree on CUDA).
    Backward: :func:`nonsep_afb_adjoint` with ``f``, the (4T, Ly, Lx)
    outer products of those taps, on the separable split's plan: the
    exact transpose in every mode (what ``jax.vjp`` of the JAX ``afb2d``
    and ``quad_afb2d`` gives), one K14 launch."""

    @staticmethod
    def forward(ctx, x, trees, f, mode):
        ctx.trees, ctx.f, ctx.mode = trees, f, mode
        ctx.in_shape = tuple(x.shape[-2:])
        ys = [_afb2d_corr(x, *taps, mode) for taps in trees]
        return ys[0] if len(ys) == 1 else torch.cat(ys, dim=2)

    @staticmethod
    def backward(ctx, dy):
        trees, f, mode, (H, W) = ctx.trees, ctx.f, ctx.mode, ctx.in_shape
        # positional separable=True: the launch recorders pass no keywords
        dx = linear_backward(
            lambda g: nonsep_afb_adjoint(g, f, mode, H, W, True),
            lambda u: SeparableAFB.apply(u, trees, f, mode), dy)
        return dx, None, None, None


class SeparableSFB(torch.autograd.Function):
    """(ll, lh, hl, hh), each (N, C, Ny, Nx) -> (N, C, H, W): the
    separable 2-D merge (``_sfb2d_conv`` with the convolution-order taps
    (g0c, g1c, g0r, g1r): three K7 launches on CUDA).  Backward:
    :func:`nonsep_sfb_adjoint` with ``f``, the 4 outer products of the
    taps, on the separable plan (K15's plan is K7's on each axis): the
    exact transpose (what ``jax.vjp`` of the JAX ``sfb2d`` gives), one
    K15 launch."""

    @staticmethod
    def forward(ctx, ll, lh, hl, hh, taps, f, mode):
        ctx.taps, ctx.f, ctx.mode = taps, f, mode
        ctx.in_shape = tuple(ll.shape[-2:])
        return _sfb2d_conv(ll, lh, hl, hh, *taps, mode)

    @staticmethod
    def backward(ctx, dy):
        taps, f, mode, (Ny, Nx) = ctx.taps, ctx.f, ctx.mode, ctx.in_shape

        def adjoint(g):
            # positional separable=True: the launch recorders pass no
            # keywords
            dc = nonsep_sfb_adjoint(g, f, mode, Ny, Nx, True)
            return tuple(dc[:, :, i] for i in range(4))
        dcs = linear_backward(
            adjoint, lambda *us: SeparableSFB.apply(*us, taps, f, mode), dy)
        return (*dcs, None, None, None)


class NonsepSFB(torch.autograd.Function):
    """(N, C, 4, Ny, Nx) bands -> (N, C, H, W) by :func:`nonsep_sfb`;
    backward :func:`nonsep_sfb_adjoint`, the exact transpose."""

    @staticmethod
    def forward(ctx, coeffs, f, mode):
        ctx.f, ctx.mode, ctx.in_shape = f, mode, tuple(coeffs.shape[-2:])
        return nonsep_sfb(coeffs, f, mode)

    @staticmethod
    def backward(ctx, dy):
        f, mode, (Ny, Nx) = ctx.f, ctx.mode, ctx.in_shape
        dc = linear_backward(
            lambda g: nonsep_sfb_adjoint(g, f, mode, Ny, Nx),
            lambda u: NonsepSFB.apply(u, f, mode), dy)
        return dc, None, None
